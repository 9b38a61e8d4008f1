"""The bf16_fp32acc tensor-core routes of repro_torch, modelled on the CPU:
numpy models of the arithmetic of kernel 1's bf16 route
(``csrc/kron_walk.cuh``, bf16 ``mma.sync`` m16n8k16, ``launch_route``
``"bf16_mma"``), of kernel 5's (``csrc/kron_scatter_ttm.cu``: that walk,
then rounds U^T Y on 2xTF32) and of the chain kernel's
(``csrc/kron_chain_scatter.cu``, ``"2xtf32"``), each held against the
reference's Pallas kernels in interpret mode under
``precision="bf16_fp32acc"`` (``fused_kron_scatter_pallas``;
``fused_kron_scatter_ttm_pallas``; ``kron_contrib_pallas`` chained into
``scatter_rows_pallas``) and against the port's plain version.

The card gives up one rounding of the reference on purpose: the bf16
rounding of each product a*b (of f_1 f_2 on the chain) before the f32
scale, up to 2^-8 of a term. The models form the kernels' terms: kernel 1
a (bf16) times v*b split into a bf16 high part and a bf16 remainder (a*b*v
to ~2^-16); the chain f_1 (bf16) times v (f_2 (x) ...) formed in f32 and
split into two TF32 parts, the remainder truncated to TF32 as the tensor
core reads it (~2^-21). They sum as the kernels do: slots in schedule
order, each range's slots in blocks of 16 (kernel 1) or 8 (the chain) from
the range's first slot, a block's products of one row summed (the
remainder's, then the high part's added) and rounded to f32, then added to
the row's f32 sum; on the chain the rows are cut at its equal-length
ranges and their partial sums added in range order. Kernel 5 contracts
kernel 1's rows in its rounds (``test_torch_f64.kernel5_rounds``): U (bf16,
exact in TF32) times Y split into two TF32 parts, the remainder's products
summed and rounded to f32, the high part's added, then added to the CTA's
f32 partial; the partials summed in CTA order.

Tolerances:
  * against the plain version and against the reference: 2e-2 x
    max|plain| (``chip_smoke.py``'s ``TOL["bf16_fp32acc"]``, the limit the
    card's kernels are held to);
  * against the exact sum of the same bf16-operand terms (f64): each model
    is no further than the plain version is, plus 2^-14 x max|exact| for
    its own f32 sums (the card's sum is the nearer one).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.coo import SparseCOO as JCOO
from repro.kernels import ops as jops
from repro.kernels.kron_kernel import fused_kron_scatter_pallas, fused_kron_scatter_ttm_pallas
from repro.sparse.layout import build_mode_layout as jbuild
from repro_torch.core.coo import SparseCOO
from repro_torch.kernels import kron_kernel
from repro_torch.sparse.layout import (DeviceSchedule, build_mode_layout, operand_modes,
                                       slot_rows)
from test_torch_f64 import kernel5_rounds, reduce_in_cta_order

TOL = 2e-2  # x max|plain|
SUM_SLACK = 2.0 ** -14  # x max|exact|: the models' f32 sums


def _bf16(x) -> np.ndarray:
    """``x`` rounded to bf16 (to nearest, ties to even), as f32."""
    t = torch.from_numpy(np.ascontiguousarray(x, dtype=np.float32))
    return t.to(torch.bfloat16).float().numpy()


def _tf32_split(x: np.ndarray):
    """tc_common.cuh's split of f32 ``x``: hi rounded to TF32 (half away
    from zero), the exact rest, then truncated to TF32 as the tensor core
    reads it."""
    x = np.ascontiguousarray(x, dtype=np.float32)
    hi = ((x.view(np.uint32) + np.uint32(0x1000)) & np.uint32(0xffffe000)).view(np.float32)
    lo = (x - hi).astype(np.float32)
    return hi, (lo.view(np.uint32) & np.uint32(0xffffe000)).view(np.float32)


def _range_sums(lo, hi, rows, live, t0: int, t1: int, kk: int) -> list:
    """[(row, f32 sum)] of the live slots of [t0, t1) in order, as the walk
    sums them: each (block of ``kk`` slots from t0, row) segment's products
    of the remainder summed and rounded to f32, the high part's added and
    rounded to f32, then added to the row's f32 sum."""
    idx = np.arange(t0, t1)[live[t0:t1]]
    if idx.size == 0:
        return []
    blk, r = (idx - t0) // kk, rows[idx]
    starts = np.flatnonzero((np.diff(blk, prepend=-1) != 0) | (np.diff(r, prepend=-1) != 0))
    d1 = np.add.reduceat(lo[idx], starts, axis=0).astype(np.float32)
    d = (d1.astype(np.float64) + np.add.reduceat(hi[idx], starts, axis=0)).astype(np.float32)
    out = []
    for row, dv in zip(r[starts], d):
        if out and out[-1][0] == row:
            out[-1][1] = out[-1][1] + dv  # f32 + f32, rounded to nearest
        else:
            out.append([row, dv])
    return out


def _bf16_mma_model(fa, fb, sched, n_rows: int) -> np.ndarray:
    """Kernel 1's bf16 route: A = a (bf16), B = v*b in f32 split into bf16
    hi + lo, 16-slot blocks in each of ``sched.parts``' ranges."""
    idx, v = sched.idx.numpy(), sched.vals.numpy().astype(np.float32)
    a = _bf16(fa.numpy()[idx[:, 0]]).astype(np.float64)
    b = (np.ones((idx.shape[0], 1), np.float32) if fb is None
         else _bf16(fb.numpy()[idx[:, 1]]))
    x = (v[:, None] * b).astype(np.float32)
    bh = _bf16(x)
    bl = _bf16((x - bh).astype(np.float32))
    k = a.shape[1] * b.shape[1]
    hi = (a[:, :, None] * bh[:, None, :].astype(np.float64)).reshape(-1, k)
    lo = (a[:, :, None] * bl[:, None, :].astype(np.float64)).reshape(-1, k)
    rows, parts = slot_rows(sched).numpy(), sched.parts.numpy()
    out = np.zeros((n_rows, k), np.float32)
    for p0, p1 in zip(parts[:-1], parts[1:]):
        for row, acc in _range_sums(lo, hi, rows, v != 0, int(p0), int(p1), 16):
            out[row] = acc
    return out


def _kernel5_bf16_model(fa, fb, u, sched, n_rows: int, held: int) -> np.ndarray:
    """Kernel 5's bf16 route: Y's rows by ``_bf16_mma_model``, then in each
    round of ``kernel5_rounds`` (a card holding ``held`` CTAs at once) U in
    bf16 (exact in TF32) times Y split into two TF32 parts: the
    remainder's products summed and rounded to f32, the high part's added
    and rounded to f32, then added to the CTA's f32 partial; the partials
    summed in f32 in CTA order."""
    y = _bf16_mma_model(fa, fb, sched, n_rows)
    ub = _bf16(u.numpy()).astype(np.float64)
    rb = 1 if fb is None else fb.shape[1]
    partials = []
    for rounds in kernel5_rounds(sched, fa.shape[1], rb, held):
        acc = np.zeros((ub.shape[1], y.shape[1]), np.float32)
        for rows in rounds:
            hi, lo = _tf32_split(y[rows])
            a = ub[rows]
            d = (a.T @ lo.astype(np.float64)).astype(np.float32)
            d = (d.astype(np.float64) + a.T @ hi.astype(np.float64)).astype(np.float32)
            acc = acc + d  # f32 + f32, rounded to nearest
        partials.append(acc)
    return reduce_in_cta_order(partials)


def _chain_2xtf32_model(factors, sched, n_rows: int) -> np.ndarray:
    """The chain kernel's bf16 route: A = f_1 (bf16), B = v (f_2 (x) ...)
    in f32 (f_2 in bf16, the later factors f32, multiplied in order) split
    into two TF32 parts, 8-slot blocks in each of ``sched.chain_cuts``'
    ranges, the partial rows added in range order."""
    idx, v = sched.idx.numpy(), sched.vals.numpy().astype(np.float32)
    f1 = _bf16(factors[0].numpy()[idx[:, 0]]).astype(np.float64)
    bx = v[:, None] * _bf16(factors[1].numpy()[idx[:, 1]])
    for c, f in enumerate(factors[2:], start=2):
        g = f.numpy().astype(np.float32)[idx[:, c]]
        bx = (bx[:, :, None] * g[:, None, :]).reshape(bx.shape[0], -1)  # f32 products
    bh, bl = _tf32_split(bx)
    k = f1.shape[1] * bx.shape[1]
    hi = (f1[:, :, None] * bh[:, None, :].astype(np.float64)).reshape(-1, k)
    lo = (f1[:, :, None] * bl[:, None, :].astype(np.float64)).reshape(-1, k)
    rows, cuts = slot_rows(sched).numpy(), sched.chain_cuts.numpy()
    out = np.zeros((n_rows, k), np.float32)
    seen = np.zeros(n_rows, bool)
    for c0, c1 in zip(cuts[:-1], cuts[1:]):
        for row, part in _range_sums(lo, hi, rows, v != 0, int(c0), int(c1), 8):
            out[row] = out[row] + part if seen[row] else part
            seen[row] = True
    return out


def _exact(rows_of_slots, terms, n_rows: int) -> np.ndarray:
    out = np.zeros((n_rows, terms.shape[1]))
    np.add.at(out, rows_of_slots, terms)
    return out


def _check(model, plain, ref, exact):
    """The model within TOL of the plain version and of the reference, and
    no further from the exact sum than the plain version is (plus the
    models' f32 sums)."""
    scale = np.abs(plain).max()
    assert np.isfinite(model).all()
    assert np.abs(model - plain).max() <= TOL * scale
    assert np.abs(model - np.asarray(ref)).max() <= TOL * scale
    assert np.abs(plain - np.asarray(ref)).max() <= TOL * scale
    slack = SUM_SLACK * np.abs(exact).max()
    assert np.abs(model - exact).max() <= np.abs(plain - exact).max() + slack


def _tensor(shape, nnz: int, rng, row0: int = 0):
    """Coordinates with repeats (``row0`` more nonzeros in slice 0 of mode
    0: one long row) and normal values, as numpy."""
    idx = np.stack([rng.integers(0, s, nnz) for s in shape], 1)
    if row0:
        long = np.stack([np.zeros(row0, np.int64)] + [rng.integers(0, s, row0)
                                                      for s in shape[1:]], 1)
        idx = np.concatenate([idx, long])
    idx = np.concatenate([idx, idx[:nnz // 7]]).astype(np.int32)
    return idx, rng.standard_normal(idx.shape[0]).astype(np.float32)


def _cancelling(shape, n: int, rng):
    """Slice 0 of mode 0 holds n terms and n more at the same coordinates
    with their values negated and scaled by 1 + 1e-3 u: its sum is ~1e-3 of
    its terms. Other slices hold ordinary terms."""
    idx, vals = _tensor(shape, 600, rng)
    pair = np.stack([np.zeros(n, np.int64)] + [rng.integers(0, s, n) for s in shape[1:]], 1)
    pv = rng.standard_normal(n).astype(np.float32)
    idx = np.concatenate([idx, pair, pair]).astype(np.int32)
    vals = np.concatenate([vals, pv, (-pv * (1 + 1e-3 * rng.uniform(size=n))).astype(np.float32)])
    return idx, vals


KERNEL1_CASES = [  # label, shape, ranks (of the modes), nnz, long row 0, bn, bi
    ("ranks 1, 17, 5", (30, 20, 10), (1, 17, 5), 500, 0, 128, 128),
    ("ranks 16", (40, 30, 20), (16, 16, 16), 400, 0, 16, 8),
    ("ranks 13, 3, 9", (25, 35, 15), (13, 3, 9), 700, 0, 128, 128),
    ("ranks 2, 7, 17", (20, 30, 40), (2, 7, 17), 600, 0, 16, 8),
    ("a row of 3,000 slots", (4, 300, 200), (5, 16, 16), 200, 3000, 128, 128),
    ("2-way, ranks 7, 5", (60, 50), (7, 5), 500, 0, 128, 128),
    ("2-way, ranks 1, 3", (90, 70), (1, 3), 300, 0, 16, 8),
]


def _kernel1_case(idx, vals, shape, ranks, rng, bn, bi, modes=None, kernel5_held=None):
    """Kernel 1's model, or with ``kernel5_held`` kernel 5's (on a card
    holding that many CTAs at once), checked every mode."""
    fs = [rng.standard_normal((s, r)).astype(np.float32) for s, r in zip(shape, ranks)]
    jc, tc = JCOO.from_parts(idx, vals, shape), SparseCOO.from_parts(idx, vals, shape)
    tfs = [torch.from_numpy(f) for f in fs]
    n = len(shape)
    for mode in range(n) if modes is None else modes:
        jlay = jbuild(jc, mode, bn=bn, bi=bi)
        jrows, jv = jops._gathered_block_rows(jc.indices, jc.values,
                                              [jnp.asarray(f) for f in fs], mode, jlay, n)
        sched = DeviceSchedule.from_layout(build_mode_layout(tc, mode, bn=bn, bi=bi), tc)
        m = operand_modes(n, mode)
        fa, fb = tfs[m[0]], (tfs[m[1]] if n == 3 else None)
        a = _bf16(fa.numpy()[sched.idx[:, 0].numpy()]).astype(np.float64)
        b = (np.ones((a.shape[0], 1)) if fb is None
             else _bf16(fb.numpy()[sched.idx[:, 1].numpy()]).astype(np.float64))
        terms = (a[:, :, None] * b[:, None, :]).reshape(a.shape[0], -1)
        exact = _exact(slot_rows(sched).numpy(), terms * sched.vals.numpy()[:, None],
                       shape[mode])
        if kernel5_held is None:
            ref = fused_kron_scatter_pallas(*jrows, jv, jlay, shape[mode], interpret=True,
                                            precision="bf16_fp32acc")
            plain = kron_kernel.fused_kron_scatter(fa, fb, sched, shape[mode],
                                                   precision="bf16_fp32acc").numpy()
            _check(_bf16_mma_model(fa, fb, sched, shape[mode]), plain, ref, exact)
            continue
        u = tfs[mode]
        ref = fused_kron_scatter_ttm_pallas(*jrows, jv, jnp.asarray(fs[mode]), jlay, shape[mode],
                                            interpret=True, precision="bf16_fp32acc")
        plain = kron_kernel.fused_kron_scatter_ttm(fa, fb, u, sched, shape[mode],
                                                   precision="bf16_fp32acc").numpy()
        model = _kernel5_bf16_model(fa, fb, u, sched, shape[mode], kernel5_held)
        _check(model, plain, ref, _bf16(u.numpy()).astype(np.float64).T @ exact)


@pytest.mark.parametrize("label,shape,ranks,nnz,row0,bn,bi", KERNEL1_CASES,
                         ids=[c[0] for c in KERNEL1_CASES])
def test_kernel1_bf16_mma_model_within_the_bf16_limit(label, shape, ranks, nnz, row0, bn, bi):
    rng = np.random.default_rng(34)
    idx, vals = _tensor(shape, nnz, rng, row0)
    _kernel1_case(idx, vals, shape, ranks, rng, bn, bi)


def test_kernel1_bf16_mma_model_on_a_cancelling_row():
    rng = np.random.default_rng(35)
    shape = (12, 40, 30)
    idx, vals = _cancelling(shape, 1500, rng)
    _kernel1_case(idx, vals, shape, (6, 16, 9), rng, 128, 128, modes=(0,))


@pytest.mark.parametrize("held", [264, 2])
@pytest.mark.parametrize("label,shape,ranks,nnz,row0,bn,bi", KERNEL1_CASES,
                         ids=[c[0] for c in KERNEL1_CASES])
def test_kernel5_bf16_model_within_the_bf16_limit(label, shape, ranks, nnz, row0, bn, bi, held):
    """Kernel 5's bf16 route (kernel 1's bf16 rows, rounds on 2xTF32 with U
    in bf16) within the bf16 limit of its plain version and of the
    reference's megakernel, and no further than the plain version from the
    f64 sum U^T Y of the bf16-operand terms: with two CTAs of an H100's 132
    SMs at once, and with 2 CTAs (rounds of several warps' rows)."""
    rng = np.random.default_rng(34)
    idx, vals = _tensor(shape, nnz, rng, row0)
    _kernel1_case(idx, vals, shape, ranks, rng, bn, bi, kernel5_held=held)


def test_kernel5_bf16_model_on_a_cancelling_row():
    rng = np.random.default_rng(35)
    shape = (12, 40, 30)
    idx, vals = _cancelling(shape, 1500, rng)
    _kernel1_case(idx, vals, shape, (6, 16, 9), rng, 128, 128, kernel5_held=2)


CHAIN_CASES = [  # label, shape, ranks, nnz, long row 0, slots a range
    ("4-way ranks 5, 4, 3, 2", (9, 8, 7, 6), (5, 4, 3, 2), 300, 0, 1024),
    ("4-way ranks 1, 17, 3, 7", (12, 10, 9, 8), (1, 17, 3, 7), 300, 0, 64),
    ("4-way ranks 17, 16, 4, 2, two m16 tiles", (8, 6, 5, 4), (17, 16, 4, 2), 200, 0, 37),
    ("4-way a row of 2,000 slots over many ranges", (3, 20, 15, 10), (2, 4, 3, 5), 100,
     2000, 64),
    ("5-way ranks 2, 3, 2, 2, 3", (7, 6, 5, 4, 3), (2, 3, 2, 2, 3), 250, 0, 50),
]


def _chain_case(idx, vals, shape, ranks, rng, spp, modes=None):
    fs = [rng.standard_normal((s, r)).astype(np.float32) for s, r in zip(shape, ranks)]
    jc, tc = JCOO.from_parts(idx, vals, shape), SparseCOO.from_parts(idx, vals, shape)
    tfs = [torch.from_numpy(f) for f in fs]
    n = len(shape)
    for mode in range(n) if modes is None else modes:
        ref = jops.sparse_ttm_chain_device(jc.indices, jc.values, [jnp.asarray(f) for f in fs],
                                           mode, jbuild(jc, mode), shape=shape, interpret=True,
                                           precision="bf16_fp32acc")
        sched = DeviceSchedule.from_layout(build_mode_layout(tc, mode), tc, slots_per_part=spp)
        opf = [tfs[t] for t in operand_modes(n, mode)]
        plain = kron_kernel.fused_kron_chain_scatter(opf, sched, shape[mode],
                                                     precision="bf16_fp32acc").numpy()
        model = _chain_2xtf32_model(opf, sched, shape[mode])
        ix = sched.idx.numpy()
        terms = sched.vals.numpy().astype(np.float64)[:, None]
        for c, f in enumerate(opf):
            g = f.numpy()[ix[:, c]]
            g = (_bf16(g) if c < 2 else g).astype(np.float64)
            terms = (terms[:, :, None] * g[:, None, :]).reshape(terms.shape[0], -1)
        _check(model, plain, ref, _exact(slot_rows(sched).numpy(), terms, shape[mode]))


@pytest.mark.parametrize("label,shape,ranks,nnz,row0,spp", CHAIN_CASES,
                         ids=[c[0] for c in CHAIN_CASES])
def test_chain_2xtf32_model_within_the_bf16_limit(label, shape, ranks, nnz, row0, spp):
    rng = np.random.default_rng(36)
    idx, vals = _tensor(shape, nnz, rng, row0)
    _chain_case(idx, vals, shape, ranks, rng, spp)


def test_chain_2xtf32_model_on_a_cancelling_row():
    rng = np.random.default_rng(37)
    shape = (5, 8, 7, 6)
    idx, vals = _cancelling(shape, 800, rng)
    _chain_case(idx, vals, shape, (3, 5, 4, 3), rng, 128, modes=(0,))


def test_the_routes_give_up_the_product_rounding():
    """The models differ from the plain version (its bf16 product rounding
    is given up) and are nearer the exact sum, at NELL-2-like positive
    terms of one long row (~2,000 terms, ranks 16 x 16)."""
    rng = np.random.default_rng(38)
    shape, n = (2, 400, 300), 2000
    idx = np.stack([np.zeros(n, np.int64), rng.integers(0, 400, n), rng.integers(0, 300, n)],
                   1).astype(np.int32)
    vals = rng.uniform(0.1, 10.0, n).astype(np.float32)
    tc = SparseCOO.from_parts(idx, vals, shape)
    sched = DeviceSchedule.from_layout(build_mode_layout(tc, 0), tc)
    fs = [torch.from_numpy(np.abs(rng.standard_normal((s, 16))).astype(np.float32))
          for s in shape]
    ma, mb = operand_modes(3, 0)
    plain = kron_kernel.fused_kron_scatter(fs[ma], fs[mb], sched, 2,
                                           precision="bf16_fp32acc").numpy()
    model = _bf16_mma_model(fs[ma], fs[mb], sched, 2)
    a = _bf16(fs[ma].numpy()[sched.idx[:, 0].numpy()]).astype(np.float64)
    b = _bf16(fs[mb].numpy()[sched.idx[:, 1].numpy()]).astype(np.float64)
    terms = (a[:, :, None] * b[:, None, :]).reshape(a.shape[0], -1) * sched.vals.numpy()[:, None]
    exact = _exact(slot_rows(sched).numpy(), terms, 2)
    assert not np.array_equal(model, plain)
    assert np.abs(model - exact).max() < np.abs(plain - exact).max()
    assert np.abs(model - plain).max() <= TOL * np.abs(plain).max()


# chip_smoke.py's BF16_CARD_VS_CPU: phase 3's bf16_fp32acc card against CPU,
# the cores in the CPU's factor basis
PHASE3_BF16 = {"fit": 2.0 ** -8, "proj": 2.0 ** -4, "core": 2.0 ** -6}


def _unrounded_products(monkeypatch) -> dict:
    """Make the plain versions form the card's bf16_fp32acc terms: the
    products of the bf16 operands kept in f32 (exact) instead of rounded to
    bf16, then scaled by the f32 value (within 2^-16 of the kernels' terms).
    Kernel 5's plain version builds its Y through kernel 1's, so it takes
    them too. Returns the calls of the patched kernel 1 by precision."""
    plain, rows = kron_kernel.fused_kron_scatter_plain, kron_kernel._kron_rows
    calls = {"fp32": 0, "bf16_fp32acc": 0}

    def kernel1(fa, fb, sched, n_rows, *, precision="fp32"):
        calls[precision] += 1
        if precision != "bf16_fp32acc":
            return plain(fa, fb, sched, n_rows, precision=precision)
        a = fa.index_select(0, sched.idx[:, 0]).bfloat16().float()
        b = (torch.ones((a.shape[0], 1)) if fb is None
             else fb.index_select(0, sched.idx[:, 1]).bfloat16().float())
        k = a.shape[1] * b.shape[1]
        out = torch.zeros((sched.n_row_blocks * sched.bi, k))
        out.index_add_(0, slot_rows(sched),
                       (a[:, :, None] * b[:, None, :]).reshape(-1, k) * sched.vals.float()[:, None])
        return kron_kernel._mask_unvisited(out[:n_rows], sched)

    def link(a, b, v, precision):
        if precision != "bf16_fp32acc":
            return rows(a, b, v, precision)
        a, b = a.bfloat16().float(), b.bfloat16().float()
        return (a[:, :, None] * b[:, None, :]).reshape(a.shape[0], -1) * v.float()[:, None]

    monkeypatch.setattr(kron_kernel, "fused_kron_scatter_plain", kernel1)
    monkeypatch.setattr(kron_kernel, "_kron_rows", link)
    return calls


@pytest.mark.parametrize("shape,density,ranks,seed,dist,fuse_core", [
    ((1000, 1000, 1000), 2.4e-5, (16, 16, 16), 11, "uniform", False),
    ((60, 50, 40, 10), 2e4 / (60 * 50 * 40 * 10), (4, 4, 4, 4), 13, "counts", False),
    ((1000, 1000, 1000), 2.4e-5, (16, 16, 16), 11, "uniform", True)],
    ids=["3-way", "4-way", "3-way fuse_core"])
def test_card_terms_keep_phase3_within_its_bf16_tolerances(monkeypatch, shape, density, ranks,
                                                           seed, dist, fuse_core):
    """Phase 3's bf16_fp32acc cases of chip_smoke.py: 5 sweeps from the same
    factors with the plain versions' terms and with the card's (products
    unrounded; with ``fuse_core`` kernel 5's too) stay within its
    BF16_CARD_VS_CPU limits, with room."""
    from repro_torch import tucker
    from repro_torch.core.engine import make_engine
    from repro_torch.core.ttm import ttm
    from repro_torch.sparse.generators import random_sparse_tensor

    x = random_sparse_tensor(shape, density, seed=seed, value_dist=dist)
    spec = tucker.TuckerSpec(shape, ranks, n_iter=5)
    rng = np.random.default_rng(0)
    f0 = [np.linalg.qr(rng.standard_normal((s, r)))[0].astype(np.float32)
          for s, r in zip(shape, ranks)]

    def run():
        tucker.clear_plan_cache()
        eng = make_engine("auto", "cpu", precision="bf16_fp32acc", fuse_core=fuse_core)
        return tucker.plan(spec, device="cpu", engine=eng)(
            x, factors_init=[torch.from_numpy(f) for f in f0])

    cpu = run()
    with monkeypatch.context() as m:
        calls = _unrounded_products(m)
        card = run()
    tucker.clear_plan_cache()
    if len(shape) == 3:  # kernel 1 a mode a sweep, and kernel 5's Y once a sweep
        assert calls["bf16_fp32acc"] == 5 * (4 if fuse_core else 3)
    assert np.isfinite(card.fit_history).all()
    assert np.abs(card.fit_history - cpu.fit_history).max() <= PHASE3_BF16["fit"] / 4
    proj = max(float((a @ a.T - b @ b.T).abs().max()) for a, b in zip(card.factors, cpu.factors))
    assert proj <= PHASE3_BF16["proj"] / 1.5
    core = card.core  # in the CPU run's factor basis, as align="basis" compares it
    for n, (a, b) in enumerate(zip(card.factors, cpu.factors)):
        core = ttm(core, b.T @ a, n)
    assert float((core - cpu.core).abs().max()) <= PHASE3_BF16["core"] / 2 * float(
        cpu.core.abs().max())
