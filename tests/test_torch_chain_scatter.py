"""repro_torch's order >= 4 unfolding in one kernel
(``kron_kernel.fused_kron_chain_scatter``, ``csrc/kron_chain_scatter.cu``)
on the CPU: its plain version against the reference's chain of kernels 3
and 4 in interpret mode and against the reference's XLA unfolding in f64,
against the port's own chain of plain versions, a model of the kernel's
long-row cuts and their in-order combine, the routing by order, the
autotuner's models and the schedule lint of the cuts.

Tolerances:
  * against the reference's chain (``kron_contrib_pallas`` link by link,
    then ``scatter_rows_pallas``): fp32 1e-5 x max|reference|, the same
    rounded terms summed in another order (``index_add_`` in slot order
    against a one-hot MXU dot); bf16_fp32acc 1e-2, since XLA's CPU backend
    may fuse the bf16 product with its f32 widening and skip the bf16
    rounding the port applies, one bf16 ulp (2^-8 relative) a term;
  * f64 against the reference's XLA unfolding under ``jax.enable_x64``:
    max(1e-13, 4 sqrt(n) 2^-53) x max|reference| for n terms summed into one
    output, the f64 rule of ``chip_smoke.py`` (other roundings and orders of
    f64 sums);
  * against the port's chain of plain versions: bit for bit, since both
    form each term with the same roundings and ``index_add_`` it in slot
    order;
  * the kernel's split of long rows over ranges, modelled in f32: the fp32
    rule max(1e-5, 4 sqrt(n) 2^-24) x max|one range| (the same terms, the
    sum of a row cut at range ends and added back in range order), and the
    same bits on every evaluation.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import kron as jkron
from repro.core.coo import SparseCOO as JCOO
from repro.kernels import ops as jops
from repro.sparse.layout import build_mode_layout as jbuild
from repro_torch import tucker
from repro_torch.analysis import schedule_lints
from repro_torch.core.coo import SparseCOO, unfold_dense
from repro_torch.core.ttm import ttm_chain
from repro_torch.kernels import autotune as at
from repro_torch.kernels import kron_kernel, launch_count, ops
from repro_torch.sparse.layout import (CHAIN_MIN_RANGES, DeviceSchedule, build_mode_layout,
                                       chain_range_slots, even_cuts, operand_modes, slot_rows)

from test_torch_batch import count_plain_launches

TOL = {"fp32": 1e-5, "bf16_fp32acc": 1e-2}
ORDERS = {4: ((9, 8, 7, 6), (3, 2, 4, 2)), 5: ((7, 6, 5, 4, 3), (2, 3, 2, 2, 2))}


def _close(got, want, tol):
    want = np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * max(np.abs(want).max(), 1e-30))


def _case(order, case, seed=0):
    """Coordinates and values of one case (numpy, shared by both packages):
    ``random``; ``alias_and_unvisited``, mode 0's rows as in
    ``tests/test_torch_chain.py`` (row 0 of the first group holds most
    nonzeros, then rows 3 and 5, the group's padding far from row 0's slots,
    the second row block unvisited); ``padding``, explicit zero-valued
    entries at coordinate 0; ``one_nonzero``."""
    shape, ranks = ORDERS[order]
    rng = np.random.default_rng(seed + 10 * order)
    if case == "one_nonzero":
        return np.zeros((1, order), np.int32), np.ones(1, np.float32), shape, ranks, rng
    if case == "alias_and_unvisited":
        shape = (30,) + shape[1:]
        rows = np.concatenate([np.zeros(37, np.int64), np.full(5, 3), np.full(4, 5),
                               rng.integers(16, 30, 25)])
        idx = np.stack([rows] + [rng.integers(0, s, rows.size) for s in shape[1:]], 1)
        return (idx.astype(np.int32), rng.standard_normal(rows.size).astype(np.float32), shape,
                ranks, rng)
    idx = np.stack([rng.integers(0, s, 150) for s in shape], 1).astype(np.int32)
    vals = rng.standard_normal(150).astype(np.float32)
    if case == "padding":
        idx = np.concatenate([idx, np.zeros((13, order), np.int32)])
        vals = np.concatenate([vals, np.zeros(13, np.float32)])
    return idx, vals, shape, ranks, rng


def _most_terms(idx, mode):
    return int(np.bincount(idx[:, mode]).max())


@pytest.mark.parametrize("bn,bi", [(16, 8), (128, 128)])
@pytest.mark.parametrize("case", ["random", "alias_and_unvisited", "padding", "one_nonzero"])
@pytest.mark.parametrize("precision", ["fp32", "bf16_fp32acc"])
@pytest.mark.parametrize("order", [4, 5])
def test_plain_matches_the_reference_chain(order, precision, case, bn, bi):
    """Every mode's Y against the reference's kron_contrib_pallas links and
    scatter_rows_pallas in interpret mode, on the same schedule geometry."""
    idx, vals, shape, ranks, rng = _case(order, case)
    fs = [rng.standard_normal((s, r)).astype(np.float32) for s, r in zip(shape, ranks)]
    jc, tc = JCOO.from_parts(idx, vals, shape), SparseCOO.from_parts(idx, vals, shape)
    tfs = [torch.from_numpy(f) for f in fs]
    for mode in range(order):
        want = jops.sparse_ttm_chain_device(jc.indices, jc.values, [jnp.asarray(f) for f in fs],
                                            mode, jbuild(jc, mode, bn=bn, bi=bi), shape=shape,
                                            interpret=True, precision=precision)
        sched = DeviceSchedule.from_layout(build_mode_layout(tc, mode, bn=bn, bi=bi), tc)
        before = kron_kernel.fused_kron_chain_scatter.launches
        got = kron_kernel.fused_kron_chain_scatter(
            [tfs[t] for t in operand_modes(order, mode)], sched, shape[mode], precision=precision)
        assert kron_kernel.fused_kron_chain_scatter.launches == before  # CPU: no launch
        assert got.dtype == torch.float32
        _close(got.numpy(), want, TOL[precision])
        if sched.row_mask is not None:  # unvisited row blocks come back zero
            assert not got.numpy()[~sched.row_mask.numpy()].any()


@pytest.mark.parametrize("order", [4, 5])
def test_f64_matches_the_reference_xla_unfolding(order):
    """f64 factors and values at fp32: an f64 Y, against the reference's XLA
    unfolding in f64."""
    idx, vals, shape, ranks, rng = _case(order, "random", seed=3)
    vals64 = vals.astype(np.float64) * (1 + 1e-9 * rng.standard_normal(vals.size))
    fs = [rng.standard_normal((s, r)) for s, r in zip(shape, ranks)]
    tc = SparseCOO.from_parts(idx, vals64, shape)
    tfs = [torch.from_numpy(f) for f in fs]
    for mode in range(order):
        with jax.enable_x64(True):
            jc = JCOO(jnp.asarray(idx), jnp.asarray(vals64), shape)
            want = np.asarray(jkron.sparse_ttm_chain(jc, [jnp.asarray(f) for f in fs], mode))
        assert want.dtype == np.float64
        sched = DeviceSchedule.from_layout(build_mode_layout(tc, mode), tc)
        got = kron_kernel.fused_kron_chain_scatter(
            [tfs[t] for t in operand_modes(order, mode)], sched, shape[mode])
        assert got.dtype == torch.float64
        _close(got.numpy(), want, max(1e-13, 4 * _most_terms(idx, mode) ** 0.5 * 2.0 ** -53))


@pytest.mark.parametrize("chunk", [None, 200])
@pytest.mark.parametrize("dtype,precision", [(torch.float32, "fp32"),
                                             (torch.float32, "bf16_fp32acc"),
                                             (torch.float64, "fp32"),
                                             (torch.float64, "bf16_fp32acc")])
@pytest.mark.parametrize("order", [4, 5])
def test_plain_is_the_chain_of_plain_versions_bit_for_bit(order, dtype, precision, chunk,
                                                          monkeypatch):
    """The default route (``fused=True``) gives the bits of ``fused=False``,
    kron_contrib_plain link by link and scatter_rows_plain, in every dtype
    and precision, also when the plain version works in chunks of a few
    slots (``chunk`` Kron entries: 8 slots at order 5)."""
    if chunk is not None:
        monkeypatch.setattr(kron_kernel, "PLAIN_CHUNK_ELEMS", chunk)
    idx, vals, shape, ranks, rng = _case(order, "alias_and_unvisited", seed=5)
    tc = SparseCOO.from_parts(idx, vals.astype(np.float64), shape)
    tc = SparseCOO(tc.indices, tc.values.to(dtype), tc.shape)
    tfs = [torch.from_numpy(rng.standard_normal((s, r))).to(dtype) for s, r in zip(shape, ranks)]
    for mode in range(order):
        sched = DeviceSchedule.from_layout(build_mode_layout(tc, mode, bn=16, bi=8), tc)
        kw = dict(shape=shape, precision=precision)
        fused = ops.sparse_ttm_chain_device(tc.indices, tc.values, tfs, mode, sched, **kw)
        chain = ops.sparse_ttm_chain_device(tc.indices, tc.values, tfs, mode, sched,
                                            fused=False, **kw)
        assert fused.dtype == chain.dtype == kron_kernel.result_dtype(dtype, precision)
        assert torch.equal(fused, chain)


# -- the kernel's split of long rows over warps --------------------------------

CUT_CASES = [(1, 1024), (1024, 1024), (1025, 1024), (3_101_696, 1024), (128, 7), (5000, 37),
             (64, 1), (2048, 4096)]


@pytest.mark.parametrize("nnzp,spr", CUT_CASES)
def test_even_cuts_cover_every_slot_once_in_order(nnzp, spr):
    cuts = even_cuts(nnzp, spr)
    assert cuts.dtype == torch.int64 and int(cuts[0]) == 0 and int(cuts[-1]) == nnzp
    lens = torch.diff(cuts)
    assert bool((lens > 0).all())  # no empty range
    assert bool((lens[:-1] == spr).all()) and 0 < int(lens[-1]) <= spr  # equal, the last short
    assert cuts.numel() - 1 == -(-nnzp // spr)
    covered = torch.cat([torch.arange(int(a), int(b)) for a, b in zip(cuts[:-1], cuts[1:])]) \
        if nnzp < 10_000 else None
    if covered is not None:
        assert torch.equal(covered, torch.arange(nnzp))
    with pytest.raises(ValueError):
        even_cuts(nnzp, 0)


@pytest.mark.parametrize("nnzp,spp", [(3_102_848, 1024), (3_102_848, 2048), (80_128, 1024),
                                      (1_000_064, 1024), (2048, 1024), (2050, 7), (96, 512),
                                      (76_879_616, 512)])
def test_chain_ranges_hold_slots_per_part_or_fewer_on_small_tensors(nnzp, spp):
    """A range holds ``slots_per_part`` slots, or fewer on a small tensor: the
    least multiple of 32 (the kernel's chunk, at least 32) that cuts it into
    at most CHAIN_MIN_RANGES ranges; a ``slots_per_part`` under 32 is kept."""
    per = chain_range_slots(nnzp, spp)
    assert 1 <= per <= spp
    if spp < 32:
        assert per == spp
    if per < spp:
        assert per % 32 == 0
        assert -(-nnzp // per) <= CHAIN_MIN_RANGES or per == 32
        assert per == 32 or -(-nnzp // (per - 32)) > CHAIN_MIN_RANGES
    if nnzp >= spp * CHAIN_MIN_RANGES:  # a large tensor keeps slots_per_part
        assert per == spp


def _kernel_model(contrib, sched, n_rows, cuts):
    """The chain kernel's sums in its order, in f32 (``contrib`` the slots'
    Kron rows): each range walks its slots in order, a zero-valued slot
    adding nothing and starting no row; the rows that start and end inside
    the range are stored, its first and last rows go to two partial
    entries (row -1 for none); then each row's partials are summed in
    range order. Returns Y and the ranges each row was split over."""
    k = contrib.shape[1]
    rows, vals = slot_rows(sched).tolist(), sched.vals.tolist()
    out = torch.zeros((n_rows, k), dtype=contrib.dtype)
    part, part_rows = [], []
    for a, b in zip(cuts[:-1].tolist(), cuts[1:].tolist()):
        cur, acc, ended, head, tail = -1, None, 0, (-1, None), (-1, None)
        for t in range(a, b):
            row = rows[t] if vals[t] != 0 else -1
            if row > cur:
                if cur >= 0:
                    if ended == 0:
                        head = (cur, acc)
                    else:
                        out[cur] = acc
                    ended += 1
                cur, acc = row, torch.zeros(k, dtype=contrib.dtype)
            if cur >= 0 and row >= 0:
                acc = acc + contrib[t]
        if cur >= 0:
            if ended == 0:
                head = (cur, acc)
            else:
                tail = (cur, acc)
        for r, p in (head, tail):
            part_rows.append(r)
            part.append(p)
    spans = {}
    e = 0
    while e < len(part_rows):  # the combine: each row's partials in range order
        r = part_rows[e]
        if r < 0:
            e += 1
            continue
        acc, q, n = part[e], e + 1, 1
        while q < len(part_rows) and part_rows[q] in (-1, r):
            if part_rows[q] == r:
                acc, n = acc + part[q], n + 1
            q += 1
        out[r], spans[r] = acc, n
        e = q
    return out, spans


@pytest.mark.parametrize("spr", [1, 7, 37, 100, 1024])
def test_long_rows_split_over_ranges_sum_in_range_order(spr):
    """A 4-way tensor whose mode-3 rows hold ~500 slots each (NIPS's last
    mode in small): cut into ranges of ``spr`` slots, every row comes back
    within the fp32 rule of its one-range sum, the rows that span ranges are
    summed from their partials, and the same bits come back every time. One
    range is the plain version's sum exactly."""
    shape, ranks = (40, 30, 20, 4), (2, 3, 4, 2)
    rng = np.random.default_rng(11)
    idx = np.stack([rng.integers(0, s, 2000) for s in shape], 1).astype(np.int32)
    vals = rng.standard_normal(2000).astype(np.float32)
    vals[::97] = 0.0  # explicit zeros: they add nothing and end no row
    tc = SparseCOO.from_parts(idx, vals, shape)
    tfs = [torch.from_numpy(rng.standard_normal((s, r)).astype(np.float32))
           for s, r in zip(shape, ranks)]
    mode = 3
    sched = DeviceSchedule.from_layout(build_mode_layout(tc, mode, bn=16, bi=8), tc,
                                       slots_per_part=spr)
    rows, v = ops._gathered_block_rows(tc.indices, tc.values, tfs, mode, sched, 4)
    contrib = kron_kernel.kron_contrib_plain(rows[0], rows[1], v)
    contrib = kron_kernel.kron_contrib_plain(contrib, rows[2], torch.ones_like(v))
    nnzp = int(sched.idx.shape[0])
    assert torch.equal(sched.chain_cuts, even_cuts(nnzp, chain_range_slots(nnzp, spr)))
    cuts = even_cuts(nnzp, spr)  # the kernel's sums for ranges of spr slots
    got, spans = _kernel_model(contrib, sched, shape[mode], cuts)
    again, _ = _kernel_model(contrib, sched, shape[mode], cuts)
    assert torch.equal(got, again)
    one, one_spans = _kernel_model(contrib, sched, shape[mode], even_cuts(nnzp, nnzp))
    plain = kron_kernel.fused_kron_chain_scatter([tfs[t] for t in operand_modes(4, mode)], sched,
                                                 shape[mode])
    assert torch.equal(one, plain) and set(one_spans.values()) == {1}
    n_terms = _most_terms(idx, mode)
    _close(got.numpy(), plain.numpy(), max(1e-5, 4 * n_terms ** 0.5 * 2.0 ** -24))
    if spr < 400:  # rows of ~500 slots: every row from the partials of several ranges
        assert sorted(spans) == list(range(shape[mode])) and min(spans.values()) >= 2
    else:  # a row inside one range is stored by it directly
        assert len(spans) < shape[mode]
    assert max(spans.values()) <= -(-n_terms // spr) + 2


# -- routing -------------------------------------------------------------------


@pytest.mark.parametrize("order", [4, 5])
def test_decompose_launches_the_chain_kernel_once_a_mode_and_gathers_nothing(order,
                                                                             monkeypatch):
    """A 4- and a 5-way ``decompose(device="cpu")``: the new wrapper once a
    mode a sweep (its plain version counts as the kernel would), the TTM
    kernel once a sweep, no kernel 3 or 4 and no (nnz, R) gather."""
    count_plain_launches(monkeypatch)
    idx, vals, shape, ranks, _ = _case(order, "random", seed=7)
    coo = SparseCOO.from_parts(idx, vals, shape)
    gathers = ops._gathered_block_rows.calls
    t0 = launch_count.tally()
    res = tucker.decompose(coo, ranks, n_iter=2, device="cpu")
    assert launch_count.since(t0) == {"fused_kron_chain_scatter": 2 * order, "ttm": 2}
    assert ops._gathered_block_rows.calls == gathers
    assert res.launches == 2 * order + 2 and np.all(np.isfinite(res.fit_history))


def test_unfused_route_still_launches_kernels_3_and_4(monkeypatch):
    count_plain_launches(monkeypatch)
    idx, vals, shape, ranks, rng = _case(4, "random", seed=8)
    tc = SparseCOO.from_parts(idx, vals, shape)
    tfs = [torch.from_numpy(rng.standard_normal((s, r)).astype(np.float32))
           for s, r in zip(shape, ranks)]
    sched = DeviceSchedule.from_layout(build_mode_layout(tc, 1), tc)
    gathers = ops._gathered_block_rows.calls
    t0 = launch_count.tally()
    y = ops.sparse_ttm_chain_device(tc.indices, tc.values, tfs, 1, sched, shape=shape,
                                    fused=False)
    assert launch_count.since(t0) == {"kron_contrib": 2, "scatter_rows": 1}
    assert ops._gathered_block_rows.calls == gathers + 1
    t0 = launch_count.tally()
    assert torch.equal(y, ops.sparse_ttm_chain_device(tc.indices, tc.values, tfs, 1, sched,
                                                      shape=shape))
    assert launch_count.since(t0) == {"fused_kron_chain_scatter": 1}


def test_orders_above_the_kernels_cap_take_the_chain(monkeypatch):
    """Order 7 (six operand factors, above ``MAX_CHAIN_OPERANDS``): the
    chain of kernels 3 and 4, chosen by order, against the dense oracle."""
    assert kron_kernel.MAX_CHAIN_OPERANDS == 5
    count_plain_launches(monkeypatch)
    shape, ranks = (5, 4, 3, 3, 2, 3, 2), (2, 2, 1, 2, 1, 2, 2)
    rng = np.random.default_rng(9)
    idx = np.stack([rng.integers(0, s, 120) for s in shape], 1).astype(np.int32)
    tc = SparseCOO.from_parts(idx, rng.standard_normal(120).astype(np.float32), shape)
    tfs = [torch.from_numpy(rng.standard_normal((s, r)).astype(np.float32))
           for s, r in zip(shape, ranks)]
    dense = tc.to_dense()
    for mode in (0, 6):
        sched = DeviceSchedule.from_layout(build_mode_layout(tc, mode), tc)
        t0 = launch_count.tally()
        y = ops.sparse_ttm_chain_device(tc.indices, tc.values, tfs, mode, sched, shape=shape)
        assert launch_count.since(t0) == {"kron_contrib": 5, "scatter_rows": 1}
        _close(y.numpy(), unfold_dense(ttm_chain(dense, tfs, skip=mode), mode).numpy(), 1e-5)


# -- the autotuner's models and the schedule lint ---------------------------------


def test_autotune_models_the_chain_kernel():
    nips, ranks = (2482, 2862, 14036, 17), (16, 16, 16, 16)
    cfg = at.DEFAULT_CONFIG
    # one warp's ring: 2 stages x 32 slots x 3 factor rows, each a 16-word
    # (f32, f64) or 16-element (bf16 f_1, f_2; f32 later factors) stride
    assert at.smem_bytes(cfg, nips, ranks) == 2 * 32 * 3 * 16 * 4
    assert at.smem_bytes(cfg, nips, ranks, "bf16_fp32acc") == 2 * 32 * (2 * 16 * 2 + 16 * 4)
    assert at.smem_bytes(cfg, nips, ranks, dtype="float64") == 2 * 32 * 3 * 16 * 8
    assert at.smem_bytes(cfg, (9, 8, 7, 6, 5, 4, 3), (2,) * 7) == 0  # above the cap: the chain
    # no (slots, K) rows written and read: well under 2 GB a NIPS sweep
    # (the chain of kernels 3 and 4 moved ~200 GB), fewer partial rows with
    # longer ranges
    nnz = 3_101_609
    b = at.sweep_bytes(cfg, nips, ranks, nnz)
    assert b < 2e9
    assert at.sweep_bytes(cfg._replace(slots_per_part=2048), nips, ranks, nnz) < b
    slots = at.padded_slots(cfg, nips, nnz) // 4
    assert b > 4 * slots * (4 * 4 + 4 + 4)
    big = (100, 100, 100, 100, 100, 100, 100)
    assert at.sweep_bytes(cfg, big, (2,) * 7, 10_000) > 2 * 10_000 * 64 * 4


def test_schedule_lint_checks_the_chain_cuts():
    idx, vals, shape, ranks, _ = _case(4, "random", seed=12)
    tc = SparseCOO.from_parts(idx, vals, shape)
    sched = DeviceSchedule.from_layout(build_mode_layout(tc, 2, bn=16, bi=8), tc,
                                       slots_per_part=32)
    assert sched.chain_cuts is not None and sched.chain_cuts.numel() > 3
    assert schedule_lints.scatter_race_lint_device(sched, tc) == []
    cuts = sched.chain_cuts.clone()
    cuts[1] = cuts[2]  # an empty range
    bad = schedule_lints.scatter_race_lint_device(
        DeviceSchedule(**{**sched.__dict__, "chain_cuts": cuts}), tc)
    assert [f.check for f in bad] == ["scatter-race"] and "chain_cuts" in bad[0].message
    three = SparseCOO.from_parts(idx[:, :3], vals, shape[:3])
    sched3 = DeviceSchedule.from_layout(build_mode_layout(three, 0), three)
    assert sched3.chain_cuts is None
    assert schedule_lints.scatter_race_lint_device(sched3, three) == []
