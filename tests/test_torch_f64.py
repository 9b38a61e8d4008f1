"""float64 in repro_torch on the CPU: the plain versions of kernels 1-4
computing in f64 against the reference's Pallas kernels in interpret mode,
and ``plan(TuckerSpec(dtype="float64"), device="cpu")`` against the
reference's XLA engine in f64 (``jax.enable_x64``), the one the port's
card is held to (its kernels compute in the spec's dtype; the reference's
Pallas kernels in f32 whatever the dtype).

Tolerances:
  * the kernels' f64 plain versions against the reference's f32 Pallas
    kernels, on inputs that f32 holds exactly: the f32 rule of
    ``chip_smoke.py`` (max(1e-5, 4 sqrt(n) 2^-24) x max|reference| for n
    terms summed into one output): the f64 result is the f32 one's exact
    sum, so the two differ by the f32 side's rounding;
  * the sparse f64 decomposition against the reference's XLA engine in
    f64: the last sweep's f64 fit (the projection identity on each core,
    with ||X|| taken here in f64) 1e-10, factor projectors 1e-8 (f64
    arithmetic in other summation orders, 3 sweeps of f64 QRP). The fit
    histories are f32 in both packages, and the reference takes ||X|| in
    f32 even for f64 values, the port in f64 (a deviation on purpose: an
    f64 fit near 0 keeps no f32 floor), so the histories agree to 1e-6;
  * ``bf16_fp32acc`` with f64 tensors against the reference's Pallas engine
    under x64 (the same bf16 operands, f32 sums): fit 1e-4, projectors and
    core 1e-3, the port's bf16 parity bounds (``test_torch_tucker.py``);
  * a numpy model of kernel 1's f64 route on the tensor cores (DMMA: v a
    rounded once, its products with b summed in blocks of k slots, each
    block added to the row's f64 sum) against the f64 plain version at
    NELL-2's longest rows (~8.4 K terms): ``chip_smoke.py``'s fp64 rule,
    max(1e-13, 4 sqrt(n) 2^-53) x max|plain|, the one the card is held to;
    and of kernel 5's f64 route (that walk's rows contracted with U in
    rounds of one row a warp, each round added to its CTA's f64 partial,
    the partials summed in CTA order) against the f64 plain version, by the
    same rule with n the tensor's nonzeros.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import tucker as jtucker
from repro.core.coo import SparseCOO as JCOO
from repro.kernels import ops as jops
from repro.kernels.kron_kernel import (fused_kron_scatter_pallas, kron_contrib_pallas,
                                       scatter_rows_pallas)
from repro.kernels.ttm_kernel import ttm_pallas
from repro.sparse.layout import build_mode_layout as jbuild
from repro_torch import tucker
from repro_torch.convert import coo_from_numpy, factors_from_numpy
from repro_torch.core.coo import SparseCOO
from repro_torch.kernels import autotune as at
from repro_torch.kernels import kron_kernel, ops, ttm_kernel
from repro_torch.sparse.layout import (DeviceSchedule, build_mode_layout, operand_modes,
                                       slot_rows)


def _f32_rule(got, want, n_terms):
    want = np.asarray(want, dtype=np.float64)
    tol = max(1e-5, 4 * n_terms ** 0.5 * 2.0 ** -24)
    np.testing.assert_allclose(np.asarray(got), want, rtol=0,
                               atol=tol * max(np.abs(want).max(), 1e-30))


def _inputs(shape, ranks, nnz, seed):
    """f32 values and factors (exact in f64 too), coordinates with repeats."""
    rng = np.random.default_rng(seed)
    idx = np.stack([rng.integers(0, s, nnz) for s in shape], 1).astype(np.int32)
    vals = rng.standard_normal(nnz).astype(np.float32)
    fs = [rng.standard_normal((s, r)).astype(np.float32) for s, r in zip(shape, ranks)]
    return idx, vals, fs


def _most_terms(idx, mode):
    return int(np.bincount(idx[:, mode]).max())


@pytest.mark.parametrize("shape,ranks", [((40, 35, 30), (5, 4, 3)), ((33, 9, 300), (3, 5, 2)),
                                         ((300, 40), (6, 4))])
def test_kernel1_plain_f64_matches_pallas(shape, ranks):
    idx, vals, fs = _inputs(shape, ranks, 700, 1)
    jc = JCOO.from_parts(idx, vals, shape)
    tc = SparseCOO.from_parts(idx, vals.astype(np.float64), shape)
    tfs = [torch.from_numpy(f.astype(np.float64)) for f in fs]
    n = len(shape)
    for mode in range(n):
        jlay = jbuild(jc, mode, bn=16, bi=8)
        jrows, jv = jops._gathered_block_rows(jc.indices, jc.values,
                                              [jnp.asarray(f) for f in fs], mode, jlay, n)
        want = fused_kron_scatter_pallas(*jrows, jv, jlay, shape[mode], interpret=True)
        sched = DeviceSchedule.from_layout(build_mode_layout(tc, mode, bn=16, bi=8), tc)
        assert sched.vals.dtype == torch.float64
        modes = operand_modes(n, mode)
        got = kron_kernel.fused_kron_scatter(tfs[modes[0]], tfs[modes[1]] if n == 3 else None,
                                             sched, shape[mode])
        assert got.dtype == torch.float64 and np.asarray(want).dtype == np.float32
        _f32_rule(got.numpy(), want, _most_terms(idx, mode))


def test_kernels34_plain_f64_match_pallas():
    """The order >= 4 chain in f64: both links of kron_contrib and the row
    scatter, each against the reference's kernel on the same rows."""
    shape, ranks = (9, 8, 7, 6), (3, 2, 4, 2)
    idx, vals, fs = _inputs(shape, ranks, 400, 2)
    jc = JCOO.from_parts(idx, vals, shape)
    tc = SparseCOO.from_parts(idx, vals.astype(np.float64), shape)
    tfs = [torch.from_numpy(f.astype(np.float64)) for f in fs]
    for mode in range(4):
        jlay = jbuild(jc, mode, bn=16, bi=8)
        jrows, jv = jops._gathered_block_rows(jc.indices, jc.values,
                                              [jnp.asarray(f) for f in fs], mode, jlay, 4)
        sched = DeviceSchedule.from_layout(build_mode_layout(tc, mode, bn=16, bi=8), tc)
        trows, tv = ops._gathered_block_rows(tc.indices, tc.values, tfs, mode, sched, 4)
        c1 = kron_kernel.kron_contrib(trows[0], trows[1], tv)
        j1 = kron_contrib_pallas(jrows[0], jrows[1], jv, interpret=True)
        assert c1.dtype == torch.float64
        _f32_rule(c1.numpy(), j1, 1)
        c2 = kron_kernel.kron_contrib(c1, trows[2], torch.ones_like(tv))
        j2 = kron_contrib_pallas(j1, jrows[2], jnp.ones_like(jv), interpret=True)
        _f32_rule(c2.numpy(), j2, 1)
        got = kron_kernel.scatter_rows(c2, sched, shape[mode])
        want = scatter_rows_pallas(j2, jlay, shape[mode], interpret=True)
        assert got.dtype == torch.float64
        _f32_rule(got.numpy(), want, _most_terms(idx, mode))
        # the unfolding through ops, the path the sweeps take
        y = ops.sparse_ttm_chain_device(tc.indices, tc.values, tfs, mode, sched, shape=shape)
        np.testing.assert_array_equal(y.numpy(), got.numpy())


@pytest.mark.parametrize("l,i,r", [(256, 300, 16), (15, 1000, 3), (100, 37, 17)])
def test_kernel2_plain_f64_matches_pallas(l, i, r):
    rng = np.random.default_rng(l + i)
    y = rng.standard_normal((l, i)).astype(np.float32)
    u = rng.standard_normal((r, i)).astype(np.float32)
    got = ttm_kernel.ttm(torch.from_numpy(y.astype(np.float64)),
                         torch.from_numpy(u.astype(np.float64)))
    want = ttm_pallas(jnp.asarray(y), jnp.asarray(u), interpret=True)
    assert got.dtype == torch.float64
    _f32_rule(got.numpy(), want, i)
    # f32 operands stay f32, bit for bit the f32 product as before
    f32 = ttm_kernel.ttm(torch.from_numpy(y), torch.from_numpy(u))
    assert f32.dtype == torch.float32
    assert torch.equal(f32, torch.from_numpy(y) @ torch.from_numpy(u).T)


def test_bf16_route_of_f64_operands_sums_in_f32():
    """Under bf16_fp32acc f64 operands take the bf16 route with f32 values
    and results, as the reference's kernels."""
    shape, ranks = (20, 15, 12), (3, 4, 2)
    idx, vals, fs = _inputs(shape, ranks, 200, 3)
    tc = SparseCOO.from_parts(idx, vals.astype(np.float64), shape)
    f64 = [torch.from_numpy(f.astype(np.float64)) for f in fs]
    f32 = [torch.from_numpy(f) for f in fs]
    sched = DeviceSchedule.from_layout(build_mode_layout(tc, 0), tc)
    sched32 = DeviceSchedule.from_layout(build_mode_layout(tc, 0), SparseCOO.from_parts(
        idx, vals, shape))
    got = kron_kernel.fused_kron_scatter(f64[2], f64[1], sched, shape[0],
                                         precision="bf16_fp32acc")
    want = kron_kernel.fused_kron_scatter(f32[2], f32[1], sched32, shape[0],
                                          precision="bf16_fp32acc")
    assert got.dtype == torch.float32
    assert torch.equal(got, want)
    g2 = ttm_kernel.ttm(got.T, f64[0].T, precision="bf16_fp32acc")
    assert g2.dtype == torch.float32


SPARSE = {2: ((40, 30), (5, 4), 0.05), 3: ((30, 25, 20), (4, 3, 3), 0.02),
          4: ((12, 10, 9, 8), (3, 2, 3, 2), 0.02)}


def _ref_and_port(order, method, **kw):
    shape, ranks, density = SPARSE[order]
    rng = np.random.default_rng(order)
    nnz = int(np.prod(shape) * density)
    lin = rng.choice(int(np.prod(shape)), nnz, replace=False)
    idx = np.stack(np.unravel_index(lin, shape), 1).astype(np.int32)
    vals = rng.uniform(0.1, 1.0, nnz)
    ranks = tucker.TuckerSpec(shape, ranks).ranks  # the clamped ranks
    f0 = [np.linalg.qr(rng.standard_normal((s, r)))[0] for s, r in zip(shape, ranks)]
    engine = kw.pop("ref_engine", "xla")
    with jax.enable_x64(True):
        jspec = jtucker.TuckerSpec(shape, ranks, method=method, n_iter=3, dtype="float64",
                                   engine=engine, **kw)
        jc = JCOO(jnp.asarray(idx), jnp.asarray(vals), shape)
        ref = jtucker.plan(jspec)(jc, factors_init=[jnp.asarray(f) for f in f0])
        ref = (np.asarray(ref.fit_history), [np.asarray(f) for f in ref.factors],
               np.asarray(ref.core))
    assert ref[2].dtype == np.float64
    spec = tucker.TuckerSpec(shape, ranks, method=method, n_iter=3, dtype="float64", **kw)
    port = tucker.plan(spec, device="cpu")(coo_from_numpy(idx, vals, shape),
                                           factors_init=factors_from_numpy(f0))
    assert port.core.dtype == torch.float64
    assert all(f.dtype == torch.float64 for f in port.factors)
    return ref + (float(np.sum(vals * vals)),), port


def _fit64(core, x2):
    """The relative error of a core by the projection identity, in f64."""
    return np.sqrt(max(x2 - float(np.sum(np.square(core))), 0.0) / x2)


def _assert_close(ref, port, fit_tol, proj_tol, core_tol=None):
    fit, fs, core, x2 = ref
    got64 = _fit64(port.core.numpy(), x2)
    assert abs(got64 - _fit64(core, x2)) <= fit_tol
    # the port's f32 history rounds its f64 fit; the reference's rounds a
    # fit taken with ||X|| in f32
    assert abs(float(port.fit_history[-1]) - got64) <= 2.0 ** -24
    np.testing.assert_allclose(port.fit_history, fit, rtol=0, atol=max(fit_tol, 1e-6))
    got = port.core.numpy()
    for n, (a, b) in enumerate(zip(port.factors, fs)):
        a = a.numpy()
        np.testing.assert_allclose(a @ a.T, b @ b.T, rtol=0, atol=proj_tol)
        sign = np.sign(np.sum(a * b, axis=0))
        got = got * sign.reshape([-1 if t == n else 1 for t in range(got.ndim)])
    if core_tol is not None:
        np.testing.assert_allclose(got, core, rtol=0, atol=core_tol * np.abs(core).max())


@pytest.mark.parametrize("method", ["householder", "gram", "svd"])
@pytest.mark.parametrize("order", [2, 3, 4])
def test_f64_plan_matches_the_reference_xla_engine(order, method):
    ref, port = _ref_and_port(order, method)
    _assert_close(ref, port, 1e-10, 1e-8)


def test_bf16_precision_with_f64_matches_the_reference():
    ref, port = _ref_and_port(3, "householder", precision="bf16_fp32acc",
                              ref_engine="pallas")
    assert port.precision == "bf16_fp32acc"
    _assert_close(ref, port, 1e-4, 1e-3, 1e-3)


@pytest.mark.parametrize("shape,ranks", [((12092, 9184, 28818), (16, 16, 16)),
                                         ((20000, 20000, 20000), (32, 32, 32)),
                                         ((500, 400, 300), (64, 64, 48)),
                                         ((300, 200), (128, 1))])
def test_autotune_sizes_f64_staging_within_the_limit(shape, ranks):
    """The shared-memory prune counts 8-byte elements in float64: no
    candidate goes over the per-block limit, and 3-way f64 problems whose
    kernel 5 CTA fits are offered the fused layout (2-way ones never are,
    as in f32)."""
    limit = at.H100_SMEM_PER_BLOCK_OPTIN
    cands = at.candidate_configs(shape, ranks, 10_000, dtype="float64")
    assert cands[0] == at.DEFAULT_CONFIG
    for c in cands[1:]:
        assert at.smem_bytes(c, shape, ranks, dtype="float64") <= limit
    assert any(c.layout == "fused" for c in cands) == (len(shape) == 3)
    ring64 = at._ring_bytes(16, 16, "fp32", "float64")
    assert ring64 == 2 * at._ring_bytes(16, 16, "fp32") == 16384
    assert at._ring_bytes(16, 16, "bf16_fp32acc", "float64") == 4096
    assert (at.sweep_bytes(at.DEFAULT_CONFIG, shape, ranks, 10_000, dtype="float64")
            > at.sweep_bytes(at.DEFAULT_CONFIG, shape, ranks, 10_000))


def test_autotune_prunes_f64_rings_that_do_not_fit():
    # ranks 512 x 512 at f64: one warp's ring takes 2 x 32 x 1,024 x 8 = 512 KB
    shape, ranks = (600, 600, 600), (512, 512, 64)
    assert at._ring_bytes(512, 512, "fp32", "float64") > at.H100_SMEM_PER_BLOCK_OPTIN
    assert at.candidate_configs(shape, ranks, 1000, dtype="float64") == [at.DEFAULT_CONFIG]


def test_autotune_offers_and_prunes_the_fused_f64_layout():
    """Kernel 5's f64 CTA counts its partial, held rows and U at 8 bytes
    (rows padded by 2 doubles): at core rank 16 it fits (an 8-warp CTA is
    the launcher's 195 KB), at core rank 128 the partial of one warp alone
    is 256 KB, so the fused layout is pruned in f64 but kept in f32, where
    it is 128 KB."""
    ring = at._ring_bytes(16, 16, "fp32", "float64")
    assert at._mega_cta_bytes(8, 16, ring, 8) == 131072 + 32768 + 33024 + 2304 + 64
    assert at._mega_cta_bytes(8, 16, ring, 8) <= at.H100_SMEM_PER_BLOCK_OPTIN
    shape = (300, 300, 300)
    fused = at.BlockConfig(layout="fused")
    for ranks, fits in (((16, 16, 16), True), ((16, 16, 128), False)):
        assert (at.smem_bytes(fused, shape, ranks, dtype="float64")
                <= at.H100_SMEM_PER_BLOCK_OPTIN) == fits
        cands = at.candidate_configs(shape, ranks, 5000, dtype="float64")
        assert any(c.layout == "fused" for c in cands) == fits
    assert any(c.layout == "fused" for c in at.candidate_configs(shape, (16, 16, 128), 5000))
    # the f64 partials are modeled at 8 bytes, 132 CTAs
    split = at.sweep_bytes(at.DEFAULT_CONFIG, shape, (16, 16, 16), 5000, dtype="float64")
    assert (at.sweep_bytes(fused, shape, (16, 16, 16), 5000, dtype="float64")
            == split - 2 * 300 * 256 * 8 + 132 * 16 * 256 * 8)


@pytest.mark.parametrize("shape,ranks", [((40, 35, 30), (5, 4, 3)), ((33, 9, 300), (3, 5, 17)),
                                         ((300, 40), (6, 4))])
def test_kernel5_plain_f64_matches_the_reference_xla_engine(shape, ranks):
    """Kernel 5's plain version in f64 (the fused core update of the last
    mode) against the reference's XLA engine under ``jax.enable_x64``: the
    unfolding, then the TTM, in f64. Held to the f64 rule,
    max(1e-13, 4 sqrt(n) 2^-53) x max|reference| for n terms an output;
    ``ops.sparse_ttm_core_device`` gives the same bits, and its empty-tensor
    branch answers in f64."""
    from repro.core.engine import make_engine as jmake_engine

    rng = np.random.default_rng(sum(shape))
    nnz = 900
    idx = np.stack([rng.integers(0, s, nnz) for s in shape], 1).astype(np.int32)
    vals = rng.standard_normal(nnz)
    fs = [np.linalg.qr(rng.standard_normal((s, r)))[0] for s, r in zip(shape, ranks)]
    n = len(shape)
    with jax.enable_x64(True):
        jc = JCOO(jnp.asarray(idx), jnp.asarray(vals), shape)
        jfs = [jnp.asarray(f) for f in fs]
        eng = jmake_engine("xla")
        want = np.asarray(eng.core_update(jc, jfs, eng.mode_unfolding(jc, jfs, n - 1)))
    assert want.dtype == np.float64
    tc = SparseCOO.from_parts(idx, vals, shape)
    tfs = [torch.from_numpy(f) for f in fs]
    sched = DeviceSchedule.from_layout(build_mode_layout(tc, n - 1), tc)
    modes = operand_modes(n, n - 1)
    got = kron_kernel.fused_kron_scatter_ttm(tfs[modes[0]], tfs[modes[1]] if n == 3 else None,
                                             tfs[n - 1], sched, shape[n - 1])
    assert got.dtype == torch.float64 and got.shape == want.shape
    n_terms = nnz  # every nonzero reaches each core entry
    tol = max(1e-13, 4 * n_terms ** 0.5 * 2.0 ** -53) * np.abs(want).max()
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=tol)
    via_ops = ops.sparse_ttm_core_device(tc.indices, tc.values, tfs, n - 1, sched, shape=shape)
    assert torch.equal(via_ops, got)
    empty = SparseCOO.from_parts(np.zeros((0, n), np.int32), np.zeros(0), shape)
    zero = ops.sparse_ttm_core_device(empty.indices, empty.values, tfs, n - 1, None,
                                      shape=shape)
    assert zero.dtype == torch.float64 and not zero.any()
    assert ops.sparse_ttm_core_device(empty.indices, empty.values, tfs, n - 1, None, shape=shape,
                                      precision="bf16_fp32acc").dtype == torch.float32


def test_f64_fuse_core_runs_on_the_cpu():
    """On the CPU the fused core update's plain version computes in f64."""
    ref, _ = _ref_and_port(3, "gram")
    shape, ranks, density = SPARSE[3]
    rng = np.random.default_rng(3)
    nnz = int(np.prod(shape) * density)
    lin = rng.choice(int(np.prod(shape)), nnz, replace=False)
    idx = np.stack(np.unravel_index(lin, shape), 1).astype(np.int32)
    vals = rng.uniform(0.1, 1.0, nnz)
    f0 = [np.linalg.qr(rng.standard_normal((s, r)))[0] for s, r in zip(shape, ranks)]
    from repro_torch.core.engine import make_engine

    spec = tucker.TuckerSpec(shape, ranks, method="gram", n_iter=3, dtype="float64")
    port = tucker.plan(spec, device="cpu", engine=make_engine("torch", "cpu", fuse_core=True))(
        coo_from_numpy(idx, vals, shape), factors_init=factors_from_numpy(f0))
    assert port.core.dtype == torch.float64
    _assert_close(ref, port, 1e-10, 1e-8)


# -- kernel 1's f64 route on the tensor cores (DMMA) ------------------------------

_ROUTES = {  # (kernel, dtype, precision) -> the datapath its CUDA source takes
    ("fused_kron_scatter", "float64", "fp32"): "dmma",
    ("ttm", "float64", "fp32"): "dmma",
    ("fused_kron_scatter_ttm", "float64", "fp32"): "dmma",
    ("fused_kron_chain_scatter", "float64", "fp32"): "cuda_cores",
    ("kron_contrib", "float64", "fp32"): "cuda_cores",
    ("scatter_rows", "float64", "fp32"): "cuda_cores",
    ("fused_kron_scatter", "float32", "fp32"): "3xtf32",
    ("fused_kron_scatter_ttm", "float32", "fp32"): "3xtf32",
    ("fused_kron_chain_scatter", "float32", "fp32"): "3xtf32",
    ("ttm", "float32", "fp32"): "cuda_cores",
    ("kron_contrib", "float32", "fp32"): "cuda_cores",
    ("scatter_rows", "float32", "fp32"): "cuda_cores",
    **{(k, d, "bf16_fp32acc"): route
       for k, route in (("fused_kron_scatter", "bf16_mma"),
                        ("fused_kron_chain_scatter", "2xtf32"),
                        ("fused_kron_scatter_ttm", "bf16_mma"), ("ttm", "cuda_cores"),
                        ("kron_contrib", "cuda_cores"), ("scatter_rows", "cuda_cores"))
       for d in ("float32", "float64")},
}


@pytest.mark.parametrize("kernel,dtype,precision", sorted(_ROUTES))
def test_launch_route_names_each_kernels_datapath(kernel, dtype, precision):
    """Kernels 1, 2 and 5 in f64 at fp32 run on DMMA; under bf16_fp32acc
    kernels 1 and 5 on bf16 m16n8k16 and the chain kernel on 2xTF32; the
    chain kernel in f64, kernel 2 under bf16_fp32acc and kernels 2-4 in f32
    on the CUDA cores; the walk kernels in f32 on 3xTF32."""
    route = kron_kernel.launch_route(kernel, getattr(torch, dtype), precision)
    assert route == _ROUTES[(kernel, dtype, precision)] and route in kron_kernel.ROUTES


@pytest.mark.parametrize("args", [("flash_attention", torch.float32, "fp32"),
                                  ("fused_kron_scatter", torch.bfloat16, "fp32"),
                                  ("fused_kron_scatter", torch.float64, "tf32")])
def test_launch_route_refuses_what_no_kernel_takes(args):
    with pytest.raises(ValueError):
        kron_kernel.launch_route(*args)


def _dmma_model(sched, fa, fb, n_rows, k):
    """Kernel 1's f64 tensor-core arithmetic in numpy: slots in schedule
    order, each row's slots in blocks of ``k`` from the row's first slot;
    A = round(v a), each block's products with b summed in f64, then added
    to the row's f64 sum."""
    idx, v = sched.idx.numpy(), sched.vals.numpy()
    rows = slot_rows(sched).numpy()
    va = v[:, None] * fa.numpy()[idx[:, 0]]
    b = np.ones((idx.shape[0], 1)) if fb is None else fb.numpy()[idx[:, 1]]  # 2-way: ones
    out = np.zeros((n_rows, va.shape[1] * b.shape[1]))
    live = np.flatnonzero(v != 0)  # padding adds nothing, as in the walk
    starts = np.flatnonzero(np.diff(rows[live], prepend=-1))
    for s, e in zip(starts, list(starts[1:]) + [live.size]):
        sl = live[s:e]
        terms = (va[sl, :, None] * b[sl, None, :]).reshape(sl.size, -1)
        acc = np.zeros(terms.shape[1])
        for j in range(0, sl.size, k):
            acc = acc + terms[j:j + k].sum(axis=0)
        out[rows[sl[0]]] = acc
    return out


@pytest.mark.parametrize("signs", ["shared", "mixed"])
@pytest.mark.parametrize("k", [4, 8])
def test_dmma_term_order_within_the_fp64_rule(signs, k):
    """At NELL-2's longest rows (~8.4 K terms a row, ranks 16 x 16) kernel
    1's DMMA arithmetic (one f64 rounding of v a, blocks of k = 8 slots on
    m16n8k8, 4 on m8n8k4) stays within the fp64 rule of the f64 plain
    version, whose terms round round(a b) v: terms of one sign (NELL-2's
    positive values, positive factors) and of both."""
    rng = np.random.default_rng(33 + k)
    shape, per_row = (3, 3000, 3000), 8400
    lin = np.concatenate([r * 9_000_000 + rng.choice(9_000_000, per_row, replace=False)
                          for r in range(shape[0])])
    idx = np.stack(np.unravel_index(lin, shape), 1).astype(np.int32)
    if signs == "shared":
        vals = rng.uniform(0.1, 10.0, lin.size)
        fs = [np.abs(np.linalg.qr(rng.standard_normal((s, 16)))[0]) for s in shape]
    else:
        vals = rng.standard_normal(lin.size)
        fs = [np.linalg.qr(rng.standard_normal((s, 16)))[0] for s in shape]
    coo = SparseCOO.from_parts(idx, vals, shape)
    sched = DeviceSchedule.from_layout(build_mode_layout(coo, 0), coo)
    ma, mb = operand_modes(3, 0)
    fa, fb = torch.from_numpy(fs[ma]), torch.from_numpy(fs[mb])
    want = kron_kernel.fused_kron_scatter_plain(fa, fb, sched, shape[0]).numpy()
    got = _dmma_model(sched, fa, fb, shape[0], k)
    n_terms = per_row
    tol = max(1e-13, 4 * n_terms ** 0.5 * 2.0 ** -53) * np.abs(want).max()
    assert np.abs(got - want).max() <= tol
    assert not np.array_equal(got, want)  # the term order and rounding do differ


# -- kernel 5's f64 route: the walk on DMMA, its rounds on DMMA too --------------


def kernel5_rounds(sched, ra: int, rb: int, held: int, warps: int = 8) -> list:
    """The rows of each of kernel 5's rounds, as ``csrc/kron_scatter_ttm.cu``
    orders them on a card that holds ``held`` of its CTAs at once (CTAs an
    SM x SMs; the first pass's grid of ``kron_scatter_ttm_grid``): CTA x takes
    ``per_cta`` consecutive ranges of ``sched.parts``, its warp w the ranges
    x per_cta + w, + warps, ...; a warp finishes the rows its slots of value
    != 0 reach, in slot order; round j takes every warp's j-th finished row,
    in warp order. Returns, for each CTA in order, its rounds' row lists."""
    rows, v, parts = slot_rows(sched).numpy(), sched.vals.numpy(), sched.parts.numpy()
    n_parts = parts.size - 1
    ctas = min(max(1, held // (-(-ra // 16) * -(-rb // 16))), n_parts)
    per_cta = -(-n_parts // ctas)

    def finished(p):
        r = rows[parts[p]:parts[p + 1]][v[parts[p]:parts[p + 1]] != 0]
        return list(r[np.flatnonzero(np.diff(r, prepend=-1))])

    out = []
    for first in range(0, n_parts, per_cta):
        last = min(first + per_cta, n_parts)
        held = [[row for p in range(first + w, last, warps) for row in finished(p)]
                for w in range(warps)]
        out.append([[h[j] for h in held if j < len(h)] for j in range(max(map(len, held)))])
    return out


def reduce_in_cta_order(partials: list):
    """``kron_scatter_ttm_reduce_kernel``'s sum of the CTA partials: warp w
    sums CTAs w, w + 8, ... in order, then the eight warp sums in order."""
    warp_sums = []
    for w in range(min(8, len(partials))):
        acc = partials[w]
        for c in range(w + 8, len(partials), 8):
            acc = acc + partials[c]
        warp_sums.append(acc)
    out = warp_sums[0]
    for acc in warp_sums[1:]:
        out = out + acc
    return out


def _kernel5_dmma_model(sched, fa, fb, u, n_rows: int, held: int):
    """Kernel 5's f64 route in numpy: Y's rows as kernel 1's DMMA walk sums
    them (``_dmma_model``, blocks of 8), each round's U[row]^T y_row summed
    in warp order and added to its CTA's f64 partial, the partials summed
    by ``reduce_in_cta_order``."""
    y, un = _dmma_model(sched, fa, fb, n_rows, 8), u.numpy()
    rb = 1 if fb is None else fb.shape[1]
    partials = []
    for rounds in kernel5_rounds(sched, fa.shape[1], rb, held):
        acc = np.zeros((un.shape[1], y.shape[1]))
        for held in rounds:
            d = np.zeros_like(acc)
            for row in held:
                d = d + np.outer(un[row], y[row])
            acc = acc + d
        partials.append(acc)
    return reduce_in_cta_order(partials)


KERNEL5_CASES = [  # label, shape, ranks, nnz, modes, slots a range
    ("NELL-2-like rows of ~3,200 slots", (300, 200, 40), (16, 16, 16), 108_000, (2,), 1024),
    ("15g's ranks 13, 17, 10", (100, 80, 60), (13, 17, 10), 5000, (0, 1, 2), 64),
    ("15g's ranks 17, 9, 11", (40, 30, 20), (17, 9, 11), 2500, (0, 1, 2), 64),
    ("R = 17 and R = 1 (not multiples of 8)", (70, 60, 50), (2, 1, 17), 3000, (0, 1, 2), 64),
    ("2-way, ranks 7, 5", (60, 50), (7, 5), 700, (0, 1), 32),
]


def kernel5_case(shape, ranks, nnz: int, seed: int, dtype=np.float64):
    """15g's inputs: uniform coordinates, a fifth of them repeated, normal
    values (uniform positive ones and non-negative factors for the NELL-2-like
    case), orthonormal factors; as (coo, factors) on the CPU."""
    rng = np.random.default_rng(seed)
    idx = np.stack([rng.integers(0, s, nnz) for s in shape], 1)
    idx = np.concatenate([idx, idx[:nnz // 5]]).astype(np.int32)
    positive = nnz >= 100_000
    vals = rng.uniform(0.1, 10.0, idx.shape[0]) if positive else rng.standard_normal(idx.shape[0])
    fs = [np.linalg.qr(rng.standard_normal((s, r)))[0] for s, r in zip(shape, ranks)]
    fs = [np.abs(f) if positive else f for f in fs]
    return (SparseCOO.from_parts(idx, vals.astype(dtype), shape),
            [torch.from_numpy(f.astype(dtype)) for f in fs])


@pytest.mark.parametrize("held", [132, 2])
@pytest.mark.parametrize("label,shape,ranks,nnz,modes,spp", KERNEL5_CASES,
                         ids=[c[0] for c in KERNEL5_CASES])
def test_kernel5_dmma_rounds_within_the_fp64_rule(label, shape, ranks, nnz, modes, spp, held):
    """Kernel 5's f64 arithmetic (the DMMA walk's rows, rounds of one row a
    warp in warp order into each CTA's f64 partial, the partials in CTA
    order) stays within the fp64 rule of the f64 plain version, with an
    H100's 132 CTAs at once (one an SM) and with 2 (every warp then takes
    several ranges, and a round 8 rows)."""
    coo, fs = kernel5_case(shape, ranks, nnz, 35)
    n = len(shape)
    for mode in modes:
        sched = DeviceSchedule.from_layout(build_mode_layout(coo, mode), coo,
                                           slots_per_part=spp)
        m = operand_modes(n, mode)
        fa, fb = fs[m[0]], (fs[m[1]] if n == 3 else None)
        want = kron_kernel.fused_kron_scatter_ttm_plain(fa, fb, fs[mode], sched,
                                                        shape[mode]).numpy()
        got = _kernel5_dmma_model(sched, fa, fb, fs[mode], shape[mode], held)
        tol = max(1e-13, 4 * coo.nnz ** 0.5 * 2.0 ** -53) * np.abs(want).max()
        assert np.abs(got - want).max() <= tol
        if held == 2 and spp < 1024:
            assert max(len(r) for c in kernel5_rounds(sched, fa.shape[1], 1 if fb is None
                                                      else fb.shape[1], 2) for r in c) == 8


# -- kernel 2's f64 split: clusters of 8 CTAs, fixed-order combine ---------------

# (I, L, R, clusters the card holds): NELL-2's core update, NIPS's, I below
# one k-step, two tiles by two with R = 17, a long contraction, a card that
# holds one cluster, one nonzero, and a card with more clusters than needed
CLUSTER_CASES = [(28818, 256, 16, 16), (17, 4096, 16, 16), (10, 15, 3, 16),
                 (1000, 300, 17, 16), (500_000, 256, 16, 16), (28818, 256, 16, 1),
                 (1, 1, 1, 16), (5000, 256, 16, 33)]


@pytest.mark.parametrize("n_i,n_l,n_r,most", CLUSTER_CASES)
def test_ttm_cluster_split_covers_the_contraction_once_in_order(n_i, n_l, n_r, most):
    """Every contraction index in exactly one split, in order; n_splits a
    multiple of the cluster, fewer than a cluster's worth of them empty;
    ranges of whole k-steps (8), about even over the clusters the card
    holds (split over the tiles)."""
    tiles = ttm_kernel.n_tiles(n_l, n_r)
    chunk, n_splits, group = ttm_kernel.split_clusters(n_i, tiles, 8, most)
    assert group == 8 and n_splits % 8 == 0 and chunk % 8 == 0
    ranges = [(a, min(b, n_i)) for a, b in ttm_kernel.ranges(n_i, chunk, n_splits)]
    full = [(a, b) for a, b in ranges if a < b]
    assert full[0][0] == 0 and full[-1][1] == n_i
    assert all(full[s][1] == full[s + 1][0] for s in range(len(full) - 1))
    assert ranges[:len(full)] == full and n_splits - len(full) < 8
    # no more clusters than the card holds; ranges within a k-step of an
    # even share of the contraction over that many CTAs
    n = min(8 * max(1, most // tiles), -(-n_i // 8))
    assert n_splits // 8 <= max(1, most // tiles) and chunk < n_i / n + 8


def _cluster_combine(y, u, most):
    """The f64 kernel's sums in its order: each split's partial over its
    range (zero where empty), each cluster's 8 partials in rank order, the
    clusters in order."""
    tiles = ttm_kernel.n_tiles(y.shape[0], u.shape[0])
    chunk, n_splits, group = ttm_kernel.split_clusters(y.shape[1], tiles, 8, most)
    parts = [y[:, a:b] @ u[:, a:b].T for a, b in ttm_kernel.ranges(y.shape[1], chunk, n_splits)]
    out = torch.zeros_like(parts[0])
    for c0 in range(0, n_splits, group):
        acc = torch.zeros_like(parts[0])
        for p in parts[c0:c0 + group]:
            acc = acc + p
        out = out + acc
    return out


@pytest.mark.parametrize("n_i,n_l,n_r,most", [(28818, 256, 16, 16), (1000, 300, 17, 16),
                                              (17, 64, 16, 16), (5000, 64, 16, 2)])
def test_ttm_cluster_combine_matches_the_product_within_the_fp64_rule(n_i, n_l, n_r, most):
    rng = np.random.default_rng(n_i)
    y = torch.tensor(rng.standard_normal((n_l, n_i)))
    u = torch.tensor(rng.standard_normal((n_r, n_i)))
    want = ttm_kernel.ttm_plain(y, u)
    got = _cluster_combine(y, u, most)
    tol = max(1e-13, 4 * n_i ** 0.5 * 2.0 ** -53) * float(want.abs().max())
    assert float((got - want).abs().max()) <= tol
