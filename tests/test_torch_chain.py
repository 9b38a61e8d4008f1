"""repro_torch order >= 4 unfolding and fused core update on the CPU: the
plain versions of the kron_contrib, scatter_rows and fused_kron_scatter_ttm
kernels against the reference's Pallas kernels in interpret mode, and the
chained unfolding against the reference and the dense oracle."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.coo import SparseCOO as JCOO
from repro.kernels import ops as jops
from repro.kernels.kron_kernel import (fused_kron_scatter_ttm_pallas, kron_contrib_pallas,
                                       scatter_rows_pallas)
from repro.sparse.layout import build_mode_layout as jbuild
from repro_torch.core.coo import SparseCOO, unfold_dense
from repro_torch.core.engine import make_engine
from repro_torch.core.ttm import ttm_chain
from repro_torch.kernels import kron_kernel, ops
from repro_torch.sparse.layout import DeviceSchedule, build_mode_layout, operand_modes

# fp32: both sides form the same rounded terms and differ only in the order
# of f32 sums (one-hot MXU dot vs index_add_ or a matrix product).
# bf16_fp32acc: XLA's CPU backend may fuse the bf16 product with its f32
# widening and skip the bf16 rounding the port applies, one bf16 ulp
# (2^-8 relative) per term.
TOL = {"fp32": 1e-5, "bf16_fp32acc": 1e-2}


def _close(got, want, tol):
    want = np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * max(np.abs(want).max(), 1e-30))


def _coo_pair(idx, vals, shape):
    return (JCOO.from_parts(idx, vals, shape), SparseCOO.from_parts(idx, vals, shape))


def _random(shape, nnz, seed):
    rng = np.random.default_rng(seed)
    idx = np.stack([rng.integers(0, s, nnz) for s in shape], 1).astype(np.int32)
    return idx, rng.standard_normal(nnz).astype(np.float32), rng


def _alias_case():
    """Row 0 of the first 8-row group holds most of its nonzeros, then rows
    3 and 5; the group's count is no multiple of BN = 16, so its padding
    slots (which alias row 0) sit after row 5, far from row 0's slots. Rows
    8-15 (the second group) hold nothing, so one row block is unvisited."""
    rng = np.random.default_rng(7)
    rows = np.concatenate([np.zeros(37, np.int64), np.full(5, 3), np.full(4, 5),
                           rng.integers(16, 30, 25)])
    idx = np.stack([rows, rng.integers(0, 9, rows.size), rng.integers(0, 7, rows.size)], 1)
    return idx.astype(np.int32), rng.standard_normal(rows.size).astype(np.float32), (30, 9, 7)


def _gathered(jc, tc, fs, mode, bn, bi):
    n = len(tc.shape)
    jlay = jbuild(jc, mode, bn=bn, bi=bi)
    sched = DeviceSchedule.from_layout(build_mode_layout(tc, mode, bn=bn, bi=bi), tc)
    jrows, jv = jops._gathered_block_rows(jc.indices, jc.values, [jnp.asarray(f) for f in fs],
                                          mode, jlay, n)
    trows, tv = ops._gathered_block_rows(tc.indices, tc.values,
                                         [torch.from_numpy(f) for f in fs], mode, sched, n)
    return jlay, sched, jrows, jv, trows, tv


@pytest.mark.parametrize("precision", ["fp32", "bf16_fp32acc"])
@pytest.mark.parametrize("nnz,ra,rb", [(203, 5, 3), (64, 16, 16), (37, 33, 40), (9, 1, 7)])
def test_kron_contrib_plain_matches_pallas(nnz, ra, rb, precision):
    rng = np.random.default_rng(nnz + ra)
    a = rng.standard_normal((nnz, ra)).astype(np.float32)
    b = rng.standard_normal((nnz, rb)).astype(np.float32)
    v = rng.standard_normal(nnz).astype(np.float32)
    want = kron_contrib_pallas(jnp.asarray(a), jnp.asarray(b), jnp.asarray(v), interpret=True,
                               precision=precision)
    before = kron_kernel.kron_contrib.launches
    got = ops.kron_contrib(torch.from_numpy(a), torch.from_numpy(b), torch.from_numpy(v),
                           precision=precision)
    assert kron_kernel.kron_contrib.launches == before  # CPU: no launch
    assert got.dtype == torch.float32
    _close(got.numpy(), want, TOL[precision])
    if precision == "fp32":  # the same two roundings, a*b then *v
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("bn,bi", [(16, 8), (128, 128)])
@pytest.mark.parametrize("case", ["random", "alias_and_unvisited"])
def test_scatter_rows_plain_matches_pallas(case, bn, bi):
    if case == "random":
        shape = (41, 9, 300)
        idx, vals, rng = _random(shape, 500, 3)
    else:
        idx, vals, shape = _alias_case()
        rng = np.random.default_rng(8)
    fs = [rng.standard_normal((s, r)).astype(np.float32) for s, r in zip(shape, (4, 3, 5))]
    jc, tc = _coo_pair(idx, vals, shape)
    for mode in range(3):
        jlay, sched, jrows, jv, trows, tv = _gathered(jc, tc, fs, mode, bn, bi)
        jcontrib = kron_contrib_pallas(*jrows, jv, interpret=True)
        tcontrib = ops.kron_contrib(*trows, tv)
        np.testing.assert_array_equal(tcontrib.numpy(), np.asarray(jcontrib))
        want = scatter_rows_pallas(jcontrib, jlay, shape[mode], interpret=True)
        before = kron_kernel.scatter_rows.launches
        got = kron_kernel.scatter_rows(tcontrib, sched, shape[mode])
        assert kron_kernel.scatter_rows.launches == before
        _close(got.numpy(), want, TOL["fp32"])
        if sched.row_mask is not None:  # unvisited row blocks come back zero
            assert not got.numpy()[~sched.row_mask.numpy()].any()


@pytest.mark.parametrize("precision", ["fp32", "bf16_fp32acc"])
@pytest.mark.parametrize("case", ["random", "alias_and_unvisited", "two_way"])
def test_fused_kron_scatter_ttm_plain_matches_pallas(case, precision):
    if case == "random":
        shape, ranks = (40, 35, 30), (5, 4, 3)
        idx, vals, rng = _random(shape, 420, 4)
    elif case == "two_way":
        shape, ranks = (60, 25), (6, 4)
        idx, vals, rng = _random(shape, 300, 5)
    else:
        (idx, vals, shape), ranks = _alias_case(), (4, 3, 5)
        rng = np.random.default_rng(9)
    fs = [rng.standard_normal((s, r)).astype(np.float32) for s, r in zip(shape, ranks)]
    jc, tc = _coo_pair(idx, vals, shape)
    for mode in range(len(shape)):
        jlay, sched, jrows, jv, _, _ = _gathered(jc, tc, fs, mode, 16, 8)
        want = fused_kron_scatter_ttm_pallas(*jrows, jv, jnp.asarray(fs[mode]), jlay,
                                             shape[mode], interpret=True, precision=precision)
        # the port reads the factor rows through the schedule
        modes = operand_modes(len(shape), mode)
        fa = torch.from_numpy(fs[modes[0]])
        fb = torch.from_numpy(fs[modes[1]]) if len(modes) > 1 else None
        before = kron_kernel.fused_kron_scatter_ttm.launches
        got = kron_kernel.fused_kron_scatter_ttm(fa, fb, torch.from_numpy(fs[mode]), sched,
                                                 shape[mode], precision=precision)
        assert kron_kernel.fused_kron_scatter_ttm.launches == before
        assert got.dtype == torch.float32
        _close(got.numpy(), want, TOL[precision])
    # the ops entry point, on the last mode as the engine's core update calls it
    n = len(shape)
    sched = DeviceSchedule.from_layout(build_mode_layout(tc, n - 1), tc)
    g = ops.sparse_ttm_core_device(tc.indices, tc.values, [torch.from_numpy(f) for f in fs],
                                   n - 1, sched, shape=shape, precision=precision)
    want = jops.sparse_ttm_core_device(jc.indices, jc.values, [jnp.asarray(f) for f in fs],
                                       n - 1, jbuild(jc, n - 1), shape=shape, interpret=True,
                                       precision=precision)
    _close(g.numpy(), want, TOL[precision])


@pytest.mark.parametrize("precision", ["fp32", "bf16_fp32acc"])
@pytest.mark.parametrize("shape,ranks", [((60, 25), (6, 4)), ((40, 35, 30), (5, 4, 3))])
def test_fused_core_update_gathers_no_operand_rows(shape, ranks, precision):
    """The 2- and 3-way core update hands the megakernel the factor
    matrices: no (nnz, R) gather, and the reference's core on every mode."""
    idx, vals, rng = _random(shape, 350, 14)
    fs = [rng.standard_normal((s, r)).astype(np.float32) for s, r in zip(shape, ranks)]
    jc, tc = _coo_pair(idx, vals, shape)
    for mode in range(len(shape)):
        sched = DeviceSchedule.from_layout(build_mode_layout(tc, mode), tc)
        before = ops._gathered_block_rows.calls
        g = ops.sparse_ttm_core_device(tc.indices, tc.values, [torch.from_numpy(f) for f in fs],
                                       mode, sched, shape=shape, precision=precision)
        assert ops._gathered_block_rows.calls == before
        want = jops.sparse_ttm_core_device(jc.indices, jc.values, [jnp.asarray(f) for f in fs],
                                           mode, jbuild(jc, mode), shape=shape, interpret=True,
                                           precision=precision)
        _close(g.numpy(), want, TOL[precision])


@pytest.mark.parametrize("precision", ["fp32", "bf16_fp32acc"])
@pytest.mark.parametrize("shape,ranks", [
    ((9, 8, 7, 6), (3, 2, 4, 2)),
    ((7, 6, 5, 4, 3), (2, 3, 2, 2, 2)),
])
def test_chain_matches_reference_and_dense_oracle(shape, ranks, precision):
    idx, vals, rng = _random(shape, 150, len(shape))
    fs = [rng.standard_normal((s, r)).astype(np.float32) for s, r in zip(shape, ranks)]
    jc, tc = _coo_pair(idx, vals, shape)
    tfs = [torch.from_numpy(f) for f in fs]
    dense = tc.to_dense()
    for mode in range(len(shape)):
        jlay = jbuild(jc, mode)
        want = jops.sparse_ttm_chain_device(jc.indices, jc.values, [jnp.asarray(f) for f in fs],
                                            mode, jlay, shape=shape, interpret=True,
                                            precision=precision)
        sched = DeviceSchedule.from_layout(build_mode_layout(tc, mode), tc)
        got = ops.sparse_ttm_chain_device(tc.indices, tc.values, tfs, mode, sched, shape=shape,
                                          precision=precision)
        _close(got.numpy(), want, TOL[precision])
        if precision == "fp32":
            oracle = unfold_dense(ttm_chain(dense, tfs, skip=mode), mode)
            _close(got.numpy(), oracle.numpy(), 1e-5)
        # the order > 3 core update: the chain, then the TTM kernel
        g = ops.sparse_ttm_core_device(tc.indices, tc.values, tfs, mode, sched, shape=shape,
                                       precision=precision)
        want_g = jops.sparse_ttm_core_device(jc.indices, jc.values,
                                             [jnp.asarray(f) for f in fs], mode, jlay,
                                             shape=shape, interpret=True, precision=precision)
        _close(g.numpy(), want_g, TOL[precision])


@pytest.mark.parametrize("precision", ["fp32", "bf16_fp32acc"])
def test_unfused_three_way_chain_matches_fused(precision):
    shape = (30, 20, 25)
    idx, vals, rng = _random(shape, 400, 6)
    tc = SparseCOO.from_parts(idx, vals, shape)
    tfs = [torch.from_numpy(rng.standard_normal((s, 4)).astype(np.float32)) for s in shape]
    jc = JCOO.from_parts(idx, vals, shape)
    for mode in range(3):
        sched = DeviceSchedule.from_layout(build_mode_layout(tc, mode), tc)
        kw = dict(shape=shape, precision=precision)
        fused = ops.sparse_ttm_chain_device(tc.indices, tc.values, tfs, mode, sched, **kw)
        split = ops.sparse_ttm_chain_device(tc.indices, tc.values, tfs, mode, sched,
                                            fused=False, **kw)
        _close(split.numpy(), fused.numpy(), TOL["fp32"])
        want = jops.sparse_ttm_chain_device(jc.indices, jc.values,
                                            [jnp.asarray(f.numpy()) for f in tfs], mode,
                                            jbuild(jc, mode), interpret=True, fused=False,
                                            **kw)
        _close(split.numpy(), want, TOL[precision])


@pytest.mark.parametrize("shape,ranks", [((20, 15, 12), (4, 3, 5)), ((9, 8, 7, 6), (3, 2, 4, 2))])
def test_engine_fused_core_update_matches_the_split_one(shape, ranks):
    """``SweepEngine.core_update`` with ``fuse_core``: the megakernel's plain
    version on a 3-way tensor, and on higher orders the TTM of the Y_(N)
    the sweep already built (the very split path, so bit for bit)."""
    idx, vals, rng = _random(shape, 300, 12)
    tc = SparseCOO.from_parts(idx, vals, shape)
    fs = [torch.from_numpy(rng.standard_normal((s, r)).astype(np.float32))
          for s, r in zip(shape, ranks)]
    split, fused = make_engine("torch", "cpu"), make_engine("torch", "cpu", fuse_core=True)
    y_n = split.mode_unfolding(tc, fs, len(shape) - 1)
    want = split.core_update(tc, fs, y_n)
    got = fused.core_update(tc, fs, y_n)
    _close(got.numpy(), want.numpy(), TOL["fp32"])
    if len(shape) > 3:
        assert torch.equal(got, want)


@pytest.mark.parametrize("call", ["kron_contrib", "scatter_rows", "fused_kron_scatter_ttm",
                                  "fused_kron_chain_scatter"])
def test_wrappers_never_fall_back_off_the_cpu(call):
    """A tensor that is not on the CPU goes to the kernel or raises; the
    plain version is never its fallback."""
    m = torch.device("meta")
    a, b, v = torch.zeros(4, 2, device=m), torch.zeros(4, 3, device=m), torch.zeros(4, device=m)
    with pytest.raises(ValueError, match=f"{call}: unsupported device meta"):
        if call == "kron_contrib":
            kron_kernel.kron_contrib(a, b, v)
        elif call == "scatter_rows":
            kron_kernel.scatter_rows(torch.zeros(4, 6, device=m), None, 3)
        elif call == "fused_kron_chain_scatter":
            kron_kernel.fused_kron_chain_scatter([a, b, torch.zeros(5, 2, device=m)], None, 3)
        else:
            kron_kernel.fused_kron_scatter_ttm(a, b, torch.zeros(3, 2, device=m), None, 3)
