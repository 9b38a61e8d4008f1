"""repro_torch kernel modules on the CPU: the plain versions of the two CUDA
kernels against the reference's Pallas kernels in interpret mode, the
schedule-order gather, and the unfolding against the dense oracle."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import kron as jkron
from repro.core.coo import SparseCOO as JCOO
from repro.kernels import ops as jops
from repro.kernels.kron_kernel import fused_kron_scatter_pallas
from repro.kernels.ttm_kernel import ttm_pallas
from repro.sparse.layout import build_mode_layout as jbuild
from repro_torch.core import kron as tkron
from repro_torch.core.coo import SparseCOO, unfold_dense
from repro_torch.core.ttm import ttm_chain
from repro_torch.kernels import kron_kernel, ops, ttm_kernel
from repro_torch.sparse.layout import DeviceSchedule, build_mode_layout, operand_modes

# fp32: both sides form the same rounded terms and differ only in the order
# of f32 sums (one-hot MXU dot vs index_add_). bf16_fp32acc: XLA's CPU
# backend may fuse the bf16 product with its f32 widening and skip the bf16
# rounding the port applies, one bf16 ulp (2^-8 relative) per term.
TOL = {"fp32": 1e-5, "bf16_fp32acc": 1e-2}


def _inputs(shape, ranks, density=0.02, seed=0, pad=0):
    rng = np.random.default_rng(seed)
    nnz = max(1, int(np.prod(shape) * density))
    idx = np.stack([rng.integers(0, s, nnz) for s in shape], 1).astype(np.int32)
    vals = rng.standard_normal(nnz).astype(np.float32)
    if pad:
        idx = np.concatenate([idx, np.zeros((pad, len(shape)), np.int32)])
        vals = np.concatenate([vals, np.zeros(pad, np.float32)])
    fs = [rng.standard_normal((s, r)).astype(np.float32) for s, r in zip(shape, ranks)]
    return idx, vals, fs


def _close(got, want, tol):
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * max(np.abs(want).max(), 1e-30))


@pytest.mark.parametrize("precision", ["fp32", "bf16_fp32acc"])
@pytest.mark.parametrize("shape,ranks,pad", [
    ((40, 35, 30), (5, 4, 3), 0),
    ((33, 9, 300), (3, 5, 2), 19),   # nnz not a BN multiple, zero padding rows
    ((300, 40), (6, 4), 0),          # 2-way: b is a ones column
])
def test_fused_kron_scatter_plain_matches_pallas(shape, ranks, pad, precision):
    """Kernel 1 takes the two non-mode factor matrices and the schedule and
    gathers the rows itself; the reference kernel is fed the rows gathered
    in numpy from the reference's own schedule."""
    idx, vals, fs = _inputs(shape, ranks, pad=pad)
    jc = JCOO.from_parts(idx, vals, shape)
    tc = SparseCOO.from_parts(idx, vals, shape)
    jfs = [jnp.asarray(f) for f in fs]
    tfs = [torch.from_numpy(f) for f in fs]
    n = len(shape)
    for mode in range(n):
        jlay = jbuild(jc, mode, bn=16, bi=8)
        sched = DeviceSchedule.from_layout(build_mode_layout(tc, mode, bn=16, bi=8), tc)
        jrows, jv = jops._gathered_block_rows(jc.indices, jc.values, jfs, mode, jlay, n)
        order = np.asarray(jlay.order)
        modes = operand_modes(n, mode)
        rows = [fs[t][idx[order, t]] for t in modes]  # numpy gather
        if n == 2:
            rows.append(np.ones((order.size, 1), np.float32))
        for r, j in zip(rows, jrows):
            np.testing.assert_array_equal(r, np.asarray(j))
        want = fused_kron_scatter_pallas(*(jnp.asarray(r) for r in rows), jv, jlay,
                                         shape[mode], interpret=True, precision=precision)
        before = kron_kernel.fused_kron_scatter.launches
        got = kron_kernel.fused_kron_scatter(tfs[modes[0]], tfs[modes[1]] if n == 3 else None,
                                             sched, shape[mode], precision=precision)
        assert kron_kernel.fused_kron_scatter.launches == before  # CPU: no launch
        assert got.dtype == torch.float32 and tuple(got.shape) == tuple(want.shape)
        _close(got.numpy(), want, TOL[precision])
        # the row-gathering operands of the other paths: the reference's rows
        trows, tv = ops._gathered_block_rows(tc.indices, tc.values, tfs, mode, sched, n)
        for j, t in zip(jrows, trows):
            np.testing.assert_array_equal(t.numpy(), np.asarray(j))
        np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))


@pytest.mark.parametrize("shape,pad", [((40, 35, 30), 0), ((33, 9, 300), 19), ((300, 40), 0),
                                       ((9, 8, 7, 6), 5)])
def test_device_schedule_caches_slot_coordinates_and_values(shape, pad):
    """``sched.idx`` is ``indices[order]`` without the mode's column, in
    descending mode order; ``sched.vals`` is ``values[order] * valid``."""
    idx, vals, _ = _inputs(shape, (2,) * len(shape), pad=pad)
    tc = SparseCOO.from_parts(idx, vals, shape)
    for mode in range(len(shape)):
        lay = build_mode_layout(tc, mode, bn=16, bi=8)
        sched = DeviceSchedule.from_layout(lay, tc)
        order = lay.order.long()
        want = tc.indices[order][:, list(operand_modes(len(shape), mode))]
        assert sched.idx.dtype == torch.int32 and sched.idx.is_contiguous()
        assert torch.equal(sched.idx, want)
        assert torch.equal(sched.vals, tc.values[order] * lay.valid)
        assert not sched.vals[lay.valid == 0].any()
        other = torch.from_numpy(np.arange(tc.nnz, dtype=np.float32))
        assert torch.equal(sched.with_values(other).vals, other[order] * lay.valid)


def test_engine_refreshes_slot_values_for_new_values():
    """A tensor with the same coordinates and other values keeps the cached
    schedules (no new sort) and gets its own slot values."""
    from repro_torch.core.engine import make_engine

    shape = (20, 15, 12)
    idx, vals, fs = _inputs(shape, (3, 2, 4), density=0.05)
    tc = SparseCOO.from_parts(idx, vals, shape)
    tc2 = SparseCOO(tc.indices, tc.values * 2 + 1, shape)
    tfs = [torch.from_numpy(f) for f in fs]
    eng = make_engine("torch", "cpu")
    eng.mode_unfolding(tc, tfs, 1)
    builds = eng.schedule_builds
    got = eng.mode_unfolding(tc2, tfs, 1)
    assert eng.schedule_builds == builds
    want = make_engine("torch", "cpu").mode_unfolding(tc2, tfs, 1)
    assert torch.equal(got, want)


def test_engine_refreshes_slot_values_written_in_place():
    """Values written in place (the same tensor object) are seen by the next
    call, with the cached schedules kept."""
    from repro_torch.core.engine import make_engine

    shape = (20, 15, 12)
    idx, vals, fs = _inputs(shape, (3, 2, 4), density=0.05)
    tc = SparseCOO.from_parts(idx, vals, shape)
    tfs = [torch.from_numpy(f) for f in fs]
    eng = make_engine("torch", "cpu")
    before = eng.mode_unfolding(tc, tfs, 0)
    builds = eng.schedule_builds
    tc.values.mul_(3).add_(1)
    got = eng.mode_unfolding(tc, tfs, 0)
    assert eng.schedule_builds == builds
    want = make_engine("torch", "cpu").mode_unfolding(tc, tfs, 0)
    assert torch.equal(got, want) and not torch.equal(got, before)


@pytest.mark.parametrize("precision", ["fp32", "bf16_fp32acc"])
@pytest.mark.parametrize("l,i,r,transposed", [
    (256, 300, 16, True), (15, 1000, 3, True), (100, 300, 17, False), (8, 8, 8, False)])
def test_ttm_plain_matches_pallas(l, i, r, transposed, precision):
    rng = np.random.default_rng(1)
    if transposed:  # the sweep's views: y = Y_(N)^T, u = U_N^T
        y_t = torch.from_numpy(rng.standard_normal((i, l)).astype(np.float32)).T
        u_t = torch.from_numpy(rng.standard_normal((i, r)).astype(np.float32)).T
    else:
        y_t = torch.from_numpy(rng.standard_normal((l, i)).astype(np.float32))
        u_t = torch.from_numpy(rng.standard_normal((r, i)).astype(np.float32))
    want = ttm_pallas(jnp.asarray(y_t.numpy()), jnp.asarray(u_t.numpy()), interpret=True,
                      precision=precision)
    before = ttm_kernel.ttm.launches
    got = ttm_kernel.ttm(y_t, u_t, precision=precision)
    assert ttm_kernel.ttm.launches == before and got.dtype == torch.float32
    _close(got.numpy(), want, TOL[precision])
    assert ops.ttm is ttm_kernel.ttm


@pytest.mark.parametrize("precision", ["fp32", "bf16_fp32acc"])
def test_sparse_ttm_chain_matches_reference_and_dense_oracle(precision):
    shape, ranks = (12, 10, 8), (3, 4, 2)
    idx, vals, fs = _inputs(shape, ranks, density=0.1, seed=2)
    jc = JCOO.from_parts(idx, vals, shape)
    tc = SparseCOO.from_parts(idx, vals, shape)
    tfs = [torch.from_numpy(f) for f in fs]
    dense = tc.to_dense()
    for mode in range(3):
        want = jkron.sparse_ttm_chain(jc, [jnp.asarray(f) for f in fs], mode,
                                      precision=precision)
        got = tkron.sparse_ttm_chain(tc, tfs, mode, precision=precision)
        _close(got.numpy(), want, TOL[precision])
        sched = DeviceSchedule.from_layout(build_mode_layout(tc, mode), tc)
        dev = ops.sparse_ttm_chain_device(tc.indices, tc.values, tfs, mode, sched,
                                          shape=shape, precision=precision)
        _close(dev.numpy(), got.numpy(), TOL[precision])
        if precision == "fp32":
            oracle = unfold_dense(ttm_chain(dense, tfs, skip=mode), mode)
            _close(got.numpy(), oracle.numpy(), 1e-5)


def test_empty_tensor_unfolding_is_zero():
    tfs = [torch.randn(s, r) for s, r in zip((5, 6, 7), (2, 3, 4))]
    tc = SparseCOO.from_parts(np.zeros((0, 3), np.int32), np.zeros(0, np.float32), (5, 6, 7))
    sched = DeviceSchedule.from_layout(build_mode_layout(tc, 1), tc)
    y = ops.sparse_ttm_chain_device(tc.indices, tc.values, tfs, 1, sched, shape=(5, 6, 7))
    assert tuple(y.shape) == (6, 8) and not y.any()
    assert not tkron.sparse_ttm_chain(tc, tfs, 2).any()


def test_order_four_unfolding_raises():
    """Order 4 no longer raises: the chained unfolding (kron_contrib twice,
    then scatter_rows) matches the reference's XLA unfolding on every mode,
    including a one-nonzero tensor."""
    shape, ranks = (6, 5, 4, 3), (2, 3, 2, 2)
    idx, vals, fs = _inputs(shape, ranks, density=0.1, seed=4, pad=3)
    for i, v in ((idx, vals), (np.zeros((1, 4), np.int32), np.ones(1, np.float32))):
        jc, tc = JCOO.from_parts(i, v, shape), SparseCOO.from_parts(i, v, shape)
        tfs = [torch.from_numpy(f) for f in fs]
        for mode in range(4):
            sched = DeviceSchedule.from_layout(build_mode_layout(tc, mode), tc)
            got = ops.sparse_ttm_chain_device(tc.indices, tc.values, tfs, mode, sched,
                                              shape=shape)
            want = jkron.sparse_ttm_chain(jc, [jnp.asarray(f) for f in fs], mode)
            assert got.dtype == torch.float32
            _close(got.numpy(), want, TOL["fp32"])


def test_every_kernel_source_is_built():
    from repro_torch.kernels import _build

    assert sorted(_build.SOURCES) == sorted(p.stem for p in _build.CSRC.glob("*.cu"))
    for name in _build.SOURCES:  # each source names the TPU kernel it replaces
        assert "Replaces: src/repro/kernels/" in (_build.CSRC / f"{name}.cu").read_text()


def test_precision_is_validated():
    with pytest.raises(ValueError, match="precision"):
        kron_kernel._cast_operands("fp16", torch.zeros(1))


# -- kernel 2's work split: one launch, fixed-order combine -------------------

# (I, L, R, SMs): NELL-2's core update (Y_(2)^T is (256, 28,818)), NIPS's
# ((4,096, 17) by (16, 17)), I below one staging step, L not a tile
# multiple with R = 17, a long contraction, and a card with few SMs
SPLIT_CASES = [(28818, 256, 16, 132), (17, 4096, 16, 132), (10, 15, 3, 132),
               (1000, 300, 17, 132), (300, 100, 17, 132), (500_000, 256, 16, 132),
               (28818, 256, 16, 7), (1, 1, 1, 132), (33, 8, 8, 132)]


@pytest.mark.parametrize("n_i,n_l,n_r,n_sm", SPLIT_CASES)
def test_ttm_split_covers_the_contraction_once_in_order(n_i, n_l, n_r, n_sm):
    tiles = ttm_kernel.n_tiles(n_l, n_r)
    chunk, n_splits, group = ttm_kernel.split(n_i, tiles, n_sm)
    ranges = ttm_kernel.ranges(n_i, chunk, n_splits)
    assert ranges[0][0] == 0 and ranges[-1][1] == n_i
    assert all(a < b for a, b in ranges)  # no empty split
    assert all(ranges[s][1] == ranges[s + 1][0] for s in range(n_splits - 1))
    assert all(b - a == chunk and chunk % ttm_kernel._BT == 0 for a, b in ranges[:-1])
    # about one CTA per SM, and never fewer than one per tile
    assert tiles * n_splits <= max(n_sm, tiles)
    assert n_splits == 1 or tiles * n_splits > n_sm // 2 or n_i <= n_sm * ttm_kernel._BT
    # groups of consecutive splits, the last one possibly short
    n_groups = -(-n_splits // group)
    assert 1 <= group <= n_splits and (n_groups - 1) * group < n_splits <= n_groups * group
    assert group * group >= n_splits


def _combine(y, u, n_sm):
    """The kernel's sums in its order, in f32: each split's partial over its
    range, each group's partials in split order, the groups in order."""
    tiles = ttm_kernel.n_tiles(y.shape[0], u.shape[0])
    chunk, n_splits, group = ttm_kernel.split(y.shape[1], tiles, n_sm)
    parts = [y[:, a:b] @ u[:, a:b].T for a, b in ttm_kernel.ranges(y.shape[1], chunk, n_splits)]
    groups = []
    for g0 in range(0, n_splits, group):
        acc = torch.zeros_like(parts[0])
        for p in parts[g0:g0 + group]:
            acc = acc + p
        groups.append(acc)
    out = torch.zeros_like(parts[0])
    for g in groups:
        out = out + g
    return out


@pytest.mark.parametrize("n_i,n_l,n_r,n_sm", [(28818, 256, 16, 132), (1000, 300, 17, 132),
                                              (17, 4096, 16, 132), (5000, 64, 16, 12)])
def test_ttm_fixed_order_combine_matches_the_product(n_i, n_l, n_r, n_sm):
    """The split's partial products summed in the kernel's order give the
    plain product to the fp32 rule (n terms per output, reordered), and the
    same bits on every evaluation."""
    rng = np.random.default_rng(3)
    y = torch.from_numpy(rng.standard_normal((n_i, n_l)).astype(np.float32)).T
    u = torch.from_numpy(rng.standard_normal((n_i, n_r)).astype(np.float32)).T
    got = _combine(y, u, n_sm)
    assert torch.equal(got, _combine(y, u, n_sm))
    want = ttm_kernel.ttm_plain(y, u)
    _close(got.numpy(), want.numpy(), max(1e-5, 4 * np.sqrt(n_i) * 2.0 ** -24))


def test_ttm_bulk_copies_rule():
    """Bulk copies on the sweep's views (each contraction index a unit-stride
    row of y and u, 16-byte rows); the strided staging otherwise."""
    y = torch.zeros((28818, 256)).T
    u = torch.zeros((28818, 16)).T
    assert ttm_kernel.bulk_copies(y, u)
    assert ttm_kernel.bulk_copies(y.bfloat16(), u.bfloat16())
    assert ttm_kernel.bulk_copies(torch.zeros((17, 4096)).T, torch.zeros((17, 16)).T)
    assert not ttm_kernel.bulk_copies(torch.zeros((1000, 15)).T, torch.zeros((1000, 3)).T)
    assert not ttm_kernel.bulk_copies(torch.zeros((100, 300)), torch.zeros((17, 300)))
    assert not ttm_kernel.bulk_copies(torch.zeros((300, 100)).T, torch.zeros((300, 17)).T)
