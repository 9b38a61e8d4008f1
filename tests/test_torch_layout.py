"""repro_torch sweep schedule: exactly the reference's arrays, and the
unfolding kernel's row-aligned work split (CPU)."""
import numpy as np
import pytest
import torch

from repro.sparse import layout as jlayout
from repro.sparse.generators import random_sparse_tensor as jrandom
from repro_torch.core.coo import SparseCOO
from repro_torch.sparse import layout as tlayout


def _same(got, want):
    if want is None:
        assert got is None
        return
    got = got.numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    assert got.dtype == want.dtype, (got.dtype, want.dtype)
    np.testing.assert_array_equal(got, want)


def _cases():
    rng = np.random.default_rng(0)
    dup = rng.integers(0, 20, size=(300, 3))
    return {
        "empty": (np.zeros((0, 3), np.int64), (10, 12, 9)),
        "nnz_not_multiple_of_bn": (
            np.stack([rng.integers(0, s, 201) for s in (40, 35, 30)], 1), (40, 35, 30)),
        "duplicates": (np.concatenate([dup, dup[:77], dup[:5]]), (20, 20, 20)),
        "one_dense_slice": (
            np.stack([np.full(180, 3), *np.divmod(np.arange(180), 12)], 1), (300, 15, 12)),
    }


@pytest.mark.parametrize("case", list(_cases()))
@pytest.mark.parametrize("bn,bi", [(128, 128), (8, 4)])
def test_build_schedule_exactly_equal(case, bn, bi):
    idx, shape = _cases()[case]
    for mode in range(len(shape)):
        rows = idx[:, mode].astype(np.int64)
        want = jlayout.build_schedule(rows, shape[mode], bn, bi)
        got = tlayout.build_schedule(torch.from_numpy(rows), shape[mode], bn, bi)
        for g, w in zip(got, want):
            if isinstance(w, int):
                assert g == w
            else:
                _same(g, w)


@pytest.mark.parametrize("case", list(_cases()))
def test_build_mode_layout_exactly_equal(case):
    idx, shape = _cases()[case]
    idx = idx.astype(np.int32)
    vals = np.ones(idx.shape[0], np.float32)
    from repro.core.coo import SparseCOO as JCOO

    jc = JCOO.from_parts(idx, vals, shape)
    tc = SparseCOO.from_parts(idx, vals, shape)
    for mode in range(len(shape)):
        w = jlayout.build_mode_layout(jc, mode, bn=16, bi=8)
        g = tlayout.build_mode_layout(tc, mode, bn=16, bi=8)
        for f in ("order", "valid", "rel_row", "blkmap", "first", "last",
                  "segments", "row_mask"):
            _same(getattr(g, f), getattr(w, f))
        assert (g.n_row_blocks, g.bn, g.bi, g.mode, g.shape) == (
            w.n_row_blocks, w.bn, w.bi, w.mode, w.shape)


@pytest.mark.parametrize("n_parts", [1, 3, 17, 1000])
@pytest.mark.parametrize("seed", [0, 1])
def test_row_parts_never_split_a_row(n_parts, seed):
    """The invariants the CUDA unfolding kernel relies on: every range starts
    at a row's first real slot, no row spans two ranges, and each padding
    slot follows a real slot of its own group within its range."""
    coo = jrandom((60, 500, 7), 0.004, seed=seed)
    tc = SparseCOO.from_parts(np.asarray(coo.indices), np.asarray(coo.values), coo.shape)
    for mode in range(3):
        lay = tlayout.build_mode_layout(tc, mode, bn=8, bi=16)
        parts = tlayout.row_parts(lay, n_parts).numpy()
        rows = tlayout.slot_rows(lay).numpy()
        real = lay.valid.numpy() > 0
        assert parts[0] == 0 and parts[-1] == lay.nnz_padded
        assert np.all(np.diff(parts) > 0) and len(parts) - 1 <= n_parts
        owner = np.searchsorted(parts, np.arange(lay.nnz_padded), side="right") - 1
        for r in np.unique(rows[real]):
            assert len(np.unique(owner[real & (rows == r)])) == 1
        for s, e in zip(parts[:-1], parts[1:]):
            assert real[s]
            seen = rows[s]
            for t in range(s, e):
                if real[t]:
                    assert rows[t] >= seen
                    seen = rows[t]
                else:  # padding: value 0, row not above the current one
                    assert rows[t] <= seen


def test_device_schedule_from_layout():
    coo = jrandom((30, 20, 10), 0.02, seed=4)
    tc = SparseCOO.from_parts(np.asarray(coo.indices), np.asarray(coo.values), coo.shape)
    lay = tlayout.build_mode_layout(tc, 1)
    ds = tlayout.DeviceSchedule.from_layout(lay, tc, "cpu")
    assert ds.order is lay.order  # already on the device: no copy
    assert ds.parts[0] == 0 and ds.parts[-1] == lay.nnz_padded
    assert (ds.n_row_blocks, ds.bn, ds.bi) == (lay.n_row_blocks, 128, 128)
