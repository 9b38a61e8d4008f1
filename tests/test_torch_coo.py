"""repro_torch COO type, unfoldings, generators and dense math against the
JAX package on the same numpy inputs (CPU)."""
import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.sparse import generators as jgen
from repro_torch.core import coo as tcoo
from repro_torch.core import reconstruct as trec
from repro_torch.sparse import generators as tgen

# repro.core re-exports functions named like its submodules (ttm, ...).
jcoo = importlib.import_module("repro.core.coo")
jrec = importlib.import_module("repro.core.reconstruct")
jttm = importlib.import_module("repro.core.ttm")
# repro_torch.core re-exports the function ttm under the module's name
tttm = importlib.import_module("repro_torch.core.ttm")


@pytest.mark.parametrize("shape", [(4, 5, 6), (3, 7), (2, 3, 4, 5)])
def test_unfold_fold_match_reference(shape):
    x = np.random.default_rng(0).standard_normal(shape).astype(np.float32)
    for mode in range(len(shape)):
        want = np.asarray(jcoo.unfold_dense(jnp.asarray(x), mode))
        got = tcoo.unfold_dense(torch.from_numpy(x), mode)
        np.testing.assert_array_equal(got.numpy(), want)
        back = tcoo.fold_dense(got, mode, shape)
        np.testing.assert_array_equal(back.numpy(), x)


@pytest.mark.parametrize("dist", ["normal", "uniform", "binary", "counts"])
def test_random_sparse_tensor_identical_arrays(dist):
    j = jgen.random_sparse_tensor((30, 20, 25), 0.01, seed=5, value_dist=dist)
    t = tgen.random_sparse_tensor((30, 20, 25), 0.01, seed=5, value_dist=dist)
    np.testing.assert_array_equal(t.indices.numpy(), np.asarray(j.indices))
    np.testing.assert_array_equal(t.values.numpy(), np.asarray(j.values))
    assert t.shape == j.shape and t.indices.dtype == torch.int32


def test_low_rank_sparse_tensor_identical_arrays():
    j, jt = jgen.low_rank_sparse_tensor((20, 15, 10), (3, 2, 2), 0.05, seed=2, noise=0.1)
    t, tt = tgen.low_rank_sparse_tensor((20, 15, 10), (3, 2, 2), 0.05, seed=2, noise=0.1)
    np.testing.assert_array_equal(t.indices.numpy(), np.asarray(j.indices))
    np.testing.assert_array_equal(t.values.numpy(), np.asarray(j.values))
    np.testing.assert_array_equal(tt["core"], jt["core"])


def test_coo_norm_pad_dense_match_reference():
    j = jgen.random_sparse_tensor((9, 8, 7), 0.1, seed=1)
    t = tgen.random_sparse_tensor((9, 8, 7), 0.1, seed=1)
    np.testing.assert_allclose(float(t.norm()), float(j.norm()), rtol=1e-6)
    tp, jp = t.pad_to(t.nnz + 13), j.pad_to(j.nnz + 13)
    np.testing.assert_array_equal(tp.indices.numpy(), np.asarray(jp.indices))
    np.testing.assert_array_equal(tp.values.numpy(), np.asarray(jp.values))
    np.testing.assert_allclose(tp.to_dense().numpy(), np.asarray(jp.to_dense()))
    with pytest.raises(ValueError):
        t.pad_to(t.nnz - 1)
    with pytest.raises(ValueError):
        tcoo.SparseCOO.from_parts(np.zeros((3, 2), np.int32), np.zeros(3), (4, 4, 4))


def test_ttm_chain_and_reconstruct_match_reference():
    rng = np.random.default_rng(3)
    x = rng.standard_normal((6, 5, 4)).astype(np.float32)
    us = [rng.standard_normal((s, r)).astype(np.float32) for s, r in zip(x.shape, (3, 2, 2))]
    want = np.asarray(jttm.ttm_chain(jnp.asarray(x), [jnp.asarray(u) for u in us], skip=1))
    got = tttm.ttm_chain(torch.from_numpy(x), [torch.from_numpy(u) for u in us], skip=1)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    core = rng.standard_normal((3, 2, 2)).astype(np.float32)
    want = np.asarray(jrec.reconstruct_dense(jnp.asarray(core), [jnp.asarray(u) for u in us]))
    got = trec.reconstruct_dense(torch.from_numpy(core), [torch.from_numpy(u) for u in us])
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    y = rng.standard_normal((6, 9)).astype(np.float32)
    u = rng.standard_normal((4, 9)).astype(np.float32)
    np.testing.assert_allclose(
        tttm.ttm_unfolded(torch.from_numpy(y), torch.from_numpy(u)).numpy(),
        np.asarray(jttm.ttm_unfolded(jnp.asarray(y), jnp.asarray(u))), rtol=1e-5, atol=1e-5)
    assert trec.compression_ratio((130, 150), (30, 35), include_factors=False) == \
        jrec.compression_ratio((130, 150), (30, 35), include_factors=False)
