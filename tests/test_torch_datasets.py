"""The paper's Table V tensors (``repro_torch.sparse.datasets``) against the
JAX package's: the same metadata and, at full size, the same indices and
values bit for bit; then their decompositions on the CPU against the
reference's from the same initial factors, with each fit held to an error
computed independently of the projection identity."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import tucker as jtucker
from repro.sparse import datasets as jdatasets
from repro.sparse.datasets import PAPER_DATASETS as JDATASETS
from repro_torch import tucker
from repro_torch.convert import factors_from_numpy
from repro_torch.core.reconstruct import reconstruct_at, relative_error_dense
from repro_torch.sparse import PAPER_DATASETS, datasets


@pytest.mark.parametrize("name", ["amazon", "nell2", "matmul", "angiogram"])
def test_dataset_metadata_and_arrays_equal_reference(name):
    ds, ref = PAPER_DATASETS[name], JDATASETS[name]
    for field in ("name", "shape", "sparsity", "ranks", "n_iter", "exact"):
        assert getattr(ds, field) == getattr(ref, field), field
    got, want = ds.build(), ref.build()
    assert got.shape == tuple(want.shape) == ds.shape and got.device == torch.device("cpu")
    assert got.indices.dtype == torch.int32 and got.values.dtype == torch.float32
    np.testing.assert_array_equal(got.indices.numpy(), np.asarray(want.indices))
    np.testing.assert_array_equal(got.values.numpy(), np.asarray(want.values))
    assert got.density() == pytest.approx(ds.sparsity, rel=0.02)


def test_dataset_functions_take_a_device_and_their_arguments():
    coo = datasets.nell2_like(scale=0.5, seed=2, device="cpu")
    ref = jdatasets.nell2_like(scale=0.5, seed=2)
    np.testing.assert_array_equal(coo.indices.numpy(), np.asarray(ref.indices))
    assert coo.shape == (500, 500, 500) and coo.device == torch.device("cpu")
    mm = datasets.matmul_tensor(2, 3, 4, device=torch.device("cpu"))
    np.testing.assert_array_equal(mm.indices.numpy(),
                                  np.asarray(jdatasets.matmul_tensor(2, 3, 4).indices))
    assert mm.nnz == 24 and float(mm.values.sum()) == 24.0


def sparse_rel_error(coo, core, factors) -> float:
    """||X - Xhat|| / ||X|| from Xhat at the nonzeros only, in float64:
    ||X - Xhat||^2 = ||X||^2 - 2 <X, Xhat> + ||G||^2 (orthonormal factors)."""
    core, factors = core.double(), [f.double() for f in factors]
    x = coo.values.double()
    xhat = reconstruct_at(core, factors, coo.indices)
    xx = float(x @ x)
    return float(np.sqrt(max(xx - 2 * float(x @ xhat) + float((core * core).sum()), 0.0) / xx))


@pytest.mark.parametrize("name", ["nell2", "matmul", "angiogram"])
def test_table5_decomposition_matches_reference_and_its_quality(name):
    ds = PAPER_DATASETS[name]
    jc, tc = JDATASETS[name].build(), ds.build()
    ranks = tucker.TuckerSpec(ds.shape, ds.ranks).ranks
    rng = np.random.default_rng(0)
    f0 = [np.linalg.qr(rng.standard_normal((s, r)))[0].astype(np.float32)
          for s, r in zip(ds.shape, ranks)]
    kw = dict(n_iter=ds.n_iter, method="householder")
    ref = jtucker.plan(jtucker.spec_for(jc, ds.ranks, engine="xla", **kw))(
        jc, factors_init=[jnp.asarray(f) for f in f0])
    port = tucker.plan(tucker.spec_for(tc, ds.ranks, **kw), device="cpu")(
        tc, factors_init=factors_from_numpy(f0))
    assert port.n_sweeps == ref.n_sweeps == ds.n_iter
    np.testing.assert_allclose(port.fit_history, ref.fit_history, rtol=0, atol=1e-4)
    for a, b in zip(port.factors, ref.factors):
        a, b = a.numpy(), np.asarray(b)
        np.testing.assert_allclose(a @ a.T, b @ b.T, rtol=0, atol=1e-3)
    # the fit against two errors that do not use the projection identity
    dense = float(relative_error_dense(tc.to_dense(), port.core, port.factors))
    at_nonzeros = sparse_rel_error(tc, port.core, port.factors)
    assert abs(port.rel_error - dense) <= 1e-4, (port.rel_error, dense)
    assert abs(port.rel_error - at_nonzeros) <= 1e-4, (port.rel_error, at_nonzeros)
