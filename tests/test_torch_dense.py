"""Dense HOOI (paper Alg. 1) and EM completion: ``repro_torch`` on the CPU
against ``repro.tucker.plan(TuckerSpec(algorithm="dense" | "complete"))``
from the same numpy tensor and initial factors, the paper's Table II claim
in float64, and the deprecated shims."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import tucker as jtucker
from repro.sparse.generators import low_rank_sparse_tensor as jlow_rank
from repro_torch import tucker
from repro_torch.convert import coo_from_numpy, factors_from_numpy
from repro_torch.core import hooi as thooi
from repro_torch.core.engine import make_engine
from repro_torch.core.reconstruct import reconstruct_dense, relative_error_dense

SHAPES = {2: ((14, 11), (4, 3)), 3: ((10, 9, 8), (3, 4, 2)), 4: ((7, 6, 5, 4), (2, 3, 2, 2))}
# fit: absolute, the f32 fit has a floor near 0 (ROADMAP.md queue 3); in f64
# both packages run the same factor updates in LAPACK-accurate arithmetic
FIT_TOL = {"float32": 1e-4, "float64": 1e-10}


def _factors(shape, ranks, seed, dtype):
    rng = np.random.default_rng(seed)
    return [np.linalg.qr(rng.standard_normal((s, r)))[0].astype(dtype)
            for s, r in zip(shape, jtucker.TuckerSpec(shape, ranks).ranks)]


def _assert_dense_parity(ref, port, fit_tol):
    """As ``test_torch_tucker._assert_parity``, for the dense paths: the
    reference's engine is "xla", the port's "torch"; neither counts a
    dispatch; no kernel launch."""
    assert ref.engine == "xla" and port.engine == "torch"
    assert port.dispatches == ref.dispatches == 0 and port.launches == 0
    assert port.schedule_builds == 0 and port.precision == ref.precision == "fp32"
    assert port.fit_history.shape == ref.fit_history.shape
    np.testing.assert_allclose(port.fit_history, ref.fit_history, rtol=0, atol=fit_tol)
    np.testing.assert_allclose(port.rel_error, float(ref.rel_error), rtol=0, atol=fit_tol)
    core = port.core.numpy()
    for n, (a, b) in enumerate(zip(port.factors, ref.factors)):
        a, b = a.numpy(), np.asarray(b)
        np.testing.assert_allclose(a @ a.T, b @ b.T, rtol=0, atol=1e-3)
        sign = np.sign(np.sum(a * b, axis=0))
        core = core * sign.reshape([-1 if t == n else 1 for t in range(core.ndim)])
    np.testing.assert_allclose(core, np.asarray(ref.core), rtol=0, atol=1e-3)
    assert port.compression_ratio == pytest.approx(ref.compression_ratio)


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("method", ["svd", "householder", "gram"])
@pytest.mark.parametrize("order", [2, 3, 4])
def test_dense_matches_reference(order, method, dtype):
    shape, ranks = SHAPES[order]
    x = np.random.default_rng(order).standard_normal(shape).astype(dtype)
    f0 = _factors(shape, ranks, 10 + order, dtype)
    with jax.enable_x64(dtype == "float64"):
        jspec = jtucker.TuckerSpec(shape, ranks, algorithm="dense", method=method, n_iter=3,
                                   dtype=dtype)
        ref = jtucker.plan(jspec)(jnp.asarray(x), factors_init=[jnp.asarray(f) for f in f0])
        ref_core = np.asarray(ref.core)
    assert ref_core.dtype == np.dtype(dtype)
    spec = tucker.TuckerSpec(shape, ranks, algorithm="dense", method=method, n_iter=3,
                             dtype=dtype)
    port = tucker.plan(spec, device="cpu")(x, factors_init=factors_from_numpy(f0))
    assert port.core.dtype == getattr(torch, dtype)
    _assert_dense_parity(ref, port, FIT_TOL[dtype])


def test_dense_tol_exit_and_tensor_input_match_reference():
    shape, ranks = (12, 10, 9), (3, 3, 2)
    rng = np.random.default_rng(7)
    x = np.einsum("abc,ia,jb,kc->ijk", rng.standard_normal(ranks),
                  *[rng.standard_normal((s, r)) for s, r in zip(shape, ranks)])
    x = (x + 0.3 * rng.standard_normal(shape)).astype(np.float32)
    f0 = _factors(shape, ranks, 3, np.float32)
    ref = jtucker.plan(jtucker.TuckerSpec(shape, ranks, algorithm="dense", method="svd",
                                          n_iter=8, tol=1e-3))(
        jnp.asarray(x), factors_init=[jnp.asarray(f) for f in f0])
    assert 1 < ref.n_sweeps < 8  # the early exit fired
    port = tucker.decompose(torch.from_numpy(x), ranks, n_iter=8, tol=1e-3, device="cpu",
                            factors_init=factors_from_numpy(f0), method="svd")
    assert port.spec.algorithm == "dense" and port.n_sweeps == ref.n_sweeps
    _assert_dense_parity(ref, port, 1e-4)


@pytest.mark.parametrize("method", ["gram", "householder"])
def test_completion_matches_reference(method):
    coo, _ = jlow_rank((12, 12, 12), (3, 3, 3), 0.3, seed=1)
    f0 = _factors(coo.shape, (3, 3, 3), 5, np.float32)
    kw = dict(algorithm="complete", method=method, n_iter=2, n_rounds=4)
    ref = jtucker.plan(jtucker.TuckerSpec(coo.shape, (3, 3, 3), **kw))(
        coo, factors_init=[jnp.asarray(f) for f in f0])
    tc = coo_from_numpy(np.asarray(coo.indices), np.asarray(coo.values), coo.shape)
    port = tucker.plan(tucker.TuckerSpec(coo.shape, (3, 3, 3), **kw), device="cpu")(
        tc, factors_init=factors_from_numpy(f0))
    _assert_dense_parity(ref, port, 1e-4)


def test_completion_recovers_the_unobserved_entries():
    """A rank-(3, 3, 3) tensor observed at 20% of its entries: each EM
    round brings the completed tensor closer to the truth where nothing was
    observed (the error contracts by about the unobserved share a round)."""
    from repro_torch.sparse.generators import low_rank_sparse_tensor

    shape, ranks = (32, 32, 32), (3, 3, 3)
    coo, truth = low_rank_sparse_tensor(shape, ranks, 0.2, seed=4)
    x_true = reconstruct_dense(torch.from_numpy(truth["core"]),
                               [torch.from_numpy(f) for f in truth["factors"]]).float()
    seen = torch.zeros(shape, dtype=torch.bool)
    seen[tuple(coo.indices.long().T)] = True
    err = {}
    for n_rounds in (10, 30):
        res = tucker.decompose(coo, ranks, algorithm="complete", n_rounds=n_rounds, n_iter=2,
                               method="gram", device="cpu")
        miss = (reconstruct_dense(res.core, res.factors) - x_true)[~seen]
        err[n_rounds] = float(miss.norm() / x_true[~seen].norm())
    assert err[30] < 0.05 and err[30] < err[10] < 0.5, err


def table2_tensor(size: int, rank: int = 16) -> torch.Tensor:
    """``benchmarks/table2_accuracy.py``'s tensor in float64: a random
    rank-(16, 16, 16) tensor plus noise of 1e-9 from ``default_rng(size)``,
    the product taken as a TTM chain."""
    rng = np.random.default_rng(size)
    us = [np.linalg.qr(rng.standard_normal((size, rank)))[0] for _ in range(3)]
    g = rng.standard_normal((rank,) * 3)
    x = reconstruct_dense(torch.from_numpy(g), [torch.from_numpy(u) for u in us])
    return x + 1e-9 * torch.from_numpy(rng.standard_normal(x.shape))


@pytest.mark.parametrize("size", [50, 100])
def test_table2_qrp_loses_no_accuracy_in_float64(size):
    """Paper Table II: HOOI with QRP reaches SVD's error, within 5% as
    ``benchmarks/table2_accuracy.py`` checks. The errors are taken densely:
    at ~3e-8 they sit at the float64 floor of the projection identity's
    sqrt(||X||^2 - ||G||^2), which cancels to ~1.5e-8."""
    x = table2_tensor(size)
    err = {m: float(relative_error_dense(x, *_core_factors(x, m))) for m in
           ("svd", "householder", "gram")}
    assert 0 < err["svd"] < 1e-7
    for m in ("householder", "gram"):
        assert abs(err[m] - err["svd"]) <= 0.05 * err["svd"], err


def _core_factors(x, method, dtype=None):
    res = tucker.decompose(x if dtype is None else x.to(dtype), (16,) * 3, n_iter=3,
                           method=method, device="cpu")
    return res.core, res.factors


def test_table2_limits_of_the_card_hold_in_float32():
    """The limits of Table II on the card, on the CPU at 200^3 in float32:
    every method's dense error <= 1e-5 and QRP within 1e-6 of SVD (measured
    here: svd 9.8e-7, householder 7.9e-7, gram 6.7e-7). ``chip_smoke.py``
    holds 800^3 to the one-sided form, QRP <= SVD + 1e-6: from 400^3 on
    SVD's f32 error reaches 2.0e-6 while QRP's stays below 1e-6."""
    x = table2_tensor(200).to(torch.float32)
    err = {m: float(relative_error_dense(x, *_core_factors(x, m))) for m in
           ("svd", "householder", "gram")}
    assert all(e <= 1e-5 for e in err.values()), err
    assert all(abs(err[m] - err["svd"]) <= 1e-6 for m in ("householder", "gram")), err


def test_shims_warn_and_equal_the_plan():
    rng = np.random.default_rng(2)
    x = rng.standard_normal((9, 8, 7)).astype(np.float32)
    f0 = factors_from_numpy(_factors(x.shape, (3, 3, 2), 1, np.float32))
    with pytest.warns(DeprecationWarning, match="hooi_dense is deprecated"):
        old = thooi.hooi_dense(x, (3, 3, 2), n_iter=2, method="gram", factors_init=f0,
                               device="cpu")
    new = tucker.plan(tucker.TuckerSpec(x.shape, (3, 3, 2), algorithm="dense", method="gram",
                                        n_iter=2), device="cpu")(x, factors_init=f0)
    np.testing.assert_array_equal(old.fit_history, new.fit_history)
    assert torch.equal(old.core, new.core)
    jc, _ = jlow_rank((8, 7, 6), (2, 2, 2), 0.4, seed=3)
    coo = coo_from_numpy(np.asarray(jc.indices), np.asarray(jc.values), jc.shape)
    with pytest.warns(DeprecationWarning, match="tucker_complete_dense is deprecated"):
        old = thooi.tucker_complete_dense(coo, (2, 2, 2), n_rounds=3, device="cpu")
    new = tucker.decompose(coo, (2, 2, 2), algorithm="complete", n_rounds=3, n_iter=2,
                           method="gram", device="cpu")
    np.testing.assert_array_equal(old.fit_history, new.fit_history)
    assert torch.equal(old.core, new.core)


def test_dense_entry_rules():
    x = np.zeros((4, 4, 4), np.float32)
    spec = tucker.TuckerSpec((4, 4, 4), (2, 2, 2), algorithm="dense")
    with pytest.raises(ValueError, match="only applies to algorithm='sparse'"):
        tucker.plan(spec, device="cpu", engine=make_engine("torch", "cpu"))
    with pytest.raises(ValueError, match="does not match"):
        tucker.plan(spec, device="cpu")(np.zeros((4, 4, 5), np.float32))
    if not torch.cuda.is_available():  # the default is the card: no silent CPU run
        with pytest.raises(RuntimeError, match="device='cpu'"):
            tucker.decompose(x, (2, 2, 2))
        with pytest.raises(RuntimeError, match="device='cpu'"):
            tucker.plan(tucker.TuckerSpec((4, 4, 4), (2, 2, 2), algorithm="complete"))
    with pytest.raises(ValueError, match="n_rounds"):
        tucker.TuckerSpec((4, 4, 4), (2, 2, 2), algorithm="complete", n_rounds=0)
