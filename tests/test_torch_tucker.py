"""repro_torch end to end on the CPU: ``decompose(..., device="cpu")``
against ``repro.tucker.plan(TuckerSpec(engine="pallas"))`` (interpret mode)
from the same initial factors, and the entry points' device and spec
rules."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import tucker as jtucker
from repro.sparse.generators import low_rank_sparse_tensor as jlow_rank
from repro.sparse.generators import random_sparse_tensor as jrandom
from repro_torch import tucker
from repro_torch.convert import coo_from_numpy, factors_from_numpy
from repro_torch.core.engine import make_engine, resolve_engine
from repro_torch.core.hooi import init_factors


def _pair(coo, ranks, **spec):
    """Run both packages from the same numpy factors; return (ref, port)."""
    rng = np.random.default_rng(0)
    f0 = [np.linalg.qr(rng.standard_normal((s, r)))[0].astype(np.float32)
          for s, r in zip(coo.shape, jtucker.TuckerSpec(coo.shape, ranks).ranks)]
    jspec = jtucker.TuckerSpec(shape=coo.shape, ranks=ranks, engine="pallas", **spec)
    ref = jtucker.plan(jspec)(coo, factors_init=[jnp.asarray(f) for f in f0])
    tc = coo_from_numpy(np.asarray(coo.indices), np.asarray(coo.values), coo.shape)
    port = tucker.decompose(tc, ranks, device="cpu", factors_init=factors_from_numpy(f0),
                            **spec)
    return ref, port


def _assert_parity(ref, port):
    # fit: absolute 1e-4 (the f32 fit has a floor near 0, ROADMAP.md queue 3);
    # core and factor subspaces: 1e-3 after up to three sweeps of f32 QRP.
    assert port.engine == "torch"
    # one top-level dispatch, as the reference counts it; no kernel launch on the CPU
    assert port.dispatches == ref.dispatches == 1 and port.launches == 0
    assert port.precision == ref.precision
    assert port.fit_history.shape == ref.fit_history.shape
    np.testing.assert_allclose(port.fit_history, ref.fit_history, rtol=0, atol=1e-4)
    np.testing.assert_allclose(port.rel_error, float(ref.rel_error), rtol=0, atol=1e-4)
    core = port.core.numpy()
    for n, (a, b) in enumerate(zip(port.factors, ref.factors)):
        a, b = a.numpy(), np.asarray(b)
        np.testing.assert_allclose(a @ a.T, b @ b.T, rtol=0, atol=1e-3)
        # SVD columns are defined up to sign; flip the core's slices to match.
        sign = np.sign(np.sum(a * b, axis=0))
        core = core * sign.reshape([-1 if t == n else 1 for t in range(core.ndim)])
    np.testing.assert_allclose(core, np.asarray(ref.core), rtol=0, atol=1e-3)
    assert port.n_sweeps == ref.n_sweeps
    assert port.compression_ratio == pytest.approx(ref.compression_ratio)


@pytest.mark.parametrize("method", ["householder", "gram", "svd"])
def test_three_way_matches_reference(method):
    coo = jrandom((40, 35, 30), 0.01, seed=3)
    _assert_parity(*_pair(coo, (5, 4, 3), method=method, n_iter=3))


def test_two_way_matches_reference():
    coo = jrandom((40, 30), 0.02, seed=5)
    _assert_parity(*_pair(coo, (5, 4), n_iter=3))


def test_bf16_precision_matches_reference():
    coo = jrandom((30, 25, 20), 0.02, seed=6)
    _assert_parity(*_pair(coo, (4, 3, 3), n_iter=2, precision="bf16_fp32acc"))


def test_prebuilt_bf16_engine_reports_its_precision():
    """An fp32 spec run through a prebuilt bf16_fp32acc engine reports the
    engine's precision, as the reference's result does."""
    from repro.core.engine import make_engine as jmake_engine

    coo = jrandom((30, 25, 20), 0.02, seed=6)
    ranks = (4, 3, 3)
    rng = np.random.default_rng(2)
    f0 = [np.linalg.qr(rng.standard_normal((s, r)))[0].astype(np.float32)
          for s, r in zip(coo.shape, ranks)]
    jspec = jtucker.TuckerSpec(shape=coo.shape, ranks=ranks, n_iter=2)
    ref = jtucker.plan(jspec, engine=jmake_engine("pallas", precision="bf16_fp32acc"))(
        coo, factors_init=[jnp.asarray(f) for f in f0])
    spec = tucker.TuckerSpec(coo.shape, ranks, n_iter=2)
    eng = make_engine("torch", "cpu", precision="bf16_fp32acc")
    tc = coo_from_numpy(np.asarray(coo.indices), np.asarray(coo.values), coo.shape)
    port = tucker.plan(spec, device="cpu", engine=eng)(tc, factors_init=factors_from_numpy(f0))
    assert spec.precision == "fp32"
    assert port.precision == ref.precision == "bf16_fp32acc"
    _assert_parity(ref, port)
    fp32 = tucker.plan(spec, device="cpu")(tc, factors_init=factors_from_numpy(f0))
    assert fp32.precision == "fp32"


def test_tol_early_exit_same_history():
    # fit deltas of this run: 0.091, 0.025, 0.0039, ... -> stops after sweep 4
    coo, _ = jlow_rank((30, 25, 20), (3, 3, 2), 0.02, seed=0)
    ref, port = _pair(coo, (3, 3, 2), n_iter=5, tol=1e-2)
    assert ref.n_sweeps == 4  # the early exit fired in the reference
    _assert_parity(ref, port)


def test_plan_reuses_schedules_and_rebinds_on_new_tensor():
    ref = jrandom((20, 15, 10), 0.02, seed=2)
    coo = coo_from_numpy(np.asarray(ref.indices), np.asarray(ref.values), ref.shape)
    plan = tucker.plan(tucker.TuckerSpec(coo.shape, (3, 3, 2), n_iter=2), device="cpu")
    first, again = plan(coo), plan(coo)
    assert first.schedule_builds == 3 and again.schedule_builds == 0  # one per mode
    np.testing.assert_array_equal(first.fit_history, again.fit_history)
    other = coo_from_numpy(coo.indices.numpy().copy(), coo.values.numpy(), coo.shape)
    assert plan(other).schedule_builds == 3  # new indices tensor: rebuilt
    assert tucker.plan(plan.spec, device="cpu") is plan  # cached per (spec, device)


def test_init_factors_orthonormal_and_seeded():
    a = init_factors((10, 8), (3, 2), torch.Generator().manual_seed(4))
    b = init_factors((10, 8), (3, 2), torch.Generator().manual_seed(4))
    for x, y in zip(a, b):
        assert torch.equal(x, y) and x.dtype == torch.float32
        torch.testing.assert_close(x.T @ x, torch.eye(x.shape[1]), atol=1e-5, rtol=0)


def test_default_device_without_cuda_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default runs on it")
    coo = coo_from_numpy(np.zeros((1, 3), np.int32), np.ones(1, np.float32), (2, 2, 2))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tucker.decompose(coo, (1, 1, 1))
    with pytest.raises(RuntimeError):
        tucker.plan(tucker.TuckerSpec((2, 2, 2), (1, 1, 1)))


def test_engine_names():
    for jax_name in ("xla", "pallas"):
        with pytest.raises(ValueError, match="JAX engine"):
            tucker.TuckerSpec((4, 4, 4), (2, 2, 2), engine=jax_name)
        with pytest.raises(ValueError, match="JAX engine"):
            make_engine(jax_name, "cpu")
    assert resolve_engine("auto", "cpu") == "torch"
    assert resolve_engine("auto", "cuda") == "cuda"
    with pytest.raises(ValueError, match="never selects"):
        resolve_engine("torch", "cuda")
    # with Kron reuse, torch is the XLA engine's twin in torch ops on either
    # device: it runs no kernel, and no plain version of one
    assert resolve_engine("torch", "cuda", use_kron_reuse=True) == "torch"
    assert make_engine("torch", "cuda", fuse_core=True, use_kron_reuse=True).reuses_kron
    assert make_engine("torch", "cpu", use_kron_reuse=True).reuses_kron
    assert not make_engine("torch", "cpu").reuses_kron
    assert not make_engine("cuda", "cuda", use_kron_reuse=True).reuses_kron
    with pytest.raises(ValueError, match="needs a CUDA device"):
        resolve_engine("cuda", "cpu")


# shard, snapshot, autotune and use_kron_reuse are ported: a value the
# reference refuses raises as the reference's spec does, and Kron reuse is
# accepted as the reference accepts it.
@pytest.mark.parametrize("kwargs", [
    {"shard": object()}, {"snapshot": object()}, {"autotune": True, "algorithm": "dense"},
    {"use_kron_reuse": True},
])
def test_unported_spec_values_raise(kwargs):
    if "use_kron_reuse" in kwargs:
        port = tucker.TuckerSpec((4, 4, 4), (2, 2, 2), **kwargs)
        ref = jtucker.TuckerSpec((4, 4, 4), (2, 2, 2), **kwargs)
        assert port.use_kron_reuse and ref.use_kron_reuse
        assert port.supports_batched_dispatch == ref.supports_batched_dispatch is False
        return
    exc = TypeError if "snapshot" in kwargs or "shard" in kwargs else ValueError
    with pytest.raises(exc) as port_err:
        tucker.TuckerSpec((4, 4, 4), (2, 2, 2), **kwargs)
    with pytest.raises(exc) as ref_err:
        jtucker.TuckerSpec((4, 4, 4), (2, 2, 2), **kwargs)
    assert str(port_err.value) == str(ref_err.value)


def test_unported_plan_features_raise():
    # plan.batch is ported: an empty batch is the reference's no-op
    p = tucker.plan(tucker.TuckerSpec((4, 4, 4), (2, 2, 2)), device="cpu")
    assert p.batch([]) == []
    # the sharded service across ranks is ported (item 15b): it needs a
    # process group of its world size; a world of one needs none
    from repro_torch.serve import ServiceConfig, TuckerService

    across = ServiceConfig(shard=tucker.ShardSpec(2), device="cpu")
    with pytest.raises(ValueError, match="no process group is initialised"):
        TuckerService(across)
    assert ServiceConfig(shard=tucker.ShardSpec(1), device="cpu").shard.num_devices == 1


def test_spec_validation_and_rank_clamp_match_reference():
    for shape, ranks in [((130, 150), (30, 35)), ((4, 5, 6), (9, 9, 9)), ((10, 2, 3), (8, 2, 3))]:
        assert tucker.TuckerSpec(shape, ranks).ranks == jtucker.TuckerSpec(shape, ranks).ranks
    for bad in [dict(ranks=(0, 1, 1)), dict(n_iter=0), dict(tol=-1.0), dict(tol=float("nan")),
                dict(method="qr"), dict(precision="fp16"), dict(dtype="int8")]:
        kw = {"ranks": (2, 2, 2), **bad}
        with pytest.raises(ValueError):
            tucker.TuckerSpec((4, 4, 4), **kw)
    assert tucker.TuckerSpec((4, 4, 4), (2, 2, 2), dtype=torch.float64).dtype == "float64"


@pytest.mark.parametrize("method", ["householder", "svd"])
def test_four_way_matches_reference(method):
    coo = jrandom((14, 12, 10, 8), 0.03, seed=8)
    _assert_parity(*_pair(coo, (3, 3, 2, 2), method=method, n_iter=3))


def test_five_way_bf16_matches_reference():
    coo = jrandom((8, 7, 6, 5, 4), 0.05, seed=9)
    _assert_parity(*_pair(coo, (2, 2, 2, 2, 2), n_iter=2, precision="bf16_fp32acc"))


def _fused_pair(coo, ranks, precision="fp32", **spec):
    """Both packages through a prebuilt engine with ``fuse_core=True``."""
    from repro.core.engine import make_engine as jmake_engine

    rng = np.random.default_rng(1)
    f0 = [np.linalg.qr(rng.standard_normal((s, r)))[0].astype(np.float32)
          for s, r in zip(coo.shape, ranks)]
    jspec = jtucker.TuckerSpec(shape=coo.shape, ranks=ranks, **spec)
    ref = jtucker.plan(jspec, engine=jmake_engine("pallas", fuse_core=True, precision=precision))(
        coo, factors_init=[jnp.asarray(f) for f in f0])
    eng = make_engine("torch", "cpu", fuse_core=True, precision=precision)
    p = tucker.plan(tucker.TuckerSpec(coo.shape, ranks, **spec), device="cpu", engine=eng)
    assert p.engine is eng and tucker.plan(p.spec, device="cpu", engine=eng) is not p
    tc = coo_from_numpy(np.asarray(coo.indices), np.asarray(coo.values), coo.shape)
    return ref, p(tc, factors_init=factors_from_numpy(f0))


@pytest.mark.parametrize("precision", ["fp32", "bf16_fp32acc"])
def test_fused_core_plan_matches_reference(precision):
    coo = jrandom((40, 35, 30), 0.01, seed=10)
    ref, port = _fused_pair(coo, (5, 4, 3), precision, n_iter=3)
    _assert_parity(ref, port)


def test_fused_core_on_four_way_takes_the_split_path(monkeypatch):
    from repro_torch.kernels import ops

    def rebuild(*args, **kwargs):  # would form Y_(N) a second time through the chain
        raise AssertionError("the order-4 core update rebuilt Y_(N)")

    monkeypatch.setattr(ops, "sparse_ttm_core_device", rebuild)
    coo = jrandom((12, 10, 9, 7), 0.04, seed=11)
    _assert_parity(*_fused_pair(coo, (3, 2, 3, 2), n_iter=2))


def test_prebuilt_engine_must_match_the_plan_device():
    spec = tucker.TuckerSpec((4, 4, 4), (2, 2, 2))
    eng = make_engine("torch", "cpu", fuse_core=True)
    assert eng.fuse_core and not make_engine("torch", "cpu").fuse_core
    if torch.cuda.is_available():
        with pytest.raises(ValueError, match="prebuilt engine"):
            tucker.plan(spec, engine=eng)  # the plan defaults to the card
    else:  # the default device is the card, which is missing here
        with pytest.raises(RuntimeError, match="device='cpu'"):
            tucker.plan(spec, engine=eng)
    with pytest.raises(ValueError, match="prebuilt engine"):
        tucker.plan(spec, device="cpu", engine=make_engine("cuda", "cuda"))
