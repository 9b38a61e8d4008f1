"""The paper's Kron reuse (Sec. III-C: "a Kronecker product can be re-used
for all non-zero elements that share the same indices") in repro_torch on
the CPU, against the reference.

``build_kron_reuse`` gives the reference's arrays (``torch.unique`` and
``np.unique`` both sort the coordinate tuples lexicographically); the reuse
chain gives the plain chain's bits (the same products, gathered) and the
reference's reuse chain's values; the reference's tests of the feature have
port twins here, each also held to the reference's result from the same
numpy initial factors: fit 1e-4, factor projectors and core 1e-3, the
port's f32 parity bounds (``test_torch_tucker.py``). Reuse is honoured on
the torch engine and ignored on ``cuda``, as the reference honours it on
XLA and ignores it on Pallas (``tucker.engine_for_spec``).
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import tucker as jtucker
from repro.core import kron as jkron
from repro.core import engine as jengine
from repro.core.coo import SparseCOO as JCOO
from repro.sparse.generators import random_sparse_tensor as jrandom
from repro.sparse.layout import build_kron_reuse as jbuild_kron_reuse
from repro_torch import tucker
from repro_torch.convert import coo_from_numpy, factors_from_numpy
from repro_torch.core import kron as tkron
from repro_torch.core.coo import SparseCOO
from repro_torch.core.engine import make_engine
from repro_torch.sparse.layout import DeviceSchedule, KronReusePlan, build_kron_reuse


def _coo_with_repeats(shape, nnz, seed, n_distinct=None):
    """Coordinates whose non-mode tuples repeat (few distinct values per
    mode), so the dedup has work to do."""
    rng = np.random.default_rng(seed)
    lim = [min(s, n_distinct or s) for s in shape]
    lin = rng.choice(int(np.prod(lim)), min(nnz, int(np.prod(lim))), replace=False)
    idx = np.stack(np.unravel_index(lin, lim), 1).astype(np.int32)
    vals = rng.standard_normal(idx.shape[0]).astype(np.float32)
    return idx, vals


@pytest.mark.parametrize("shape,n_distinct", [((20, 20, 20), 6), ((30, 25, 20, 8), 5),
                                              ((40, 30), None), ((16, 14, 12), None)])
def test_build_kron_reuse_equals_the_reference(shape, n_distinct):
    idx, vals = _coo_with_repeats(shape, 600, 3, n_distinct)
    jc = JCOO.from_parts(idx, vals, shape)
    tc = SparseCOO.from_parts(idx, vals, shape)
    for mode in range(len(shape)):
        want = jbuild_kron_reuse(jc, mode)
        got = build_kron_reuse(tc, mode)
        assert isinstance(got, KronReusePlan) and got.modes == want.modes
        assert got.unique_indices.dtype == torch.int32 and got.inverse.dtype == torch.int32
        np.testing.assert_array_equal(got.unique_indices.numpy(), want.unique_indices)
        np.testing.assert_array_equal(got.inverse.numpy(), want.inverse)
        assert tkron.precompute_kron_reuse(tc, mode).unique_indices.shape == got.unique_indices.shape
        sched = DeviceSchedule.from_kron_plan(got, mode, shape)
        assert sched.order is None and sched.kron_modes == want.modes
        assert torch.equal(sched.kron_unique, got.unique_indices)
        assert sched.with_values(tc.values * 2) is sched and got.with_values(tc.values) is got
    if n_distinct:  # the dedup really dedups
        assert got.unique_indices.shape[0] < tc.nnz


def test_build_kron_reuse_of_an_empty_tensor():
    shape = (5, 4, 3)
    tc = SparseCOO.from_parts(np.zeros((0, 3), np.int32), np.zeros(0, np.float32), shape)
    jc = JCOO.from_parts(np.zeros((0, 3), np.int32), np.zeros(0, np.float32), shape)
    got, want = build_kron_reuse(tc, 1), jbuild_kron_reuse(jc, 1)
    assert tuple(got.unique_indices.shape) == want.unique_indices.shape == (0, 2)
    assert got.inverse.numel() == want.inverse.size == 0
    fs = [torch.ones((s, 2)) for s in shape]
    assert not tkron.sparse_ttm_chain_reuse(tc, fs, 1, got).any()


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("shape,ranks", [((20, 20, 20), (3, 4, 2)), ((15, 12, 10, 6), (2, 3, 2, 2)),
                                         ((40, 30), (5, 4))])
def test_reuse_chain_matches_the_chain_and_the_reference(shape, ranks, dtype):
    idx, vals = _coo_with_repeats(shape, 500, 4, 7)
    rng = np.random.default_rng(5)
    fs = [rng.standard_normal((s, r)).astype(dtype) for s, r in zip(shape, ranks)]
    tc = SparseCOO.from_parts(idx, vals.astype(dtype), shape)
    tfs = [torch.from_numpy(f) for f in fs]
    jc = JCOO.from_parts(idx, vals, shape)
    jfs = [jnp.asarray(f.astype(np.float32)) for f in fs]
    for mode in range(len(shape)):
        plan = build_kron_reuse(tc, mode)
        got = tkron.sparse_ttm_chain_reuse(tc, tfs, mode, plan)
        # the same products, gathered: the plain chain's bits
        assert torch.equal(got, tkron.sparse_ttm_chain(tc, tfs, mode))
        dev = tkron.sparse_ttm_chain_reuse_device(
            tc.indices, tc.values, tfs, mode, DeviceSchedule.from_kron_plan(plan, mode, shape),
            shape=shape)
        assert torch.equal(dev, got) and got.dtype == torch.from_numpy(fs[0]).dtype
        want = jkron.sparse_ttm_chain_reuse(jc, jfs, mode, jbuild_kron_reuse(jc, mode))
        want = np.asarray(want)
        np.testing.assert_allclose(got.numpy(), want, rtol=0,
                                   atol=1e-5 * np.abs(want).max())


def _pair(shape, ranks, density, seed, method="gram", n_iter=3, **spec):
    """The reference's and the port's runs of one spec from the same numpy
    tensor and initial factors; the reference on its XLA engine."""
    coo = jrandom(shape, density, seed=seed)
    ranks = tucker.TuckerSpec(shape, ranks).ranks
    rng = np.random.default_rng(seed)
    f0 = [np.linalg.qr(rng.standard_normal((s, r)))[0].astype(np.float32)
          for s, r in zip(shape, ranks)]
    jspec = jtucker.TuckerSpec(shape=shape, ranks=ranks, method=method, n_iter=n_iter,
                               engine="xla", **spec)
    ref = jtucker.plan(jspec)(coo, factors_init=[jnp.asarray(f) for f in f0])
    tc = coo_from_numpy(np.asarray(coo.indices), np.asarray(coo.values), shape)
    tspec = tucker.TuckerSpec(shape=shape, ranks=ranks, method=method, n_iter=n_iter,
                              engine="torch", **spec)
    return ref, tspec, tc, factors_from_numpy(f0)


def _assert_parity(port, ref):
    np.testing.assert_allclose(port.fit_history, np.asarray(ref.fit_history), rtol=0, atol=1e-4)
    core = port.core.numpy()
    for n, (a, b) in enumerate(zip(port.factors, ref.factors)):
        a, b = a.numpy(), np.asarray(b)
        np.testing.assert_allclose(a @ a.T, b @ b.T, rtol=0, atol=1e-3)
        sign = np.sign(np.sum(a * b, axis=0))
        core = core * sign.reshape([-1 if t == n else 1 for t in range(core.ndim)])
    np.testing.assert_allclose(core, np.asarray(ref.core), rtol=0, atol=1e-3)


def test_kron_reuse_is_exact():
    ref, spec, tc, f0 = _pair((20, 20, 20), (4, 4, 4), 0.02, 4, n_iter=2,
                              use_kron_reuse=True)
    a = tucker.plan(dataclasses.replace(spec, use_kron_reuse=False), device="cpu")(
        tc, factors_init=f0)
    b = tucker.plan(spec, device="cpu")(tc, factors_init=f0)
    np.testing.assert_allclose(b.rel_error, a.rel_error, atol=1e-5)
    np.testing.assert_allclose(b.core.numpy(), a.core.numpy(), atol=1e-3)
    _assert_parity(b, ref)


@pytest.mark.parametrize("pipeline", ["scan", "python"])
def test_kron_reuse_actually_taken_on_both_pipelines(pipeline):
    ref, spec, tc, f0 = _pair((16, 14, 12), (3, 3, 2), 0.06, 55, pipeline=pipeline,
                              use_kron_reuse=True)
    p = tucker.plan(spec, device="cpu")
    assert p.engine.use_kron_reuse and p.engine.reuses_kron  # one helper, one rule
    res = p(tc, factors_init=f0)
    assert sorted(p.engine.kron_plans) == [0, 1, 2]
    assert res.schedule_builds > 0
    plain = tucker.plan(dataclasses.replace(spec, use_kron_reuse=False), device="cpu")(
        tc, factors_init=f0)
    np.testing.assert_allclose(res.fit_history, plain.fit_history, atol=1e-5)
    _assert_parity(res, ref)


def test_kron_reuse_pipelines_agree():
    ref, spec, tc, f0 = _pair((16, 14, 12), (3, 3, 2), 0.06, 56, use_kron_reuse=True)
    a = tucker.plan(dataclasses.replace(spec, pipeline="python"), device="cpu")(
        tc, factors_init=f0)
    b = tucker.plan(spec, device="cpu")(tc, factors_init=f0)
    np.testing.assert_allclose(a.fit_history, b.fit_history, atol=1e-5)
    _assert_parity(b, ref)


def test_prebuilt_engine_reuse_mismatch_warns_both_ways():
    spec = tucker.TuckerSpec((10, 8, 6), (2, 2, 2), use_kron_reuse=True, engine="torch")
    with pytest.warns(RuntimeWarning, match="use_kron_reuse=True is ignored") as port_w:
        tucker.plan(spec, device="cpu", engine=make_engine("torch", "cpu"))
    with pytest.warns(RuntimeWarning, match="use_kron_reuse=True is ignored") as ref_w:
        jtucker.plan(jtucker.TuckerSpec((10, 8, 6), (2, 2, 2), use_kron_reuse=True,
                                        engine="xla"), engine=jengine.make_engine("xla"))
    assert str(port_w[0].message) == str(ref_w[0].message)
    plain = tucker.TuckerSpec((10, 8, 6), (2, 2, 2), engine="torch")
    with pytest.warns(RuntimeWarning, match="overrides use_kron_reuse=False") as port_w:
        p = tucker.plan(plain, device="cpu",
                        engine=make_engine("torch", "cpu", use_kron_reuse=True))
    with pytest.warns(RuntimeWarning, match="overrides use_kron_reuse=False") as ref_w:
        jtucker.plan(jtucker.TuckerSpec((10, 8, 6), (2, 2, 2), engine="xla"),
                     engine=jengine.make_engine("xla", use_kron_reuse=True))
    assert str(port_w[0].message) == str(ref_w[0].message)
    assert not p.supports_batched_dispatch  # a prebuilt reuse engine: per-tensor dedup


def test_plan_reuse_kron_schedules_cached():
    ref_spec = jtucker.TuckerSpec(shape=(16, 14, 12), ranks=(3, 3, 2), method="gram",
                                  engine="xla", n_iter=2, use_kron_reuse=True)
    coo = jrandom(ref_spec.shape, 0.06, seed=53)
    ref_plan = jtucker.plan(ref_spec)
    ref_first, ref_second = ref_plan(coo), ref_plan(coo)
    spec = tucker.TuckerSpec(shape=(16, 14, 12), ranks=(3, 3, 2), method="gram",
                             engine="torch", n_iter=2, use_kron_reuse=True)
    p = tucker.plan(spec, device="cpu")
    tc = coo_from_numpy(np.asarray(coo.indices), np.asarray(coo.values), spec.shape)
    first = p(tc)
    assert first.schedule_builds == ref_first.schedule_builds > 0  # a dedup and its schedule a mode
    res = p(tc)
    assert res.schedule_builds == ref_second.schedule_builds == 0
    assert res.retraces == 0
    # other values on the same coordinates: the dedup stays
    again = p(SparseCOO(tc.indices, tc.values * 2, spec.shape))
    assert again.schedule_builds == 0


def test_kron_reuse_snapshot_parity(tmp_path):
    """The Kron-reuse engine rides the same segment skeleton: the snapshot
    run gives the unsegmented run's bits, and the reference's."""
    ref, spec, tc, f0 = _pair((16, 14, 12), (3, 3, 2), 0.06, 57, n_iter=5,
                              use_kron_reuse=True)
    whole = tucker.plan(spec, device="cpu")(tc, factors_init=f0)
    snap = dataclasses.replace(spec, snapshot=tucker.SnapshotSpec(every_n_sweeps=2,
                                                                 directory=str(tmp_path)))
    res = tucker.plan(snap, device="cpu")(tc, factors_init=f0)
    np.testing.assert_array_equal(res.fit_history, whole.fit_history)
    assert torch.equal(res.core, whole.core)
    assert res.snapshots_written > 0
    _assert_parity(res, ref)


def test_engine_for_spec_is_the_one_rule():
    spec = tucker.TuckerSpec((10, 8, 6), (2, 2, 2), use_kron_reuse=True)
    eng = tucker.engine_for_spec(spec, device="cpu")  # auto -> torch on the CPU
    assert eng.name == "torch" and eng.use_kron_reuse and eng.reuses_kron
    cuda = tucker.engine_for_spec(spec, resolved="cuda", device="cuda")  # no card needed
    assert cuda.use_kron_reuse and not cuda.reuses_kron
    # the card's torch engine takes the reuse chain too, and runs only with it
    assert tucker.engine_for_spec(spec, resolved="torch", device="cuda").reuses_kron
    with pytest.raises(ValueError, match="never selects"):
        tucker.engine_for_spec(dataclasses.replace(spec, use_kron_reuse=False),
                               resolved="torch", device="cuda")
    prebuilt = make_engine("torch", "cpu", use_kron_reuse=True)
    assert tucker.engine_for_spec(spec, prebuilt=prebuilt) is prebuilt
    with pytest.raises(ValueError, match="kron_reuse"):
        tucker.plan(tucker.TuckerSpec((10, 8, 6), (2, 2, 2), shard=tucker.ShardSpec(1)),
                    device="cpu", engine=prebuilt)


def test_plan_on_the_card_takes_the_torch_engine_with_reuse(monkeypatch):
    # building the plan touches no card: only its engines are checked here
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    spec = tucker.TuckerSpec((10, 8, 6), (2, 2, 2), engine="torch", use_kron_reuse=True)
    p = tucker.plan(spec, device="cuda:0")
    assert p.engine.name == "torch" and p.engine.reuses_kron
    assert not p.supports_batched_dispatch  # a reuse plan runs its batch member by member
    with pytest.raises(ValueError, match="never selects"):
        tucker.plan(dataclasses.replace(spec, use_kron_reuse=False), device="cuda:0")
