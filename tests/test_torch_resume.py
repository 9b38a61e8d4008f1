"""Snapshot and resume in repro_torch on the CPU (``TuckerSpec.snapshot``,
``tucker.resume``), against the reference's ``tests/test_resume.py``.

The contract: a snapshot spec runs the sweeps of the unsegmented loop in
segments of ``every_n_sweeps``, writing the carry to an atomic checkpoint
after each, so a run cut into segments, a run killed at a boundary and
resumed, and a run whose segment failed and was retried in place all give
the unsegmented run's fit history, factors and core bit for bit (the port
against itself). Against the reference, from the same numpy factors: the fit
within 1e-4, factor projectors within 1e-3 and the core within 1e-3 x
max|core| with signs aligned (``test_torch_tucker._assert_parity``'s
tolerances). Snapshots cross packages: a reference job killed mid-fit is
finished by the port, and a port snapshot loads in the reference.

Sharded jobs (``TuckerSpec.shard``, gloo ranks on the CPU, run by
``test_torch_shard.main("resume", ...)``): killed at a boundary and resumed
on the same 4 ranks, the uninterrupted 4-rank run's bits on every rank;
resumed on 2 ranks, and in this process on 1, with the spec's stale
``num_devices=4`` clamped under the reference's warning, within the
reference's own sharded bounds of it. Only rank 0 writes, and the manifest
holds the 4-rank mesh's fingerprint. The reference's
``test_sharded_kill_resume_same_device_count`` fails on this tree
(ROADMAP.md queue 3), so the port is held to its own runs here. Kron
reuse with snapshots: ``tests/test_torch_kron_reuse.py``.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro_torch.obs as obs
from repro import tucker as jtucker
from repro.core.coo import SparseCOO as JCOO
from repro.runtime.fault_tolerance import FailureInjector as JFailureInjector
from repro.sparse.generators import random_sparse_tensor as jrandom
from repro.tucker import snapshot as jsnapshot
from repro_torch import tucker
from repro_torch.convert import coo_from_numpy
from repro_torch.kernels import launch_count
from repro_torch.runtime.fault_tolerance import FailureInjector
from repro_torch.serve import ServiceConfig, TuckerService
from test_torch_batch import count_plain_launches
from test_torch_shard import (
    RESUME_KILL_AT,
    _finish,
    _resume_spec,
    _torch_problem,
    assert_within_own_bounds,
    start_port,
    summary,
)

SHAPE, RANKS, N_ITER, EVERY = (14, 12, 10), (3, 2, 2), 12, 5
KILL_AT = 5  # a segment boundary: the step-5 snapshot exists when it fires
CPU = {"device": "cpu"}


@pytest.fixture(autouse=True)
def _fresh_plans_and_trace():
    """Each test starts from an empty plan cache and an empty trace ring
    (the ring is process-wide: another test's spans must not leak in)."""
    tucker.clear_plan_cache()
    obs.tracer.clear()
    yield
    obs.configure(enabled=False)
    obs.tracer.clear()
    tucker.clear_plan_cache()


def _jcoo():
    full = jrandom(SHAPE, 0.25, seed=11)
    return JCOO(full.indices[:397], full.values[:397], SHAPE)


def _coo():
    j = _jcoo()
    return coo_from_numpy(np.asarray(j.indices), np.asarray(j.values), SHAPE)


def _f0():
    rng = np.random.default_rng(0)
    return [np.linalg.qr(rng.standard_normal((s, r)))[0].astype(np.float32)
            for s, r in zip(SHAPE, RANKS)]


def _snap(tmp_path, every=EVERY, **kw):
    return tucker.SnapshotSpec(every_n_sweeps=every, directory=str(tmp_path), **kw)


def _spec(tmp_path, *, tol=0.0, every=EVERY, n_iter=N_ITER, **snap_kw):
    return tucker.TuckerSpec(SHAPE, RANKS, method="gram", n_iter=n_iter, tol=tol,
                             snapshot=_snap(tmp_path, every, **snap_kw))


def _baseline(n_iter=N_ITER, tol=0.0):
    """The uninterrupted port run of the same problem, no snapshot spec."""
    spec = tucker.TuckerSpec(SHAPE, RANKS, method="gram", n_iter=n_iter, tol=tol)
    return tucker.plan(spec, **CPU)(_coo(), factors_init=_f0())


def _reference(n_iter=N_ITER, tol=0.0, engine="xla"):
    spec = jtucker.TuckerSpec(shape=SHAPE, ranks=RANKS, method="gram", engine=engine,
                              n_iter=n_iter, tol=tol)
    return jtucker.plan(spec)(_jcoo(), factors_init=[jnp.asarray(f) for f in _f0()])


def _assert_same_bits(res, ref):
    np.testing.assert_array_equal(res.fit_history, ref.fit_history)
    assert torch.equal(res.core, ref.core)
    assert all(torch.equal(a, b) for a, b in zip(res.factors, ref.factors))


def _assert_parity(res, ref):
    """Port ``res`` against reference ``ref``: the stated tolerances."""
    assert res.fit_history.shape == np.asarray(ref.fit_history).shape
    np.testing.assert_allclose(res.fit_history, ref.fit_history, rtol=0, atol=1e-4)
    core = res.core.numpy()
    for n, (a, b) in enumerate(zip(res.factors, ref.factors)):
        a, b = a.numpy(), np.asarray(b)
        np.testing.assert_allclose(a @ a.T, b @ b.T, rtol=0, atol=1e-3)
        sign = np.sign(np.sum(a * b, axis=0))
        core = core * sign.reshape([-1 if t == n else 1 for t in range(core.ndim)])
    scale = float(np.abs(np.asarray(ref.core)).max())
    np.testing.assert_allclose(core, np.asarray(ref.core), rtol=0, atol=1e-3 * scale)


# -- the spec ---------------------------------------------------------------------


@pytest.mark.parametrize("kwargs", [
    dict(every_n_sweeps=0, directory="d"), dict(every_n_sweeps=1, directory=""),
    dict(every_n_sweeps=1, directory="d", keep=0),
    dict(every_n_sweeps=1, directory="d", max_retries=-1),
    dict(directory="d"), dict(every_seconds=-1.0, directory="d"),
    dict(every_seconds=float("nan"), directory="d"),
    dict(every_n_sweeps=1, directory="d", retry_backoff_s=-1.0),
])
def test_snapshot_spec_validation_matches_the_reference(kwargs):
    with pytest.raises(ValueError) as port_err:
        tucker.SnapshotSpec(**kwargs)
    with pytest.raises(ValueError) as ref_err:
        jtucker.SnapshotSpec(**kwargs)
    assert str(port_err.value) == str(ref_err.value)


def test_snapshot_spec_wall_clock_cadence_validation():
    snap = tucker.SnapshotSpec(every_seconds=30.0, directory="d")
    assert snap.every_n_sweeps is None and snap.segment_len == 1
    both = tucker.SnapshotSpec(every_n_sweeps=3, every_seconds=1.5, directory="d")
    assert both.segment_len == 3 and both.every_seconds == 1.5
    assert dataclasses.asdict(both) == dataclasses.asdict(
        jtucker.SnapshotSpec(every_n_sweeps=3, every_seconds=1.5, directory="d"))


def test_tucker_spec_snapshot_constraints(tmp_path):
    snap = _snap(tmp_path, 2)
    for bad, says in ((dict(pipeline="python"), "pipeline='scan'"),
                      (dict(algorithm="dense"), "algorithm='sparse'"),
                      (dict(algorithm="complete"), "algorithm='sparse'")):
        with pytest.raises(ValueError, match=says):
            tucker.TuckerSpec(SHAPE, RANKS, snapshot=snap, **bad)
        with pytest.raises(ValueError, match=says):
            jtucker.TuckerSpec(shape=SHAPE, ranks=RANKS,
                               snapshot=jtucker.SnapshotSpec(every_n_sweeps=2,
                                                             directory=str(tmp_path)), **bad)
    # a snapshot job is one long fit: never batched
    assert not tucker.TuckerSpec(SHAPE, RANKS, snapshot=snap).supports_batched_dispatch
    with pytest.raises(TypeError, match="SnapshotSpec"):
        tucker.TuckerSpec(SHAPE, RANKS, snapshot={"every_n_sweeps": 2})
    with pytest.raises(TypeError, match="ShardSpec"):
        tucker.TuckerSpec(SHAPE, RANKS, snapshot=snap, shard=object())
    # a sharded snapshot job is one long fit too
    sharded = tucker.TuckerSpec(SHAPE, RANKS, snapshot=snap, shard=tucker.ShardSpec(1))
    assert not sharded.supports_batched_dispatch


def test_batch_rejects_snapshot_spec(tmp_path):
    plan = tucker.plan(_spec(tmp_path), **CPU)
    with pytest.raises(ValueError, match="checkpoint directory"):
        plan.batch([_coo(), _coo()])


def test_service_rejects_snapshot_spec(tmp_path):
    with TuckerService(ServiceConfig(max_batch=2, **CPU)) as svc:
        with pytest.raises(ValueError, match="snapshot"):
            svc.submit_coo(_coo(), _spec(tmp_path))


def test_resume_requires_snapshot_spec():
    with pytest.raises(ValueError, match="SnapshotSpec"):
        tucker.resume(tucker.TuckerSpec(SHAPE, RANKS), _coo(), **CPU)
    with pytest.raises(ValueError, match="snapshot"):
        tucker.plan(tucker.TuckerSpec(SHAPE, RANKS), **CPU)(_coo(), injector=FailureInjector())


# -- the segmented run against the unsegmented one and the reference ----------------


@pytest.mark.parametrize("engine", ["xla", "pallas"])
def test_snapshot_run_matches_uninterrupted(tmp_path, engine):
    """12 sweeps at every=5: 3 segments, 4 snapshots (steps 0, 5, 10, 12, of
    which 3 are kept), the unsegmented run's bits; the reference's run
    within tolerance on its xla and pallas (interpret) engines."""
    res = tucker.plan(_spec(tmp_path), **CPU)(_coo(), factors_init=_f0())
    _assert_same_bits(res, _baseline())
    _assert_parity(res, _reference(engine=engine))
    assert res.dispatches == 3  # ceil(12 / 5)
    assert res.snapshots_written == 4
    assert res.resumed_from_sweep is None and res.retries == 0
    assert tucker.load_snapshot(str(tmp_path)).sweeps_done == N_ITER
    from repro_torch.checkpoint.manager import CheckpointManager

    assert CheckpointManager(str(tmp_path)).all_steps() == [5, 10, 12]


def test_segments_launch_as_the_unsegmented_run_and_build_once(tmp_path, monkeypatch):
    """The port's no-retrace rule: every kernel launches as often as in the
    unsegmented run (the plain versions count as their kernels would), the
    schedules are built in the first segment only, and a resume through the
    warm plan builds none."""
    count_plain_launches(monkeypatch)
    coo = _coo()
    t0 = launch_count.tally()
    base = tucker.plan(tucker.TuckerSpec(SHAPE, RANKS, method="gram", n_iter=N_ITER),
                       **CPU)(coo, factors_init=_f0())
    base_launches = launch_count.since(t0)
    obs.configure(enabled=True)
    spec = _spec(tmp_path)
    t0 = launch_count.tally()
    res = tucker.plan(spec, **CPU)(coo, factors_init=_f0())
    assert launch_count.since(t0) == base_launches and res.launches == base.launches > 0
    segs = [e for e in obs.tracer.events()
            if e.name == "sweep.dispatch" and e.attrs.get("program") == "segment"]
    assert [e.attrs["sweeps_done"] for e in segs] == [0, 5, 10]
    assert res.schedule_builds == base.schedule_builds == 3
    # no build after the first segment: the later segments' launches need none
    plan = tucker.plan(spec, **CPU)
    assert plan.engine.schedule_builds == 3
    with pytest.raises(RuntimeError, match="injected"):
        plan(coo, factors_init=_f0(), injector=FailureInjector([KILL_AT]))
    resumed = tucker.resume(spec, coo, **CPU)
    assert resumed.schedule_builds == 0 and plan.engine.schedule_builds == 3


def test_kill_and_resume_matches_uninterrupted(tmp_path):
    """Kill at sweep KILL_AT, resume from the snapshot: the final state is
    the uninterrupted run's, bit for bit."""
    spec, coo = _spec(tmp_path), _coo()
    with pytest.raises(RuntimeError, match="injected failure"):
        tucker.plan(spec, **CPU)(coo, factors_init=_f0(),
                                 injector=FailureInjector(fail_at=[KILL_AT]))
    res = tucker.resume(spec, coo, **CPU)
    _assert_same_bits(res, _baseline())
    _assert_parity(res, _reference())
    assert res.resumed_from_sweep == KILL_AT
    assert res.dispatches == 2  # sweeps 5..10, 10..12
    assert res.schedule_builds == 0  # the killed run's plan serves the resume
    assert res.n_sweeps == N_ITER


def test_retry_in_place(tmp_path):
    """max_retries > 0: a transient segment failure is retried (the one-shot
    injector fires once) and the job completes with the same bits."""
    spec = _spec(tmp_path, max_retries=2, retry_backoff_s=0.0)
    before = obs.registry.counter("repro_retries_total").value
    res = tucker.plan(spec, **CPU)(_coo(), factors_init=_f0(),
                                   injector=FailureInjector(fail_at=[KILL_AT]))
    _assert_same_bits(res, _baseline())
    assert res.retries == 1
    assert obs.registry.counter("repro_retries_total").value == before + 1


def test_tol_early_exit_with_snapshots(tmp_path):
    """The tol early exit fires as in the unsegmented run, across a segment
    boundary, and no segment runs after it."""
    tol = 1e-3
    ref = _baseline(tol=tol)
    assert ref.n_sweeps < N_ITER
    res = tucker.plan(_spec(tmp_path, tol=tol, every=2), **CPU)(_coo(), factors_init=_f0())
    _assert_same_bits(res, ref)
    assert res.dispatches == -(-ref.n_sweeps // 2)
    jref = _reference(tol=tol)
    assert res.n_sweeps == jref.n_sweeps
    _assert_parity(res, jref)
    state = tucker.load_snapshot(str(tmp_path))
    assert state.done and state.sweeps_done == ref.n_sweeps


def test_resume_of_completed_job_is_a_noop(tmp_path):
    spec, coo = _spec(tmp_path), _coo()
    done = tucker.plan(spec, **CPU)(coo, factors_init=_f0())
    res = tucker.resume(spec, coo, **CPU)
    _assert_same_bits(res, done)
    assert res.dispatches == 0 and res.snapshots_written == 0
    assert res.resumed_from_sweep == N_ITER


def test_resume_rejects_mismatched_problem(tmp_path):
    spec, coo = _spec(tmp_path), _coo()
    tucker.plan(spec, **CPU)(coo, factors_init=_f0())
    with pytest.raises(ValueError, match="ranks"):
        tucker.resume(dataclasses.replace(spec, ranks=(2, 2, 2)), coo, **CPU)
    with pytest.raises(ValueError, match="method"):
        tucker.resume(dataclasses.replace(spec, method="svd"), coo, **CPU)


def test_resume_with_no_checkpoint_raises(tmp_path):
    with pytest.raises(FileNotFoundError):
        tucker.resume(_spec(tmp_path / "nothing-here"), _coo(), **CPU)


def test_crash_mid_save_leaves_resumable_state(tmp_path):
    """A torn tmp dir from a crashed save neither blocks nor corrupts a
    resume: the manager sweeps it and the latest complete snapshot wins."""
    spec, coo = _spec(tmp_path), _coo()
    with pytest.raises(RuntimeError):
        tucker.plan(spec, **CPU)(coo, factors_init=_f0(),
                                 injector=FailureInjector(fail_at=[KILL_AT]))
    torn = tmp_path / "step_00000007.tmp"
    torn.mkdir()
    (torn / "shard_00000.npz").write_bytes(b"not an npz")
    res = tucker.resume(spec, coo, **CPU)
    _assert_same_bits(res, _baseline())
    assert not torn.exists()


def test_wall_clock_cadence_gates_interval_spills(tmp_path):
    """A huge every_seconds writes only the initial and final snapshots;
    0.0 writes every boundary; the final state is the same."""
    def run(sub, **snap_kw):
        spec = tucker.TuckerSpec(SHAPE, RANKS, method="gram", n_iter=4,
                                 snapshot=tucker.SnapshotSpec(directory=str(tmp_path / sub),
                                                              **snap_kw))
        return tucker.plan(spec, **CPU)(_coo(), factors_init=_f0())

    sparse_res = run("sparse", every_n_sweeps=1, every_seconds=1e9)
    assert sparse_res.n_sweeps == 4 and sparse_res.snapshots_written == 2
    dense_res = run("dense", every_n_sweeps=1, every_seconds=0.0)
    assert dense_res.snapshots_written == 5
    _assert_same_bits(sparse_res, dense_res)
    state = tucker.load_snapshot(str(tmp_path / "sparse"))
    assert state.sweeps_done == 4 and state.meta["spec"]["every_seconds"] == 1e9


def test_wall_clock_skip_decisions_traced(tmp_path):
    """Skipped boundaries are snapshot.skip events; each spill carries its
    decision; the segments are sweep.dispatch spans of program 'segment'."""
    obs.configure(enabled=True)
    spec = tucker.TuckerSpec(SHAPE, RANKS, method="gram", n_iter=3,
                             snapshot=tucker.SnapshotSpec(every_n_sweeps=1, every_seconds=1e9,
                                                          directory=str(tmp_path)))
    res = tucker.plan(spec, **CPU)(_coo())
    evs = obs.tracer.events()
    assert [e.attrs["decision"] for e in evs if e.name == "snapshot.spill"] == [
        "initial", "final"]
    skips = [e for e in evs if e.name == "snapshot.skip"]
    assert len(skips) == 2 and all(s.attrs["decision"] == "wall-clock" for s in skips)
    assert [e.attrs["program"] for e in evs if e.name == "sweep.dispatch"] == ["segment"] * 3
    assert res.trace_summary is not None and "snapshot.spill" in res.trace_summary


def test_snapshots_written_counter(tmp_path):
    c = obs.registry.counter("repro_snapshots_written_total")
    before = c.value
    res = tucker.plan(_spec(tmp_path), **CPU)(_coo())
    assert c.value == before + res.snapshots_written == before + 4


# -- across the two packages ------------------------------------------------------------


def test_reference_job_resumed_by_the_port(tmp_path):
    """A reference job killed at sweep 2 (its step-2 snapshot on disk) is
    finished by the port, within tolerance of both uninterrupted runs."""
    jspec = jtucker.TuckerSpec(shape=SHAPE, ranks=RANKS, method="gram", engine="xla",
                               n_iter=6, snapshot=jtucker.SnapshotSpec(
                                   every_n_sweeps=2, directory=str(tmp_path)))
    with pytest.raises(RuntimeError, match="injected"):
        jtucker.plan(jspec)(_jcoo(), factors_init=[jnp.asarray(f) for f in _f0()],
                            injector=JFailureInjector(fail_at=[2]))
    spec = _spec(tmp_path, every=2, n_iter=6)
    res = tucker.resume(spec, _coo(), **CPU)
    assert res.resumed_from_sweep == 2 and res.n_sweeps == 6 and res.dispatches == 2
    _assert_parity(res, _reference(n_iter=6))
    ref = _baseline(n_iter=6)
    np.testing.assert_allclose(res.fit_history, ref.fit_history, rtol=0, atol=1e-4)
    for a, b in zip(res.factors, ref.factors):
        np.testing.assert_allclose((a @ a.T).numpy(), (b @ b.T).numpy(), rtol=0, atol=1e-3)


def test_port_snapshot_loads_in_the_reference(tmp_path):
    """A port snapshot directory read by the reference's load_snapshot gives
    the same SnapshotState fields as the port's own loader."""
    spec = _spec(tmp_path, every=2, n_iter=6)
    with pytest.raises(RuntimeError):
        tucker.plan(spec, **CPU)(_coo(), factors_init=_f0(),
                                 injector=FailureInjector(fail_at=[4]))
    mine = tucker.load_snapshot(str(tmp_path))
    theirs = jsnapshot.load_snapshot(str(tmp_path))
    assert mine.sweeps_done == theirs.sweeps_done == 4 and mine.step == theirs.step == 4
    assert mine.done == theirs.done is False
    assert mine.prev_err == theirs.prev_err == mine.fit_history[-1]
    assert mine.fit_history == theirs.fit_history and len(mine.fit_history) == 4
    assert mine.meta == theirs.meta and mine.meta["kind"] == "tucker-sweep"
    np.testing.assert_array_equal(mine.core, np.asarray(theirs.core))
    for a, b in zip(mine.factors, theirs.factors):
        np.testing.assert_array_equal(a, np.asarray(b))
    # and the reference can finish the port's job
    jspec = jtucker.TuckerSpec(shape=SHAPE, ranks=RANKS, method="gram", engine="xla",
                               n_iter=6, snapshot=jtucker.SnapshotSpec(
                                   every_n_sweeps=2, directory=str(tmp_path)))
    jres = jtucker.resume(jspec, _jcoo())
    assert jres.resumed_from_sweep == 4
    _assert_parity(_baseline(n_iter=6), jres)


# -- sharded jobs -------------------------------------------------------------------


@pytest.fixture(scope="module")
def sharded_jobs(tmp_path_factory):
    """The 4-rank kill/resume and the 2-rank resume, in one subprocess; the
    job left for this process's own resume sits in ``tmp``."""
    tmp = str(tmp_path_factory.mktemp("sharded-jobs"))
    return tmp, _finish(start_port("resume", tmp))


def test_sharded_kill_and_resume_on_the_same_world_is_bit_for_bit(sharded_jobs):
    _, out = sharded_jobs
    ranks = out["kill"]
    want = ranks[0]["uninterrupted"]["digest"]
    for r in ranks:
        assert r["killed"] == [True, True, True]
        assert r["uninterrupted"]["digest"] == want
        res = r["resumed"]
        assert res["digest"] == want
        assert res["resumed_from"] == RESUME_KILL_AT and res["n_sweeps"] == 12
        assert res["dispatches"] == 2  # sweeps 5-10 and 10-12
        # the killed run's plan kept its slice and schedules: no build on resume
        assert res["schedule_builds"] == 0
        assert res["collective_bytes_per_sweep"] == ranks[0]["uninterrupted"][
            "collective_bytes_per_sweep"]
    fp = ranks[0]["fingerprint"]
    assert fp == "gloo:cpu,cpu,cpu,cpu/nnz=4"
    assert ranks[0]["manifest_mesh"] == fp
    # rank 0 alone writes: steps 0 and 5 of three killed jobs, then 10 and 12
    assert ranks[0]["saves"] == [0, 5] * 3 + [10, 12]
    assert all(r["saves"] == [] for r in ranks[1:])


def test_sharded_resume_on_fewer_ranks_clamps_with_the_warning(sharded_jobs):
    _, out = sharded_jobs
    want = out["kill"][0]["uninterrupted"]
    ranks = out["fewer"]
    assert len({r["resumed"]["digest"] for r in ranks}) == 1
    for r in ranks:
        assert r["world"] == 2
        assert any(w.startswith("resuming a 4-device job on 2 attached device(s): clamping")
                   for w in r["warned"])
        assert r["resumed"]["resumed_from"] == RESUME_KILL_AT
        assert_within_own_bounds(r["resumed"], want)
    assert ranks[0]["saves"] == [10, 12] and ranks[1]["saves"] == []


def test_sharded_resume_in_one_process_clamps_to_a_world_of_one(sharded_jobs):
    tmp, out = sharded_jobs
    coo, _ = _torch_problem()
    with pytest.warns(RuntimeWarning, match="resuming a 4-device job"):
        res = tucker.resume(_resume_spec(f"{tmp}/job3", 4), coo, **CPU)
    assert res.spec.shard.num_devices == 1 and res.resumed_from_sweep == RESUME_KILL_AT
    assert_within_own_bounds(summary(res), out["kill"][0]["uninterrupted"])
    manifest = jsnapshot.load_snapshot(f"{tmp}/job3").meta
    assert manifest["mesh"] == "none:cpu/nnz=1"  # the resumed job's last writer
