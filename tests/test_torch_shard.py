"""Sharded sparse HOOI in repro_torch (``TuckerSpec.shard``) on the CPU,
against the reference's sharded runs.

The port's ranks are CPU processes over gloo (``torch.multiprocessing``
with the spawn start method, a ``FileStore``, a group timeout so that a
rank that dies fails the run instead of hanging it); the reference runs in
one process with ``XLA_FLAGS=--xla_force_host_platform_device_count=4``,
as its own ``tests/test_shard_pipeline.py`` does. Each side runs in a
subprocess started once per module, which computes its whole matrix and
prints one JSON report; both take the same numpy tensor (18 x 15 x 12, 397
ragged nonzeros: neither 2 nor 4 divides them) and the same numpy initial
factors.

The contract, for 1, 2 and 4 ranks x ``svd``, ``gram`` and
``householder``:
  * port sharded against reference sharded: fit 1e-4, factor projectors
    1e-3, core 1e-3 x max|core| with the factor signs matched;
  * port sharded against the port unsharded: the reference's own bounds
    (fit 1e-5, core and factors 5e-4); one rank gives the unsharded bits;
  * every rank holds the same bits (no broadcast in the sweeps: the
    all-reduce gives each rank the same sum, so QRP gives each the same
    factors), and ranks seeded apart sweep rank 0's initial factors (the
    one broadcast a call);
  * one dispatch, ``collective_bytes_per_sweep`` as recomputed here, the
    shard imbalance, a plan-cache hit over the same group that runs no
    collective, new values on the same indices (no new slice, and the core
    scales), ``tol`` parity.

The runners below (``main``, the ``_rank_*`` functions) run in the
subprocesses; ``tests/test_torch_resume.py`` runs the "resume" scenario.
"""
import datetime
import hashlib
import importlib
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]

SHAPE, RANKS, N_ITER = (18, 15, 12), (3, 2, 2), 3
WORLDS = (1, 2, 4)
METHODS = ("svd", "gram", "householder")
RAGGED_NNZ = 397
PAD_TARGET = 1024  # 4 shards of 256 slots: the last holds no real nonzero
TOL, TOL_ITER = 1e-3, 10
SCALE = 1.7
GROUP_TIMEOUT_S = 120
# the resume scenario: 12 sweeps in segments of 5, killed at the step-5 boundary
RESUME_ITER, RESUME_EVERY, RESUME_KILL_AT = 12, 5, 5


def problem():
    """The numpy tensor and initial factors both sides take."""
    rng = np.random.default_rng(11)
    lin = rng.choice(int(np.prod(SHAPE)), RAGGED_NNZ, replace=False)
    idx = np.stack(np.unravel_index(lin, SHAPE), axis=1).astype(np.int32)
    vals = rng.uniform(0.1, 1.0, RAGGED_NNZ).astype(np.float32)
    f0 = [np.linalg.qr(rng.standard_normal((s, r)))[0].astype(np.float32)
          for s, r in zip(SHAPE, RANKS)]
    return idx, vals, f0


def psum_bytes(shape, ranks, itemsize=4):
    """N all-reduces of I_n x prod_{t != n} R_t, recomputed here rather
    than trusted from either package."""
    return sum(dim * int(np.prod([r for t, r in enumerate(ranks) if t != m])) * itemsize
               for m, dim in enumerate(shape))


# -- the subprocesses ------------------------------------------------------------


def _torch_problem():
    from repro_torch.core.coo import SparseCOO

    idx, vals, f0 = problem()
    return SparseCOO.from_parts(idx, vals, SHAPE), [torch.from_numpy(f) for f in f0]


def _spec(method="gram", world=None, **kw):
    from repro_torch import tucker

    kw.setdefault("n_iter", N_ITER)
    shard = tucker.ShardSpec(num_devices=world) if world else None
    return tucker.TuckerSpec(shape=SHAPE, ranks=RANKS, method=method, shard=shard, **kw)


def summary(res, values=True) -> dict:
    """A result's counters, a digest of its bits, and (``values``) its
    fit, factors and core as lists."""
    h = hashlib.sha256(np.asarray(res.fit_history, dtype=np.float32).tobytes())
    for t in list(res.factors) + [res.core]:
        h.update(t.detach().cpu().numpy().tobytes())
    out = {"digest": h.hexdigest(), "n_sweeps": res.n_sweeps, "dispatches": res.dispatches,
           "schedule_builds": res.schedule_builds, "retraces": res.retraces,
           "collective_bytes_per_sweep": res.collective_bytes_per_sweep,
           "shard_imbalance": res.shard_imbalance, "resumed_from": res.resumed_from_sweep,
           "snapshots_written": res.snapshots_written}
    if values:
        out.update(fit=np.asarray(res.fit_history).tolist(),
                   factors=[f.cpu().numpy().tolist() for f in res.factors],
                   core=res.core.cpu().numpy().tolist())
    return out


def _init(rank: int, world: int, store: str) -> None:
    import torch.distributed as dist

    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(store, world), rank=rank,
                            world_size=world,
                            timeout=datetime.timedelta(seconds=GROUP_TIMEOUT_S))


def _write(tmp: str, name: str, rank: int, out: dict) -> None:
    Path(tmp, f"{name}-r{rank}.json").write_text(json.dumps(out))


def _rank_matrix(rank: int, world: int, store: str, tmp: str) -> None:
    """One rank of a ``world``-rank group: the matrix of methods, and the
    counters' cases."""
    import torch.distributed as dist

    from repro_torch import tucker
    from repro_torch.core.coo import SparseCOO

    _init(rank, world, store)
    gathers = _count_gathers()
    coo, f0 = _torch_problem()
    out = {"cases": {}}
    for method in METHODS:
        spec = _spec(method, world)
        p = tucker.plan(spec, device="cpu")
        case = summary(p(coo, factors_init=f0))
        before = len(gathers)
        case["cache_hit"] = tucker.plan(spec, device="cpu") is p
        case["cache_hit_gathers"] = len(gathers) - before
        case["unsharded"] = summary(tucker.plan(_spec(method), device="cpu")(
            coo, factors_init=f0))
        out["cases"][method] = case
    p = tucker.plan(_spec("gram", world), device="cpu")
    base = p(coo, factors_init=f0)
    scaled = p(SparseCOO(coo.indices, coo.values * SCALE, SHAPE), factors_init=f0)
    out["value_change"] = {
        "schedule_builds": scaled.schedule_builds,
        "core_scaling_maxdiff": float((scaled.core - SCALE * base.core).abs().max()),
    }
    # ranks that seed apart, or pass factors of their own, sweep rank 0's
    out["seeded_apart"] = summary(p(coo, generator=torch.Generator().manual_seed(rank)),
                                  values=False)["digest"]
    out["seeded_0"] = summary(p(coo, generator=torch.Generator().manual_seed(0)),
                              values=False)["digest"]
    own = [f if rank == 0 else torch.roll(f, rank, 0) for f in f0]
    out["init_apart"] = summary(p(coo, factors_init=own), values=False)["digest"]
    padded = p.batch([coo], pad_nnz_to=PAD_TARGET, factors_init=[f0])[0]
    out["pad"] = {"imbalance": padded.shard_imbalance,
                  "fit_maxdiff": float(np.abs(padded.fit_history - base.fit_history).max())}
    a = tucker.plan(_spec("gram", n_iter=TOL_ITER, tol=TOL), device="cpu")(coo, factors_init=f0)
    b = tucker.plan(_spec("gram", world, n_iter=TOL_ITER, tol=TOL), device="cpu")(
        coo, factors_init=f0)
    out["tol"] = {"unsharded_sweeps": a.n_sweeps, "sharded_sweeps": b.n_sweeps,
                  "fit_maxdiff": float(np.abs(a.fit_history - b.fit_history).max())}
    _write(tmp, f"matrix-{world}", rank, out)
    dist.destroy_process_group()


def _count_gathers():
    """Record each ``all_gather_object`` of this process (a mesh build)."""
    import torch.distributed as dist

    calls = []
    real = dist.all_gather_object

    def gather(*args, **kwargs):
        calls.append(1)
        return real(*args, **kwargs)

    dist.all_gather_object = gather
    return calls


def _count_saves():
    """Record each checkpoint write of this process (step numbers)."""
    from repro_torch.checkpoint.manager import CheckpointManager

    saves = []
    real = CheckpointManager.save

    def save(self, step, state, extra=None):
        saves.append(int(step))
        return real(self, step, state, extra=extra)

    CheckpointManager.save = save
    return saves


def _resume_spec(directory: str, world: int):
    from repro_torch import tucker

    return _spec("gram", world, n_iter=RESUME_ITER, snapshot=tucker.SnapshotSpec(
        every_n_sweeps=RESUME_EVERY, directory=directory))


def _rank_kill(rank: int, world: int, store: str, tmp: str) -> None:
    """4 ranks: the uninterrupted run; job 1 killed and resumed on the same
    world; jobs 2 and 3 killed and left for fewer ranks."""
    import torch.distributed as dist

    from repro_torch import tucker
    from repro_torch.checkpoint.manager import CheckpointManager
    from repro_torch.runtime.fault_tolerance import FailureInjector

    _init(rank, world, store)
    saves = _count_saves()
    coo, f0 = _torch_problem()
    out = {"uninterrupted": summary(tucker.plan(_spec("gram", world, n_iter=RESUME_ITER),
                                                device="cpu")(coo, factors_init=f0))}
    killed = []
    for job in ("job1", "job2", "job3"):
        spec = _resume_spec(os.path.join(tmp, job), world)
        try:
            tucker.plan(spec, device="cpu")(coo, factors_init=f0,
                                            injector=FailureInjector([RESUME_KILL_AT]))
            killed.append(False)
        except RuntimeError as exc:
            killed.append("injected failure" in str(exc))
    dist.barrier()
    out["killed"] = killed
    out["manifest_mesh"] = CheckpointManager(os.path.join(tmp, "job2")).read_manifest()[
        "extra"]["mesh"] if rank == 0 else None
    out["fingerprint"] = tucker.mesh_fingerprint(tucker.mesh_for_shard(
        tucker.ShardSpec(world), device="cpu"))
    out["resumed"] = summary(tucker.resume(_resume_spec(os.path.join(tmp, "job1"), world),
                                           coo, device="cpu"))
    out["saves"] = saves
    _write(tmp, "kill", rank, out)
    dist.destroy_process_group()


def _rank_resume_fewer(rank: int, world: int, store: str, tmp: str) -> None:
    """2 ranks: job 2, snapshotted by 4, resumed here with its spec's
    stale ``num_devices=4``."""
    import warnings

    import torch.distributed as dist

    from repro_torch import tucker

    _init(rank, world, store)
    saves = _count_saves()
    coo, _ = _torch_problem()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        res = tucker.resume(_resume_spec(os.path.join(tmp, "job2"), 4), coo, device="cpu")
    out = {"resumed": summary(res), "warned": [str(w.message) for w in caught
                                               if issubclass(w.category, RuntimeWarning)],
           "world": res.spec.shard.num_devices, "saves": saves}
    _write(tmp, "fewer", rank, out)
    dist.destroy_process_group()


def _rank_lost(rank: int, world: int, store: str, tmp: str) -> None:
    """Both ranks build the plan (a collective); rank 1 then leaves, and
    rank 0 runs it alone: its first all-reduce finds the peer gone (or
    times out) and raises."""
    from repro_torch import tucker

    _init(rank, world, store)
    coo, f0 = _torch_problem()
    p = tucker.plan(_spec("gram", world), device="cpu")
    if rank == 1:
        os._exit(0)
    out = {"raised": None, "result": None}
    try:
        out["result"] = summary(p(coo, factors_init=f0), values=False)
    except RuntimeError as exc:
        out["raised"] = f"{type(exc).__name__}: {str(exc)[:200]}"
    _write(tmp, "lost", rank, out)
    os._exit(0)


def _spawn(fn, world: int, tmp: str) -> None:
    import torch.multiprocessing as mp

    store = os.path.join(tmp, f"store-{fn.__name__}-{world}")
    mp.start_processes(fn, args=(world, store, tmp), nprocs=world, start_method="spawn")


def _gather(tmp: str, name: str, world: int) -> list:
    return [json.loads(Path(tmp, f"{name}-r{r}.json").read_text()) for r in range(world)]


def main(scenario: str, tmp: str) -> None:
    """The port's side, in a subprocess: spawn the ranks of each world and
    print their reports as one JSON line."""
    if scenario == "matrix":
        out = {}
        for world in WORLDS:
            _spawn(_rank_matrix, world, tmp)
            out[str(world)] = _gather(tmp, f"matrix-{world}", world)
    elif scenario == "fail":
        _spawn(_rank_lost, 2, tmp)
        out = _gather(tmp, "lost", 1)[0]
    elif scenario == "resume":
        _spawn(_rank_kill, 4, tmp)
        _spawn(_rank_resume_fewer, 2, tmp)
        out = {"kill": _gather(tmp, "kill", 4), "fewer": _gather(tmp, "fewer", 2)}
    else:
        raise ValueError(f"unknown scenario {scenario!r}")
    print(json.dumps(out))


def reference_matrix() -> None:
    """The reference's side, in a subprocess with 4 forced host devices:
    the sharded plan for each world and method from the same factors."""
    import jax
    import jax.numpy as jnp

    from repro import tucker as jtucker
    from repro.core.coo import SparseCOO as JCOO

    idx, vals, f0 = problem()
    coo = JCOO(jnp.asarray(idx), jnp.asarray(vals), SHAPE)
    out = {"n_devices": len(jax.devices()), "cases": {}}
    for world in WORLDS:
        for method in METHODS:
            spec = jtucker.TuckerSpec(shape=SHAPE, ranks=RANKS, method=method, n_iter=N_ITER,
                                      shard=jtucker.ShardSpec(num_devices=world))
            res = jtucker.plan(spec)(coo, factors_init=[jnp.asarray(f) for f in f0])
            out["cases"][f"{world}/{method}"] = {
                "fit": np.asarray(res.fit_history).tolist(),
                "factors": [np.asarray(f).tolist() for f in res.factors],
                "core": np.asarray(res.core).tolist(),
            }
    print(json.dumps(out))


def _start(code: str, env_extra: dict) -> subprocess.Popen:
    env = dict(os.environ, **env_extra)
    env["PYTHONPATH"] = os.pathsep.join([str(ROOT / "src"), str(ROOT / "tests")])
    return subprocess.Popen([sys.executable, "-c", code], env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)


def _finish(proc: subprocess.Popen, timeout: float = 600) -> dict:
    try:
        out, err = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        proc.kill()
        out, err = proc.communicate()
        raise AssertionError(f"timed out after {timeout} s: {err[-3000:]}")
    assert proc.returncode == 0, err[-4000:]
    return json.loads(out.strip().splitlines()[-1])


def start_port(scenario: str, tmp: str) -> subprocess.Popen:
    return _start(f"import test_torch_shard as t; t.main({scenario!r}, {tmp!r})", {})


@pytest.fixture(scope="module")
def reports(tmp_path_factory):
    """Both sides' matrices, their subprocesses run side by side."""
    port = start_port("matrix", str(tmp_path_factory.mktemp("port-shard")))
    ref = _start("import test_torch_shard as t; t.reference_matrix()",
                 {"XLA_FLAGS": "--xla_force_host_platform_device_count=4",
                  "JAX_PLATFORMS": "cpu"})
    return {"port": _finish(port), "ref": _finish(ref)}


def _as_arrays(case: dict):
    return (np.asarray(case["fit"]), [np.asarray(f, dtype=np.float32) for f in case["factors"]],
            np.asarray(case["core"], dtype=np.float32))


def assert_within_reference_tolerances(got: dict, want: dict) -> None:
    """Fit 1e-4, factor projectors 1e-3, core 1e-3 x max|core| once the
    factor columns' signs are matched."""
    fit, fs, core = _as_arrays(got)
    wfit, wfs, wcore = _as_arrays(want)
    assert fit.shape == wfit.shape
    np.testing.assert_allclose(fit, wfit, rtol=0, atol=1e-4)
    for n, (a, b) in enumerate(zip(fs, wfs)):
        np.testing.assert_allclose(a @ a.T, b @ b.T, rtol=0, atol=1e-3)
        sign = np.sign(np.sum(a * b, axis=0))
        core = core * sign.reshape([-1 if t == n else 1 for t in range(core.ndim)])
    np.testing.assert_allclose(core, wcore, rtol=0, atol=1e-3 * np.abs(wcore).max())


def assert_within_own_bounds(got: dict, want: dict) -> None:
    """The reference's bounds for sharded against unsharded: fit 1e-5, core
    and factors 5e-4."""
    fit, fs, core = _as_arrays(got)
    wfit, wfs, wcore = _as_arrays(want)
    assert fit.shape == wfit.shape
    assert np.abs(fit - wfit).max() < 1e-5
    assert np.abs(core - wcore).max() < 5e-4
    assert max(np.abs(a - b).max() for a, b in zip(fs, wfs)) < 5e-4


# -- the matrix ------------------------------------------------------------------


def test_reference_ran_on_four_forced_devices(reports):
    assert reports["ref"]["n_devices"] == 4
    assert sorted(reports["port"]) == sorted(str(w) for w in WORLDS)


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("method", METHODS)
def test_sharded_matches_the_reference_sharded(reports, world, method):
    got = reports["port"][str(world)][0]["cases"][method]
    assert_within_reference_tolerances(got, reports["ref"]["cases"][f"{world}/{method}"])
    assert got["n_sweeps"] == N_ITER


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("method", METHODS)
def test_sharded_matches_the_port_unsharded(reports, world, method):
    case = reports["port"][str(world)][0]["cases"][method]
    assert_within_own_bounds(case, case["unsharded"])


@pytest.mark.parametrize("method", METHODS)
def test_one_rank_gives_the_unsharded_bits(reports, method):
    case = reports["port"]["1"][0]["cases"][method]
    assert case["digest"] == case["unsharded"]["digest"]


@pytest.mark.parametrize("world", WORLDS)
def test_every_rank_holds_the_same_bits(reports, world):
    ranks = reports["port"][str(world)]
    assert len(ranks) == world
    for method in METHODS:
        assert len({r["cases"][method]["digest"] for r in ranks}) == 1
        # the unsharded runs of each rank agree too: the same process setup
        assert len({r["cases"][method]["unsharded"]["digest"] for r in ranks}) == 1


@pytest.mark.parametrize("world", WORLDS)
def test_one_dispatch_collective_bytes_and_imbalance(reports, world):
    want_bytes = psum_bytes(SHAPE, RANKS)
    for rank in reports["port"][str(world)]:
        for method in METHODS:
            c = rank["cases"][method]
            assert c["dispatches"] == 1 and c["retraces"] == 0
            assert c["collective_bytes_per_sweep"] == want_bytes
            assert c["unsharded"]["collective_bytes_per_sweep"] is None
            assert c["unsharded"]["shard_imbalance"] is None
            if RAGGED_NNZ % world == 0:
                assert c["shard_imbalance"] == 0.0
            else:
                assert 0.0 < c["shard_imbalance"] < 0.2


@pytest.mark.parametrize("world", WORLDS)
def test_replan_over_the_same_group_is_a_cache_hit(reports, world):
    assert all(r["cases"][m]["cache_hit"] for r in reports["port"][str(world)] for m in METHODS)


@pytest.mark.parametrize("world", WORLDS)
def test_a_cache_hit_runs_no_collective(reports, world):
    for r in reports["port"][str(world)]:
        assert [r["cases"][m]["cache_hit_gathers"] for m in METHODS] == [0] * len(METHODS)


@pytest.mark.parametrize("world", WORLDS)
def test_ranks_seeded_apart_sweep_rank_0s_factors(reports, world):
    ranks = reports["port"][str(world)]
    for r in ranks:
        assert r["seeded_apart"] == ranks[0]["seeded_0"]
        assert r["init_apart"] == ranks[0]["cases"]["gram"]["digest"]


@pytest.mark.parametrize("world", WORLDS)
def test_new_values_take_no_new_slice_and_scale_the_core(reports, world):
    for rank in reports["port"][str(world)]:
        vc = rank["value_change"]
        assert vc["schedule_builds"] == 0
        assert vc["core_scaling_maxdiff"] < 5e-4


@pytest.mark.parametrize("world", WORLDS)
def test_pad_target_keeps_the_imbalance_honest(reports, world):
    pad = reports["port"][str(world)][0]["pad"]
    assert pad["fit_maxdiff"] < 1e-5
    # 397 real nonzeros padded to 1024: one shard holds them all, or 2
    # shards of 512 hold 397 and 0, or 4 of 256 hold 256, 141, 0 and 0
    assert pad["imbalance"] == {1: 0.0, 2: 1.0, 4: 1.0}[world]


@pytest.mark.parametrize("world", WORLDS)
def test_tol_early_exit_parity(reports, world):
    t = reports["port"][str(world)][0]["tol"]
    assert t["sharded_sweeps"] == t["unsharded_sweeps"] < TOL_ITER
    assert t["fit_maxdiff"] < 1e-5


# -- in process ------------------------------------------------------------------


@pytest.mark.parametrize("kwargs", [dict(num_devices=0), dict(num_devices=1, axis=""),
                                    dict(num_devices=1, factor_policy="sharded")])
def test_shard_spec_validation_matches_the_reference(kwargs):
    from repro import tucker as jtucker
    from repro_torch import tucker

    with pytest.raises(ValueError) as want:
        jtucker.ShardSpec(**kwargs)
    with pytest.raises(ValueError) as got:
        tucker.ShardSpec(**kwargs)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("kwargs", [dict(pipeline="python"), dict(algorithm="dense"),
                                    dict(precision="bf16_fp32acc")])
def test_tucker_spec_shard_rules_match_the_reference(kwargs):
    from repro import tucker as jtucker
    from repro_torch import tucker

    kw = dict(shape=(8, 8, 8), ranks=(2, 2, 2))
    with pytest.raises(ValueError) as want:
        jtucker.TuckerSpec(shard=jtucker.ShardSpec(1), **kw, **kwargs)
    with pytest.raises(ValueError) as got:
        tucker.TuckerSpec(shard=tucker.ShardSpec(1), **kw, **kwargs)
    # the rule's first clause is the reference's; its reason names torch's path
    assert str(got.value).split(":")[0] == str(want.value).split(":")[0]
    with pytest.raises(TypeError, match="ShardSpec"):
        tucker.TuckerSpec(shard=2, **kw)


def test_tucker_spec_shard_rules_kron_reuse_and_engines():
    from repro_torch import tucker

    kw = dict(shape=(8, 8, 8), ranks=(2, 2, 2), shard=tucker.ShardSpec(1))
    with pytest.raises(ValueError, match="kron_reuse"):
        tucker.TuckerSpec(use_kron_reuse=True, **kw)
    # on purpose unlike the reference (whose Pallas calls cannot run inside
    # shard_map): each rank runs the port's resolved engine on its slice
    for engine in ("auto", "cuda", "torch"):
        assert tucker.TuckerSpec(engine=engine, **kw).shard.num_devices == 1
    assert not tucker.TuckerSpec(**kw).supports_batched_dispatch


@pytest.mark.parametrize("nnz,n", [(0, 1), (0, 4), (1, 4), (397, 1), (397, 2), (397, 4),
                                   (400, 4), (1024, 3)])
def test_shard_pad_nnz_matches_the_reference(nnz, n):
    from repro.sparse.layout import shard_pad_nnz as jpad
    from repro_torch.sparse.layout import shard_pad_nnz

    assert shard_pad_nnz(nnz, n) == jpad(nnz, n)


def test_shard_pad_nnz_rejects_what_the_reference_rejects():
    from repro_torch.sparse.layout import shard_pad_nnz

    with pytest.raises(ValueError, match="n_shards"):
        shard_pad_nnz(4, 0)
    with pytest.raises(ValueError, match="nnz"):
        shard_pad_nnz(-1, 2)


def _cpu_mesh(world, rank, axis="nnz"):
    from repro_torch.core.distributed import ShardMesh

    return ShardMesh(group=None, world_size=world, rank=rank, axis=axis,
                     devices=("cpu",) * world)


@pytest.mark.parametrize("world", (1, 2, 3, 4))
@pytest.mark.parametrize("target", (None, 400, PAD_TARGET))
def test_build_shard_schedule_matches_the_reference(world, target):
    """The ranks' slices, one after the other, are the reference's padded
    stream, and the counters are its counters."""
    import jax.numpy as jnp

    from repro.core.coo import SparseCOO as JCOO
    from repro.sparse.layout import ShardSchedule as JShardSchedule
    from repro.sparse.layout import build_shard_schedule as jbuild
    from repro.sparse.layout import shard_pad_nnz as jpad
    from repro.utils.compat import make_mesh
    from repro_torch.sparse.layout import build_shard_schedule

    idx, vals, _ = problem()
    coo, _ = _torch_problem()
    scheds = [build_shard_schedule(coo, _cpu_mesh(world, r), target_nnz=target)
              for r in range(world)]
    jcoo = JCOO(jnp.asarray(idx), jnp.asarray(vals), SHAPE)
    floor = max(RAGGED_NNZ, target or 0)
    want = jcoo.pad_to(jpad(floor, world))
    np.testing.assert_array_equal(torch.cat([s.indices for s in scheds]).numpy(),
                                  np.asarray(want.indices))
    np.testing.assert_array_equal(torch.cat([s.values for s in scheds]).numpy(),
                                  np.asarray(want.values))
    jsched = JShardSchedule(indices=None, values=None, mesh=None, nnz_axes=("nnz",),
                            n_shards=world, nnz=RAGGED_NNZ, nnz_padded=int(want.nnz))
    for s in scheds:
        assert (s.nnz, s.nnz_padded, s.n_shards) == (RAGGED_NNZ, jsched.nnz_padded, world)
        assert s.shard_counts.tolist() == jsched.shard_counts.tolist()
        assert s.imbalance == jsched.imbalance
        assert s.coo.shape == SHAPE
    if world == 1:  # the reference's own build_shard_schedule on its one device
        ref = jbuild(jcoo, make_mesh((1,), ("nnz",)), ("nnz",), target_nnz=target)
        np.testing.assert_array_equal(scheds[0].indices.numpy(), np.asarray(ref.indices))
        assert scheds[0].imbalance == ref.imbalance


def test_shard_slice_owns_its_storage_and_takes_new_values():
    """A part of the tensor is a copy of its own (never a view that keeps
    the whole alive); a world of one on the tensor's device holds the tensor
    itself, once."""
    from repro_torch.sparse.layout import build_shard_schedule

    coo, _ = _torch_problem()
    for rank in range(2):
        sched = build_shard_schedule(coo, _cpu_mesh(2, rank))
        assert (sched.indices.untyped_storage().data_ptr()
                != coo.indices.untyped_storage().data_ptr())
        again = sched.with_values(coo.values * 2)
        assert again.indices is sched.indices
        torch.testing.assert_close(again.values, sched.values * 2, rtol=0, atol=0)
    whole = build_shard_schedule(coo, _cpu_mesh(1, 0))
    assert whole.indices is coo.indices and whole.values is coo.values
    doubled = coo.values * 2
    assert whole.with_values(doubled).values is doubled


def test_mismatch_names_the_recipe():
    from repro_torch import tucker

    with pytest.raises(ValueError, match=r"torchrun --nproc-per-node=2"):
        tucker.mesh_for_shard(tucker.ShardSpec(num_devices=2), device="cpu")
    with pytest.raises(ValueError, match=r"init_process_group\(\.\.\., world_size=4\)"):
        tucker.plan(_spec("gram", 4), device="cpu")


def test_fingerprints_differ_by_world_size_and_axis():
    from repro_torch import tucker

    one = tucker.mesh_fingerprint(_cpu_mesh(1, 0))
    assert one == tucker.mesh_fingerprint(tucker.mesh_for_shard(tucker.ShardSpec(1),
                                                                device="cpu"))
    assert one != tucker.mesh_fingerprint(_cpu_mesh(1, 0, axis="data"))
    assert one != tucker.mesh_fingerprint(_cpu_mesh(4, 0))
    # every rank of a mesh computes the same fingerprint
    assert len({tucker.mesh_fingerprint(_cpu_mesh(4, r)) for r in range(4)}) == 1


def test_world_of_one_without_a_group_gives_the_unsharded_bits():
    from repro_torch import tucker

    coo, f0 = _torch_problem()
    tucker.clear_plan_cache()
    base = tucker.plan(_spec("householder"), device="cpu")(coo, factors_init=f0)
    res = tucker.plan(_spec("householder", 1), device="cpu")(coo, factors_init=f0)
    assert summary(res)["digest"] == summary(base)["digest"]
    assert res.collective_bytes_per_sweep == psum_bytes(SHAPE, RANKS)
    assert res.shard_imbalance == 0.0 and res.dispatches == 1
    # the caller's tensor, already on the plan's device, is its own slice:
    # held once, not copied
    p = tucker.plan(_spec("householder", 1), device="cpu")
    sched = p.engine.shard_schedule(coo, p.mesh)
    assert sched.indices is coo.indices and sched.values is coo.values


def test_prebuilt_engine_rules_under_shard():
    from repro_torch import tucker
    from repro_torch.core import make_engine

    coo, f0 = _torch_problem()
    spec = _spec("gram", 1)
    with pytest.raises(ValueError, match="fuse_core"):
        tucker.plan(spec, device="cpu", engine=make_engine("torch", "cpu", fuse_core=True))
    got = tucker.plan(spec, device="cpu", engine=make_engine("torch", "cpu"))(
        coo, factors_init=f0)
    want = tucker.plan(_spec("gram"), device="cpu")(coo, factors_init=f0)
    assert summary(got)["digest"] == summary(want)["digest"]
    with pytest.raises(ValueError, match="mesh="):
        tucker.plan(_spec("gram"), device="cpu",
                    mesh=tucker.mesh_for_shard(tucker.ShardSpec(1), device="cpu"))
    with pytest.raises(ValueError, match="on axis 'data'"):
        tucker.plan(spec, device="cpu", mesh=tucker.mesh_for_shard(
            tucker.ShardSpec(1, axis="data"), device="cpu"))
    with pytest.raises(ValueError, match="would drop nonzeros"):
        tucker.plan(spec, device="cpu")(coo, pad_nnz_to=RAGGED_NNZ - 1)


def test_sharded_plan_does_not_autotune(tmp_path, monkeypatch):
    from repro_torch import tucker
    from repro_torch.kernels import autotune as at

    monkeypatch.setenv(at.TABLE_ENV, str(tmp_path / "table.json"))
    at.reset_counters()
    coo, f0 = _torch_problem()
    res = tucker.plan(_spec("gram", 1, autotune=True), device="cpu")(coo, factors_init=f0)
    assert res.tuned_blocks is None and at.COUNTERS["searches"] == 0


def test_distributed_shim_warns_and_delegates():
    from repro_torch.core import hooi_sparse_distributed
    from repro_torch import tucker

    coo, _ = _torch_problem()
    g = torch.Generator().manual_seed(3)
    with pytest.warns(DeprecationWarning, match="hooi_sparse_distributed is deprecated"):
        got = hooi_sparse_distributed(coo, RANKS, n_iter=2, generator=g, device="cpu")
    want = tucker.plan(_spec("gram", 1, n_iter=2), device="cpu")(
        coo, generator=torch.Generator().manual_seed(3))
    assert got.spec.shard == tucker.ShardSpec(1)
    assert summary(got)["digest"] == summary(want)["digest"]


def test_psum_bytes_and_shard_nonzeros_match_the_reference():
    import jax.numpy as jnp

    from repro.core.distributed import psum_bytes_per_sweep as jbytes
    from repro_torch.core.distributed import psum_bytes_per_sweep, shard_nonzeros

    for shape, ranks in ((SHAPE, RANKS), ((12092, 9184, 28818), (16, 16, 16)),
                         ((200, 200, 200, 20), (8, 8, 8, 8))):
        assert psum_bytes_per_sweep(shape, ranks) == jbytes(shape, ranks) == psum_bytes(
            shape, ranks)
        assert psum_bytes_per_sweep(shape, ranks, dtype=torch.float64) == jbytes(
            shape, ranks, dtype=jnp.float64)
    coo, _ = _torch_problem()
    parts = [shard_nonzeros(coo, _cpu_mesh(4, r)) for r in range(4)]
    assert [p.nnz for p in parts] == [100] * 4 and parts[0].shape == SHAPE
    assert importlib.import_module("repro_torch.core.distributed").world_size() == 1


def test_a_lost_rank_fails_the_run(tmp_path):
    """Rank 1 leaves after the plan is built: rank 0's first all-reduce
    raises, and the run never carries on unsharded."""
    out = _finish(start_port("fail", str(tmp_path)), timeout=300)
    assert out["raised"], out
    assert out["result"] is None
