"""repro_torch.checkpoint.manager and repro_torch.runtime.fault_tolerance on
the CPU, against the reference's modules, and the service's retried flush.

The manager's cases are ``tests/test_data_checkpoint.py``'s, each run in
both directions: written by one package and restored by the other (bf16
leaves included), and the port's own round trip. Values are compared
exactly: both sides store the same bits. The fault-tolerance cases are
``tests/test_fault_tolerance.py``'s eight that need no trainer.
"""
import os

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

import repro.obs as jobs
import repro_torch.obs as obs
import repro_torch.runtime.fault_tolerance as ft_mod
from repro import tucker as jtucker
from repro.checkpoint.manager import CheckpointManager as JManager
from repro.serve import ServiceConfig as JServiceConfig
from repro.serve import TuckerService as JTuckerService
from repro.sparse.generators import random_sparse_tensor as jrandom
from repro_torch import tucker
from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.convert import coo_from_numpy
from repro_torch.runtime.fault_tolerance import (
    FailureInjector,
    FtConfig,
    Heartbeater,
    StragglerDetector,
    run_with_retries,
)
from repro_torch.serve import ServiceConfig, TuckerService

# (writer, reader) pairs: the port alone, and across the two packages
DIRECTIONS = ["port->port", "reference->port", "port->reference"]


def _state(pkg):
    """The reference test's tree, as tensors (port) or jax arrays."""
    a = np.arange(6, dtype=np.float32).reshape(2, 3)
    if pkg == "port":
        return {"a": torch.from_numpy(a), "b": {"c": torch.ones(4, dtype=torch.bfloat16)}}
    return {"a": jnp.asarray(a), "b": {"c": jnp.ones((4,), jnp.bfloat16)}}


def _managers(direction, path, **kw):
    writer, reader = direction.split("->")
    make = {"port": CheckpointManager, "reference": JManager}
    return writer, make[writer](str(path), **kw), reader, make[reader](str(path), **kw)


def _np(x):
    """A restored leaf as numpy (bf16 as float32)."""
    if isinstance(x, torch.Tensor):
        return x.to(torch.float32).numpy() if x.dtype == torch.bfloat16 else x.numpy()
    x = np.asarray(x)
    return x.astype(np.float32) if x.dtype == ml_dtypes.bfloat16 else x


@pytest.mark.parametrize("direction", DIRECTIONS)
def test_checkpoint_roundtrip(tmp_path, direction):
    writer, w, reader, r = _managers(direction, tmp_path)
    w.save(7, _state(writer), extra={"note": "x"})
    restored, step, extra = r.restore(_state(reader))
    assert step == 7 and extra["note"] == "x"
    np.testing.assert_array_equal(_np(restored["a"]), np.arange(6, dtype=np.float32)
                                  .reshape(2, 3))
    c = restored["b"]["c"]
    assert (c.dtype == torch.bfloat16) if reader == "port" else (c.dtype == jnp.bfloat16)
    np.testing.assert_array_equal(_np(c), np.ones(4, np.float32))


@pytest.mark.parametrize("direction", DIRECTIONS)
def test_checkpoint_latest_and_gc(tmp_path, direction):
    writer, w, reader, r = _managers(direction, tmp_path, keep=2)
    state = {"w": torch.zeros(2)} if writer == "port" else {"w": jnp.zeros((2,))}
    for s in (1, 2, 3, 4):
        w.save(s, state)
    assert r.latest_step() == 4
    assert r.all_steps() == [3, 4]  # gc keeps 2


@pytest.mark.parametrize("direction", DIRECTIONS)
def test_checkpoint_elastic_restore_dtype(tmp_path, direction):
    """Restore into another dtype (a precision swap): float32 -> bfloat16,
    through float32 as the reference converts."""
    writer, w, reader, r = _managers(direction, tmp_path)
    w1 = np.linspace(-2, 2, 16, dtype=np.float32).reshape(4, 4)
    w.save(1, {"w": torch.from_numpy(w1) if writer == "port" else jnp.asarray(w1)})
    like = ({"w": ((4, 4), torch.bfloat16)} if reader == "port"
            else {"w": jax.ShapeDtypeStruct((4, 4), jnp.bfloat16)})
    restored, _, _ = r.restore(like)
    assert str(restored["w"].dtype).replace("torch.", "") == "bfloat16"
    np.testing.assert_array_equal(_np(restored["w"]),
                                  w1.astype(ml_dtypes.bfloat16).astype(np.float32))


@pytest.mark.parametrize("direction", DIRECTIONS)
def test_checkpoint_missing_leaf_raises(tmp_path, direction):
    writer, w, reader, r = _managers(direction, tmp_path)
    w.save(1, {"w": torch.ones(2)} if writer == "port" else {"w": jnp.ones((2,))})
    like = ({"w": torch.ones(2), "extra": torch.ones(2)} if reader == "port"
            else {"w": jnp.ones((2,)), "extra": jnp.ones((2,))})
    with pytest.raises(KeyError):
        r.restore(like)


def _open_fds_for(path):
    """fds of this process currently open on ``path`` (via /proc)."""
    fd_dir = f"/proc/{os.getpid()}/fd"
    out = set()
    for fd in os.listdir(fd_dir):
        try:
            if os.readlink(f"{fd_dir}/{fd}") == str(path):
                out.add(fd)
        except OSError:
            continue
    return out


@pytest.mark.parametrize("direction", DIRECTIONS)
def test_checkpoint_restore_closes_npz(tmp_path, direction):
    writer, w, reader, r = _managers(direction, tmp_path)
    w.save(1, {"w": torch.ones(2)} if writer == "port" else {"w": jnp.ones((2,))})
    npz = tmp_path / "step_00000001" / "shard_00000.npz"
    before = _open_fds_for(npz)
    r.restore({"w": torch.ones(2)} if reader == "port" else {"w": jnp.ones((2,))})
    assert _open_fds_for(npz) == before  # no handle survives the restore


@pytest.mark.parametrize("direction", DIRECTIONS)
def test_checkpoint_stale_tmp_cleaned_on_init(tmp_path, direction):
    """A crashed save's step_X.tmp is swept by a fresh manager and never
    counts as a step."""
    writer, _, reader, _ = _managers(direction, tmp_path / "unused")
    for who in (writer, reader):
        stale = tmp_path / who / "step_00000009.tmp"
        stale.mkdir(parents=True)
        (stale / "manifest.json").write_text("{}")
        mgr = (CheckpointManager if who == "port" else JManager)(str(tmp_path / who))
        assert not stale.exists()
        assert mgr.all_steps() == []


@pytest.mark.parametrize("direction", DIRECTIONS)
def test_checkpoint_read_manifest(tmp_path, direction):
    writer, w, reader, r = _managers(direction, tmp_path)
    w.save(3, {"w": torch.zeros(2, 5)} if writer == "port" else {"w": jnp.zeros((2, 5))},
           extra={"tag": "t"})
    m = r.read_manifest()
    assert m["step"] == 3 and m["extra"]["tag"] == "t"
    (leaf,) = m["leaves"]
    assert leaf["name"] == "w" and leaf["shape"] == [2, 5] and leaf["dtype"] == "float32"
    with pytest.raises(FileNotFoundError):
        type(r)(str(tmp_path / "empty")).read_manifest()


def test_manifests_of_both_packages_agree(tmp_path):
    """The same tree written by both: the same manifest, leaf for leaf, and
    the same stored arrays, bf16 bits included."""
    tree_port = {"z": [torch.arange(3, dtype=torch.int32), torch.full((2,), 1.5)],
                 "a": {"x": torch.tensor([1.0, -2.0], dtype=torch.bfloat16)}}
    tree_ref = {"z": [jnp.arange(3, dtype=jnp.int32), jnp.full((2,), 1.5)],
                "a": {"x": jnp.asarray([1.0, -2.0], jnp.bfloat16)}}
    CheckpointManager(str(tmp_path / "p")).save(1, tree_port, extra={"k": 1})
    JManager(str(tmp_path / "r")).save(1, tree_ref, extra={"k": 1})
    mp = CheckpointManager(str(tmp_path / "p")).read_manifest()
    mr = JManager(str(tmp_path / "r")).read_manifest()
    assert mp == mr
    with np.load(tmp_path / "p" / "step_00000001" / "shard_00000.npz") as a, \
            np.load(tmp_path / "r" / "step_00000001" / "shard_00000.npz") as b:
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            assert a[k].dtype == b[k].dtype
            np.testing.assert_array_equal(a[k], b[k])


# -- the fault-tolerance runtime --------------------------------------------------


def test_straggler_detector_flags_slow_step():
    det = StragglerDetector(FtConfig(straggler_factor=2.0))
    for s in range(10):
        assert not det.observe(s, 1.0)
    assert det.observe(10, 5.0)
    assert det.flags == [10]


def test_heartbeater_detects_dead_host():
    t = [0.0]
    hb = Heartbeater(FtConfig(heartbeat_timeout_s=10), now=lambda: t[0])
    hb.beat("host0")
    hb.beat("host1")
    t[0] = 5.0
    hb.beat("host0")
    t[0] = 12.0
    assert hb.dead_hosts() == ["host1"]


def test_run_with_retries_recovers():
    inj = FailureInjector(fail_at=[0])
    calls = []

    def fn():
        inj.maybe_fail(0)
        calls.append(1)
        return 42

    assert run_with_retries(fn, FtConfig(retry_backoff_s=0.0)) == 42
    assert calls == [1]


def test_run_with_retries_exhausts():
    def fn():
        raise RuntimeError("persistent")

    with pytest.raises(RuntimeError):
        run_with_retries(fn, FtConfig(max_retries=2, retry_backoff_s=0.0))


def test_run_with_retries_no_backoff_after_terminal_failure(monkeypatch):
    """Sleeps happen between attempts only, never before the terminal
    failure re-raises."""
    sleeps = []
    monkeypatch.setattr(ft_mod.time, "sleep", lambda s: sleeps.append(s))

    def fn():
        raise RuntimeError("persistent")

    with pytest.raises(RuntimeError):
        run_with_retries(fn, FtConfig(max_retries=2, retry_backoff_s=1.0))
    assert sleeps == [1.0, 2.0]  # 3 attempts, 2 backoffs between them
    sleeps.clear()
    with pytest.raises(RuntimeError):
        run_with_retries(fn, FtConfig(max_retries=0, retry_backoff_s=300.0))
    assert sleeps == []


def test_run_with_retries_chains_attempts():
    n = [0]

    def fn():
        n[0] += 1
        raise RuntimeError(f"attempt {n[0]}")

    with pytest.raises(RuntimeError) as ei:
        run_with_retries(fn, FtConfig(max_retries=1, retry_backoff_s=0.0))
    assert str(ei.value) == "attempt 2"
    assert isinstance(ei.value.__context__, RuntimeError)
    assert str(ei.value.__context__) == "attempt 1"


def test_run_with_retries_on_retry_only_before_actual_retry():
    seen = []

    def fn():
        raise RuntimeError("persistent")

    with pytest.raises(RuntimeError):
        run_with_retries(fn, FtConfig(max_retries=2, retry_backoff_s=0.0),
                         on_retry=lambda attempt, exc: seen.append(attempt))
    assert seen == [0, 1]  # 3 attempts, 2 retries, no terminal callback


def test_straggler_median_is_true_median_on_even_window():
    """History [1,1,1,3,3,3] has median 2.0: dt = 5 at factor 2.0 is a
    straggler (the upper middle element, 3.0, would miss it)."""
    det = StragglerDetector(FtConfig(straggler_factor=2.0, straggler_window=20))
    det.history.extend([1.0, 1.0, 1.0, 3.0, 3.0, 3.0])
    assert det.observe(6, 5.0)
    assert det.flags == [6]


def test_retry_counter_bumps_once_per_retried_attempt():
    before = obs.registry.counter("repro_retries_total").value
    with pytest.raises(RuntimeError):
        run_with_retries(lambda: (_ for _ in ()).throw(RuntimeError("x")),
                         FtConfig(max_retries=2, retry_backoff_s=0.0))
    assert obs.registry.counter("repro_retries_total").value == before + 2


# -- the service's retried flush -----------------------------------------------------


def test_service_retry_moves_the_retry_counter_as_the_reference_does(monkeypatch):
    """A service whose first flush raises RuntimeError, with max_retries=1:
    the flush runs again through run_with_retries, so repro_retries_total
    moves by 1 and ServiceMetrics counts one retry, in both packages."""
    shape, ranks = (14, 12, 10), (3, 2, 2)
    jcoos = [jrandom(shape, 0.05, seed=400 + i) for i in range(2)]
    coos = [coo_from_numpy(np.asarray(c.indices), np.asarray(c.values), shape)
            for c in jcoos]

    def flaky(cls):
        real, calls = cls.batch, []

        def batch(self, *a, **kw):
            calls.append(1)
            if len(calls) == 1:
                raise RuntimeError("transient")
            return real(self, *a, **kw)

        monkeypatch.setattr(cls, "batch", batch)
        return calls

    got = {}
    for name, mod, svc_cls, cfg_cls, members, spec, kw in (
            ("port", obs, TuckerService, ServiceConfig, coos,
             tucker.TuckerSpec(shape, ranks, method="gram", n_iter=2), {"device": "cpu"}),
            ("reference", jobs, JTuckerService, JServiceConfig, jcoos,
             jtucker.TuckerSpec(shape=shape, ranks=ranks, method="gram", n_iter=2), {})):
        plan_cls = tucker.TuckerPlan if name == "port" else jtucker.TuckerPlan
        calls = flaky(plan_cls)
        before = mod.registry.counter("repro_retries_total").value
        cfg = cfg_cls(max_batch=2, max_wait_ms=10_000.0, max_retries=1, retry_backoff_ms=1.0,
                      **kw)
        with svc_cls(cfg) as svc:
            tickets = [svc.submit_coo(c, spec) for c in members]
            assert all(t.result(timeout=120) is not None for t in tickets)
        got[name] = (mod.registry.counter("repro_retries_total").value - before,
                     svc.metrics.snapshot()["retries"], len(calls))
    assert got["port"] == got["reference"] == (1, 1, 2)


def _train_state(pkg):
    """(params, OptState) of step 0 of the repro-100m SMOKE model, as the
    port's tensors or the reference's arrays, from the same numpy values."""
    from repro.configs import get_config as jget_config
    from repro.models import model as jmodel
    from repro.optim import adamw as jadamw
    from repro_torch.configs import get_config
    from repro_torch.convert import lm_params_from_numpy
    from repro_torch.optim import adamw

    jparams = jmodel.init_params(jget_config("repro-100m", smoke=True), jax.random.PRNGKey(0))
    if pkg == "reference":
        return jparams, jadamw.init(jparams)
    params = lm_params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams),
                                  get_config("repro-100m", smoke=True))
    return params, adamw.init(params)


@pytest.mark.parametrize("direction", DIRECTIONS)
def test_checkpoint_roundtrips_params_and_opt_state(tmp_path, direction):
    """The trainer's ``(params, OptState)``: the NamedTuple is rebuilt from its
    fields, its leaves named by field as the reference names them."""
    from repro_torch.optim.adamw import OptState

    writer, w, reader, r = _managers(direction, tmp_path)
    w.save(0, _train_state(writer))
    names = [leaf["name"] for leaf in r.read_manifest(0)["leaves"]]
    assert "1/master/embed/table" in names and "1/count" in names and "0/lm_head/w" in names
    like = _train_state(reader)
    (params, opt), step, _ = r.restore(like)
    assert step == 0 and type(opt).__name__ == "OptState"
    if reader == "port":
        assert isinstance(opt, OptState)
    got = jax.tree_util.tree_leaves((params, tuple(opt))) if reader == "reference" else [
        t for t in _flat((params, tuple(opt)))]
    want = jax.tree_util.tree_leaves((like[0], tuple(like[1]))) if reader == "reference" else [
        t for t in _flat((like[0], tuple(like[1])))]
    assert len(got) == len(want)
    for g, wv in zip(got, want):
        assert _np(g).dtype == _np(wv).dtype
        np.testing.assert_array_equal(_np(g), _np(wv))


def _flat(tree):
    if isinstance(tree, dict):
        return [t for k in sorted(tree) for t in _flat(tree[k])]
    if isinstance(tree, tuple):
        return [t for v in tree for t in _flat(v)]
    return [tree]


def test_checkpoint_roundtrips_ssm_state(tmp_path):
    from repro_torch.models.mamba2 import SsmState

    g = torch.Generator().manual_seed(0)
    state = SsmState(*(torch.randn((2, 3, 4), generator=g).to(torch.bfloat16)
                       for _ in range(3)), h=torch.randn((2, 4, 5, 6), generator=g))
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(3, {"ssm": state})
    assert [leaf["name"] for leaf in mgr.read_manifest(3)["leaves"]] == [
        "ssm/conv_x", "ssm/conv_b", "ssm/conv_c", "ssm/h"]
    restored, _, _ = mgr.restore({"ssm": state})
    assert isinstance(restored["ssm"], SsmState)
    for a, b in zip(restored["ssm"], state):
        assert a.dtype == b.dtype and torch.equal(a, b)
    like = {"ssm": SsmState(*(((2, 3, 4), torch.bfloat16),) * 3, h=((2, 4, 5, 6), torch.float32))}
    from_specs, _, _ = mgr.restore(like)
    assert all(torch.equal(a, b) for a, b in zip(from_specs["ssm"], state))
