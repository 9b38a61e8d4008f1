"""repro_torch.serve on the CPU: the micro-batcher, the adaptive policy and
the service metrics against the reference's under the same fake clock and
the same inputs, and an end-to-end ``TuckerService(device="cpu")``: results
as the port's sequential ``decompose``, amortization, admission control,
drain on close, plan-cache eviction hooks and exact per-result launches
under concurrent flushes.

Tolerances: a served result against the sequential ``decompose`` from the
same generator, 1e-6 (the same arithmetic; batched matrix products may
block their sums otherwise, ``test_torch_batch.py``); the policy's and the
metrics' numbers are compared exactly (the same float64 arithmetic on the
same samples).
"""
import math
import threading
import time

import numpy as np
import pytest
import torch

from repro import tucker as jtucker
from repro.serve import AdaptiveBatchPolicy as JPolicy
from repro.serve import BatchKey as JBatchKey
from repro.serve import MicroBatcher as JMicroBatcher
from repro.serve import ServiceMetrics as JServiceMetrics
from repro_torch import tucker
from repro_torch.serve import (
    AdaptiveBatchPolicy,
    BatchKey,
    LatencyTracker,
    MicroBatcher,
    ServiceConfig,
    ServiceMetrics,
    ServiceOverloadedError,
    TuckerService,
)
from repro_torch.serve.batching import FLUSH_DRAIN, FLUSH_FULL, FLUSH_TIMEOUT
from repro_torch.sparse.generators import random_sparse_tensor
from test_torch_batch import count_plain_launches

SHAPE = (14, 12, 10)
SPEC = tucker.TuckerSpec(shape=SHAPE, ranks=(3, 2, 2), method="gram", n_iter=2)
CPU = dict(device="cpu")


def _coos(n, seed0=100, density=0.05):
    return [random_sparse_tensor(SHAPE, density + 0.01 * (i % 3), seed=seed0 + i)
            for i in range(n)]


def _gen(seed):
    return torch.Generator().manual_seed(seed)


@pytest.fixture(autouse=True)
def _default_plan_cache():
    """Tests change the process-wide plan cache's capacity; restore it."""
    yield
    tucker.set_plan_cache_capacity(tucker.planning.DEFAULT_PLAN_CACHE_CAPACITY)


# -- the batcher and the policy against the reference's -------------------------


def _keys(n):
    port = [BatchKey(spec=tucker.TuckerSpec(SHAPE, (2 + i, 2, 2))) for i in range(n)]
    ref = [JBatchKey(spec=jtucker.TuckerSpec(shape=SHAPE, ranks=(2 + i, 2, 2)), bucket=512)
           for i in range(n)]
    return port, ref


def _flush(f, keys):
    return None if f is None else (keys.index(f.key), f.items, f.reason)


@pytest.mark.parametrize("seed", range(4))
def test_microbatcher_matches_the_reference_under_a_fake_clock(seed):
    rng = np.random.default_rng(seed)
    pk, rk = _keys(3)
    port, ref = MicroBatcher(max_batch=4, max_wait_s=0.5), JMicroBatcher(max_batch=4,
                                                                         max_wait_s=0.5)
    now, item = 0.0, 0
    for _ in range(300):
        now += float(rng.exponential(0.05))
        op = rng.integers(10)
        if op < 6:
            k = int(rng.integers(3))
            assert port.add(pk[k], item, now) == ref.add(rk[k], item, now)
            item += 1
        elif op < 8:
            assert _flush(port.pop_ready(now), pk) == _flush(ref.pop_ready(now), rk)
        elif op == 8:
            k = int(rng.integers(3))
            limits = (int(rng.integers(1, 6)), float(rng.uniform(0.0, 1.0)))
            port.set_limits(pk[k], *limits)
            ref.set_limits(rk[k], *limits)
        else:
            assert _flush(port.pop_any(), pk) == _flush(ref.pop_any(), rk)
        assert port.next_deadline() == ref.next_deadline()
        assert len(port) == len(ref)
        assert [port.depth(k) for k in pk] == [ref.depth(k) for k in rk]
    while True:
        got, want = _flush(port.pop_any(), pk), _flush(ref.pop_any(), rk)
        assert got == want
        if got is None:
            break


def test_microbatcher_reasons_and_validation():
    b = MicroBatcher(max_batch=2, max_wait_s=1.0)
    cold, hot = _keys(2)[0]
    b.add(cold, "cold", now=0.0)
    b.add(hot, "hot1", now=5.0)
    b.add(hot, "hot2", now=5.0)
    assert b.pop_ready(now=5.0).reason == FLUSH_TIMEOUT  # the expired key first
    assert b.pop_ready(now=5.0).reason == FLUSH_FULL
    b.add(cold, "x", now=6.0)
    assert b.pop_any().reason == FLUSH_DRAIN
    with pytest.raises(ValueError, match="max_batch"):
        MicroBatcher(max_batch=0, max_wait_s=1.0)
    with pytest.raises(ValueError, match="max_wait"):
        MicroBatcher(max_batch=1, max_wait_s=float("nan"))


@pytest.mark.parametrize("target", [5.0, 20.0, 80.0])
def test_adaptive_policy_matches_the_reference(target):
    rng = np.random.default_rng(int(target))
    pk, rk = _keys(2)
    port = AdaptiveBatchPolicy(max_batch=16, max_wait_s=0.005, target_p99_ms=target,
                               window=16, period=2)
    ref = JPolicy(max_batch=16, max_wait_s=0.005, target_p99_ms=target, window=16, period=2)
    updates = 0
    for step in range(200):
        k = int(rng.integers(2))
        scale = 40.0 if (step // 25) % 2 == 0 else 2.0  # pressure, then headroom
        samples = list(rng.exponential(scale, size=int(rng.integers(1, 6))))
        got, want = port.observe(pk[k], samples), ref.observe(rk[k], samples)
        if want is None:
            assert got is None
        else:
            updates += 1
            assert (got.max_batch, got.max_wait_s, got.direction, got.p99_ms) == (
                want.max_batch, want.max_wait_s, want.direction, want.p99_ms)
        assert port.limits(pk[k]) == ref.limits(rk[k])
    assert updates > 0
    with pytest.raises(ValueError, match="target_p99_ms"):
        AdaptiveBatchPolicy(max_batch=8, max_wait_s=0.002, target_p99_ms=0.0)


def _same(a, b):
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_same(a[k], b[k]) for k in a)
    if isinstance(a, float) and math.isnan(a):
        return isinstance(b, float) and math.isnan(b)
    return a == b


def test_service_metrics_match_the_reference():
    rng = np.random.default_rng(7)
    port, ref = ServiceMetrics(latency_window=64), JServiceMetrics(latency_window=64)
    assert _same(port.snapshot(), ref.snapshot())
    for m in (port, ref):
        m.on_submit(40)
    for i in range(12):
        k = int(rng.integers(1, 5))
        q, t = list(rng.uniform(0, 5, k)), list(rng.uniform(5, 50, k))
        kw = dict(reason=("full", "timeout", "drain")[i % 3], batch_size=k, dispatches=1,
                  nnz_real=100 * k, nnz_padded=100 * k, execute_ms=float(rng.uniform(1, 9)),
                  queue_ms=q, total_ms=t)
        for m in (port, ref):
            m.on_flush(**kw)
    for m in (port, ref):
        m.on_failure(2)
        m.on_reject()
        m.on_retry()
        m.on_plan_eviction()
        m.on_adaptation("narrow")
        m.set_queue_depth(3)
        m.set_inflight(1)
    assert _same(port.snapshot(), ref.snapshot())
    assert port.requests_per_dispatch() == ref.requests_per_dispatch()
    assert port.padding_overhead() == 1.0
    tracker = LatencyTracker(maxlen=100)
    for ms in range(1, 101):
        tracker.observe(float(ms))
    assert tracker.percentile(50) == pytest.approx(50.5)
    assert tracker.summary()["p99_ms"] == pytest.approx(99.01)


# -- the service end to end on the CPU ------------------------------------------


def test_service_results_equal_sequential_decompose_and_amortize():
    coos = _coos(10, seed0=200)
    cfg = ServiceConfig(max_batch=4, max_wait_ms=60_000.0, **CPU)
    with TuckerService(cfg) as svc:
        tickets = [svc.submit_coo(c, SPEC, generator=_gen(i)) for i, c in enumerate(coos)]
        svc.flush()  # the remainder of 2, inline
        results = [t.result(timeout=120) for t in tickets]
        snap = svc.metrics.snapshot()
    assert snap["dispatches"] <= math.ceil(len(coos) / 4) == 3
    assert snap["completed"] == 10 and snap["failed"] == 0
    # flush() may drain the second full batch before an executor pops it
    assert sum(snap["flushes"].values()) == 3 and snap["flushes"].get(FLUSH_FULL, 0) >= 1
    assert snap["padding_overhead"] == 1.0
    for i, (c, res) in enumerate(zip(coos, results)):
        one = tucker.decompose(c, SPEC.ranks, method="gram", n_iter=2, generator=_gen(i), **CPU)
        np.testing.assert_allclose(res.fit_history, one.fit_history, rtol=0, atol=1e-6)
        np.testing.assert_allclose(res.core.numpy(), one.core.numpy(), rtol=0, atol=1e-6)
        t = res.timing
        assert t.batch_size in (4, 2) and t.nnz == t.nnz_padded == c.nnz
        assert t.total_ms >= t.queue_ms >= 0 and t.padding_fraction == 0.0


def test_service_over_one_device_plans_sharded():
    """The reference's test_service_over_mesh_plans_sharded at a world of
    one: every spec without its own shard plans with the service's, each
    request is one sharded dispatch, the no-amortization warning stays
    silent (sequential flushes are the sharded design), and each result is
    the same request planned sharded alone, and so unsharded, bit for bit."""
    import warnings

    shard = tucker.ShardSpec(num_devices=1)
    coos = _coos(2, seed0=500)
    cfg = ServiceConfig(max_batch=2, max_wait_ms=10_000.0, shard=shard, **CPU)
    with TuckerService(cfg) as svc:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            tickets = [svc.submit_coo(c, SPEC, generator=_gen(i)) for i, c in enumerate(coos)]
        results = [t.result(timeout=120) for t in tickets]
        snap = svc.metrics.snapshot()
    assert not [w for w in caught if issubclass(w.category, RuntimeWarning)]
    assert snap["dispatches"] == 2 and snap["padding_overhead"] == 1.0
    sharded_spec = tucker.TuckerSpec(shape=SPEC.shape, ranks=SPEC.ranks, method=SPEC.method,
                                     n_iter=SPEC.n_iter, shard=shard)
    for i, (c, r) in enumerate(zip(coos, results)):
        assert r.spec.shard == shard
        assert r.dispatches == 1  # one sharded dispatch per request
        assert r.collective_bytes_per_sweep is not None
        assert r.shard_imbalance == 0.0
        assert r.timing.nnz_padded == c.nnz
        ref = tucker.plan(sharded_spec, **CPU)(c, generator=_gen(i))
        np.testing.assert_array_equal(r.fit_history, ref.fit_history)
        one = tucker.plan(SPEC, **CPU)(c, generator=_gen(i))
        np.testing.assert_array_equal(r.fit_history, one.fit_history)
        assert torch.equal(r.core, one.core)
    # a spec that brings its own shard across ranks is refused at submit
    with TuckerService(ServiceConfig(**CPU)) as svc:
        with pytest.raises(NotImplementedError, match="item 15b"):
            svc.submit_coo(coos[0], tucker.TuckerSpec(SHAPE, (3, 2, 2),
                                                      shard=tucker.ShardSpec(2)))


def test_service_runs_on_the_card_unless_asked():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default does not raise")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TuckerService()
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        ServiceConfig(shard=tucker.ShardSpec(4), **CPU)


def test_service_submit_validation():
    with TuckerService(ServiceConfig(**CPU)) as svc:
        with pytest.raises(ValueError, match="zero stored nonzeros"):
            svc.submit(np.zeros((0, 3), np.int32), np.zeros(0, np.float32), SPEC)
        with pytest.raises(ValueError, match="algorithm='sparse'"):
            svc.submit_coo(_coos(1)[0], tucker.TuckerSpec(SHAPE, (2, 2, 2), algorithm="dense"))
        with pytest.raises(ValueError, match="does not match"):
            svc.submit_coo(random_sparse_tensor((5, 5, 5), 0.2, seed=1), SPEC)
    for bad, match in ((dict(max_inflight_flushes=0), "max_inflight_flushes"),
                       (dict(max_pending=0), "max_pending"),
                       (dict(backpressure="drop"), "backpressure"),
                       (dict(adaptive_target_p99_ms=-1.0), "adaptive_target_p99_ms")):
        with pytest.raises(ValueError, match=match):
            ServiceConfig(**bad, **CPU)


@pytest.mark.parametrize("kwargs", [{"pipeline": "python"}, {"precision": "bf16_fp32acc"}])
def test_fallback_spec_warns_and_serves(kwargs):
    spec = tucker.TuckerSpec(SHAPE, (3, 2, 2), n_iter=2, **kwargs)
    coos = _coos(3, seed0=300)
    with TuckerService(ServiceConfig(max_batch=3, max_wait_ms=60_000.0, **CPU)) as svc:
        with pytest.warns(RuntimeWarning, match="cannot share one batched dispatch"):
            tickets = [svc.submit_coo(c, spec, generator=_gen(i)) for i, c in enumerate(coos)]
        results = [t.result(timeout=120) for t in tickets]
    for i, (c, res) in enumerate(zip(coos, results)):
        one = tucker.plan(spec, **CPU)(c, generator=_gen(i))
        np.testing.assert_array_equal(res.fit_history, one.fit_history)
    assert svc.metrics.snapshot()["dispatches"] == sum(r.dispatches for r in results) > 1


def test_close_drains_pending_and_without_drain_fails_them():
    coos = _coos(3, seed0=380)
    svc = TuckerService(ServiceConfig(max_batch=8, max_wait_ms=10_000.0, **CPU))
    tickets = [svc.submit_coo(c, SPEC) for c in coos[:2]]
    svc.close(drain=True)
    for t in tickets:
        assert t.result(timeout=60).timing.flush_reason == FLUSH_DRAIN
    with pytest.raises(RuntimeError, match="closed"):
        svc.submit_coo(coos[0], SPEC)
    with pytest.raises(RuntimeError, match="TuckerService is closed"):
        svc.flush()
    svc.close()  # idempotent
    svc = TuckerService(ServiceConfig(max_batch=8, max_wait_ms=10_000.0, **CPU))
    t = svc.submit_coo(coos[2], SPEC)
    svc.close(drain=False)
    with pytest.raises(RuntimeError, match="closed before execution"):
        t.result(timeout=60)
    assert svc.metrics.snapshot()["failed"] == 1


def _gate(monkeypatch):
    gate = threading.Event()
    real = tucker.TuckerPlan.batch

    def gated(self, *a, **kw):
        gate.wait(120)
        return real(self, *a, **kw)

    monkeypatch.setattr(tucker.TuckerPlan, "batch", gated)
    return gate


def test_admission_reject(monkeypatch):
    coos = _coos(3, seed0=950)
    gate = _gate(monkeypatch)
    svc = TuckerService(ServiceConfig(max_batch=1, max_wait_ms=60_000.0, max_pending=2,
                                      backpressure="reject", **CPU))
    try:
        t0, t1 = svc.submit_coo(coos[0], SPEC), svc.submit_coo(coos[1], SPEC)
        with pytest.raises(ServiceOverloadedError, match="max_pending=2"):
            svc.submit_coo(coos[2], SPEC)
        assert svc.metrics.rejected == 1 and svc.metrics.submitted == 2
        gate.set()
        assert t0.result(timeout=120) is not None and t1.result(timeout=120) is not None
        assert svc.submit_coo(coos[2], SPEC).result(timeout=120) is not None
    finally:
        gate.set()
        svc.close()


def test_admission_block_waits_for_capacity(monkeypatch):
    coos = _coos(2, seed0=960)
    gate = _gate(monkeypatch)
    svc = TuckerService(ServiceConfig(max_batch=1, max_wait_ms=60_000.0,
                                      max_inflight_flushes=1, max_pending=1,
                                      backpressure="block", **CPU))
    try:
        t0 = svc.submit_coo(coos[0], SPEC)
        got = {}
        th = threading.Thread(target=lambda: got.setdefault("t", svc.submit_coo(coos[1], SPEC)))
        th.start()
        time.sleep(0.3)
        assert th.is_alive() and "t" not in got  # parked by admission control
        gate.set()
        th.join(120)
        assert not th.is_alive()
        assert t0.result(timeout=120) is not None and got["t"].result(timeout=120) is not None
    finally:
        gate.set()
        svc.close()


def test_failed_flush_fails_its_tickets_and_the_service_lives_on(monkeypatch):
    coos = _coos(2, seed0=400)
    boom = RuntimeError("injected kernel failure")
    with TuckerService(ServiceConfig(max_batch=2, max_wait_ms=10_000.0, **CPU)) as svc:
        monkeypatch.setattr(tucker.TuckerPlan, "batch",
                            lambda self, *a, **k: (_ for _ in ()).throw(boom))
        tickets = [svc.submit_coo(c, SPEC) for c in coos]
        for t in tickets:
            assert t.exception(timeout=60) is boom
        monkeypatch.undo()
        ok = svc.submit_coo(coos[0], SPEC)
        svc.flush()
        assert ok.result(timeout=60).timing is not None
    assert svc.metrics.snapshot()["failed"] == 2


def test_retries_rerun_the_same_flush(monkeypatch):
    coos = _coos(2, seed0=410)
    real, calls = tucker.TuckerPlan.batch, []

    def flaky(self, *a, **kw):
        calls.append(1)
        if len(calls) == 1:
            raise RuntimeError("transient")
        return real(self, *a, **kw)

    monkeypatch.setattr(tucker.TuckerPlan, "batch", flaky)
    cfg = ServiceConfig(max_batch=2, max_wait_ms=10_000.0, max_retries=1, retry_backoff_ms=1.0,
                        **CPU)
    with TuckerService(cfg) as svc:
        tickets = [svc.submit_coo(c, SPEC) for c in coos]
        assert all(t.result(timeout=60) is not None for t in tickets)
    assert len(calls) == 2 and svc.metrics.snapshot()["retries"] == 1


def test_plan_cache_capacity_and_eviction_hook():
    tucker.clear_plan_cache()
    coo = _coos(1, seed0=420)[0]
    specs = [tucker.TuckerSpec(SHAPE, (r, 2, 2), method="gram", n_iter=1) for r in (2, 3)]
    seen = []
    remove = tucker.add_plan_eviction_hook(lambda key, plan: seen.append(key))
    try:
        with TuckerService(ServiceConfig(max_batch=1, max_wait_ms=10_000.0,
                                         plan_cache_capacity=1, **CPU)) as svc:
            for s in specs:
                svc.submit_coo(coo, s).result(timeout=60)
            assert tucker.plan_cache_info()["capacity"] == 1
            assert svc.metrics.snapshot()["plan_evictions"] >= 1
    finally:
        remove()
    assert seen and seen[0] == (specs[0], "cpu")
    assert tucker.plan_cache_info()["size"] <= 1
    # the capacity is process-wide: close() restores what it found
    assert tucker.plan_cache_info()["capacity"] == tucker.planning.DEFAULT_PLAN_CACHE_CAPACITY


def test_plan_cache_shares_one_plan_and_counts():
    tucker.clear_plan_cache()
    info0 = tucker.plan_cache_info()
    plans = []
    threads = [threading.Thread(target=lambda: plans.append(tucker.plan(SPEC, **CPU)))
               for _ in range(8)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(60)
    assert len(plans) == 8 and all(p is plans[0] for p in plans)
    info = tucker.plan_cache_info()
    assert info["size"] == 1 and info["misses"] - info0["misses"] == 1
    assert info["hits"] - info0["hits"] == 7
    with pytest.raises(ValueError, match="capacity"):
        tucker.set_plan_cache_capacity(0)


def test_launches_exact_per_result_under_two_concurrent_flushes(monkeypatch):
    """Two flushes of different specs run at the same time on two executors
    (the barrier passes only if both are in flight); each flush's first
    result counts exactly its own program's launches."""
    count_plain_launches(monkeypatch)
    spec4 = tucker.TuckerSpec((9, 8, 7, 6), (2, 2, 2, 2), method="gram", n_iter=3)
    coos3 = _coos(4, seed0=500)
    coos4 = [random_sparse_tensor(spec4.shape, 0.05, seed=600 + i) for i in range(3)]
    barrier = threading.Barrier(2)
    real = tucker.TuckerPlan.batch

    def rendezvous(self, *a, **kw):
        barrier.wait(60)
        return real(self, *a, **kw)

    monkeypatch.setattr(tucker.TuckerPlan, "batch", rendezvous)
    cfg = ServiceConfig(max_batch=4, max_wait_ms=50.0, max_inflight_flushes=2, **CPU)
    with TuckerService(cfg) as svc:
        t3 = [svc.submit_coo(c, SPEC) for c in coos3]
        t4 = [svc.submit_coo(c, spec4) for c in coos4]
        r3 = [t.result(timeout=120) for t in t3]
        r4 = [t.result(timeout=120) for t in t4]
    # 3-way, k 4, 2 sweeps: kernel 1 once per mode and sweep, kernel 2 per member and sweep
    assert [r.launches for r in r3] == [3 * 2 + 4 * 2, 0, 0, 0]
    # 4-way, k 3, 3 sweeps: two kron_contrib and one scatter_rows a mode, kernel 2 per member
    assert [r.launches for r in r4] == [3 * (4 * 3) + 3 * 3, 0, 0]
    assert svc.metrics.snapshot()["dispatches"] == 2


def test_adaptive_policy_narrows_under_an_unattainable_target():
    coos = _coos(8, seed0=970)
    cfg = ServiceConfig(max_batch=4, max_wait_ms=60_000.0, adaptive_target_p99_ms=1e-6, **CPU)
    with TuckerService(cfg) as svc:
        for c in coos:
            t = svc.submit_coo(c, SPEC)
            svc.flush()
            assert t.result(timeout=60) is not None
        assert svc.metrics.adaptations.get("narrow", 0) >= 1


def test_hammer_concurrent_submit_flush_close():
    """Concurrent submitters of two specs, flush() callers racing the
    executors, close(drain=True) mid-burst: every accepted ticket resolves
    and the final snapshot balances."""
    spec_b = tucker.TuckerSpec(SHAPE, (3, 3, 2), method="gram", n_iter=2)
    coos = _coos(4, seed0=990)
    svc = TuckerService(ServiceConfig(max_batch=3, max_wait_ms=0.5, max_inflight_flushes=3,
                                      **CPU))
    tickets, lock, stop = [], threading.Lock(), threading.Event()

    def submitter(tid):
        rng = np.random.default_rng(tid)
        while not stop.is_set():
            try:
                t = svc.submit_coo(coos[int(rng.integers(4))], SPEC if rng.integers(2) else spec_b)
            except RuntimeError:
                return  # closed mid-burst
            with lock:
                tickets.append(t)
            time.sleep(0.002)

    def flusher():
        while not stop.is_set():
            try:
                svc.flush()
            except RuntimeError:
                return
            time.sleep(0.01)

    threads = [threading.Thread(target=submitter, args=(i,)) for i in range(4)]
    threads.append(threading.Thread(target=flusher))
    for th in threads:
        th.start()
    time.sleep(1.0)
    svc.close(drain=True)
    stop.set()
    for th in threads:
        th.join(120)
        assert not th.is_alive()
    assert tickets and all(t.done() and t.result(timeout=1) is not None for t in tickets)
    snap = svc.metrics.snapshot()
    assert snap["completed"] == len(tickets) and snap["failed"] == 0
    assert snap["pending"] == 0 and snap["queue_depth"] == 0 and snap["inflight_flushes"] == 0
