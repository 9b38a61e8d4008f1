"""repro_torch.obs against repro.obs: the same span and metric operations
give the same summary, Prometheus text, Perfetto event structure and session
dumps; the port's plan emits the reference's lifecycle spans.

Times differ between any two runs, so summaries are compared by span names
and counts, Perfetto events by everything but their timestamps; metric
values are exact. The ``traced`` fixture clears the port's tracer ring
before and after, so spans of earlier tests in the same worker never leak in.
"""
import json

import numpy as np
import pytest

import repro.obs as jobs
import repro_torch.obs as obs
from repro.obs.__main__ import main as jmain
from repro.obs.metrics import MetricsRegistry as JRegistry
from repro.obs.trace import Tracer as JTracer
from repro_torch import tucker
from repro_torch.obs.__main__ import main as tmain
from repro_torch.obs.metrics import MetricsRegistry
from repro_torch.obs.trace import Tracer
from repro_torch.sparse.generators import random_sparse_tensor


@pytest.fixture
def traced():
    obs.tracer.clear()
    obs.configure(enabled=True)
    try:
        yield obs.tracer
    finally:
        obs.configure(enabled=False)
        obs.tracer.clear()


def _drive_spans(tracer):
    """One fixed sequence of spans and events, nested and flat."""
    with tracer.span("plan.call", shape=[4, 4]) as root:
        with tracer.span("plan.assemble", batch=2):
            tracer.event("plan.cache.lookup", hit=True)
        for i in range(3):
            with tracer.span("sweep.dispatch", program="batched", i=i) as sp:
                sp.set_attr("sweeps_run", 5)
    try:
        with tracer.span("serve.flush"):
            raise KeyError("x")
    except KeyError:
        pass
    return root.span_id


def _drive_metrics(reg):
    c = reg.counter("repro_serve_dispatches_total", "dispatches", labels={"service": "a"})
    c.inc(3)
    reg.counter("repro_serve_dispatches_total", labels={"service": "b"}).inc()
    g = reg.gauge("repro_serve_pending", "pending")
    g.set(7)
    g.dec(2)
    h = reg.histogram("repro_serve_total_latency_ms", "latency", buckets=(1.0, 10.0, 100.0))
    for v in (0.5, 5.0, 50.0, 500.0, 5.0):
        h.observe(v)


def test_summary_and_subtree_match_the_reference():
    port, ref = Tracer(enabled=True), JTracer(enabled=True)
    root_p, root_r = _drive_spans(port), _drive_spans(ref)
    sp, sr = port.summary(), ref.summary()
    assert sorted(sp) == sorted(sr)
    assert {k: v["count"] for k, v in sp.items()} == {k: v["count"] for k, v in sr.items()}
    assert sorted(port.subtree_summary(root_p)) == sorted(ref.subtree_summary(root_r))
    # the error attribute, the ids and the parents agree event by event
    for a, b in zip(port.events(), ref.events()):
        assert (a.name, a.span_id, a.parent_id, a.attrs) == (b.name, b.span_id, b.parent_id,
                                                             b.attrs)


def test_prometheus_text_and_snapshot_match_the_reference():
    port, ref = MetricsRegistry(), JRegistry()
    _drive_metrics(port)
    _drive_metrics(ref)
    assert port.render_prometheus() == ref.render_prometheus()
    assert port.snapshot() == ref.snapshot()
    with pytest.raises(ValueError):
        port.counter("repro_serve_pending")  # registered as a gauge
    with pytest.raises(ValueError):
        port.counter("9bad")


def _structure(events):
    return [{k: (sorted(v) if k == "args" else v) for k, v in ev.items()
             if k not in ("ts", "dur", "pid", "tid")} for ev in events]


def test_perfetto_events_match_the_reference(tmp_path):
    port, ref = Tracer(enabled=True), JTracer(enabled=True)
    _drive_spans(port)
    _drive_spans(ref)
    assert _structure(port.perfetto_events()) == _structure(ref.perfetto_events())
    n = port.export_perfetto(str(tmp_path / "p.json"))
    data = json.loads((tmp_path / "p.json").read_text())
    assert n == 7 and data["displayTimeUnit"] == "ms"
    assert [e["ph"] for e in data["traceEvents"]].count("M") == 1


def test_disabled_tracer_is_free_and_ring_is_bounded():
    t = Tracer(enabled=False)
    assert t.span("x") is t.span("y") and t.span("x").span_id == -1
    t.event("x")
    assert len(t) == 0
    t.configure(enabled=True, ring_capacity=2)
    for i in range(5):
        with t.span(f"s{i}"):
            pass
    assert [e.name for e in t.events()] == ["s3", "s4"]
    with pytest.raises(ValueError):
        t.configure(ring_capacity=0)


def test_session_dump_reads_back_in_both_clis(tmp_path, capsys):
    """A session the port dumps is the reference's format: both CLIs print
    the same summary and Prometheus text from it."""
    t, reg = Tracer(enabled=True), MetricsRegistry()
    _drive_spans(t)
    _drive_metrics(reg)
    path = tmp_path / "session.json"
    t.dump(str(path), metrics=reg.snapshot())
    assert obs.load_session(str(path))["metrics"] == reg.snapshot()
    outs = []
    for main in (tmain, jmain):
        assert main([str(path), "--summary", "--prom",
                     "--perfetto", str(tmp_path / "out.json")]) == 0
        outs.append(capsys.readouterr().out)
        assert json.loads((tmp_path / "out.json").read_text())["traceEvents"]
    assert outs[0] == outs[1] and "sweep.dispatch" in outs[0]
    bad = tmp_path / "bad.json"
    bad.write_text(json.dumps({"format": "other"}))
    with pytest.raises(ValueError):
        obs.load_session(str(bad))


@pytest.mark.parametrize("value", [None, "", "0", "off", "false", "no", "1", "on", "true",
                                   "yes", "/tmp/x.json"])
def test_env_switch_parses_as_the_reference(value):
    was_p, was_r = obs.tracer.enabled, jobs.tracer.enabled
    try:
        obs.configure(enabled=False)
        jobs.configure(enabled=False)
        got = (obs._apply_env(value), obs.tracer.enabled)
        want = (jobs._apply_env(value), jobs.tracer.enabled)
        assert got == want
    finally:
        obs.configure(enabled=was_p)
        jobs.configure(enabled=was_r)


def test_trace_summary_none_when_disabled():
    obs.configure(enabled=False)
    coo = random_sparse_tensor((12, 10, 8), 0.1, seed=1)
    res = tucker.decompose(coo, (3, 2, 2), n_iter=2, device="cpu")
    assert res.trace_summary is None


def test_plan_call_and_batch_lifecycle_spans(traced):
    """plan.call > sweep.dispatch for one tensor; plan.batch > plan.assemble
    and one sweep.dispatch (program "batched") for k; each result carries
    its call's per-stage milliseconds."""
    coos = [random_sparse_tensor((12, 10, 8), 0.1, seed=s) for s in (1, 2, 3)]
    p = tucker.plan(tucker.TuckerSpec((12, 10, 8), (3, 2, 2), n_iter=2), device="cpu")
    res = p(coos[0])
    assert set(res.trace_summary) >= {"sweep.dispatch"}
    ev = {e.name: e for e in traced.events()}
    assert ev["sweep.dispatch"].attrs["program"] == "scan"
    assert ev["sweep.dispatch"].parent_id == ev["plan.call"].span_id
    assert ev["sweep.dispatch"].attrs["sweeps_run"] == 2
    traced.clear()
    results = p.batch(coos)
    for r in results:
        assert set(r.trace_summary) >= {"plan.assemble", "sweep.dispatch"}
    names = [e.name for e in traced.events()]
    assert names.count("sweep.dispatch") == 1 and names.count("plan.batch") == 1
    disp = next(e for e in traced.events() if e.name == "sweep.dispatch")
    assert disp.attrs["program"] == "batched" and disp.attrs["batch"] == 3
    assert disp.attrs["nnz"] == sum(c.nnz for c in coos)
    assert disp.attrs["launches"] == {}  # the CPU launches no kernel


def test_live_demo_runs_the_port_on_the_cpu(capsys):
    was = obs.tracer.enabled
    try:
        assert tmain(["--device", "cpu", "--summary", "--prom"]) == 0
    finally:
        obs.configure(enabled=was)
        obs.tracer.clear()
    out = capsys.readouterr()
    assert "plan.call" in out.out and "repro_plan_cache" in out.out
    assert "rel_error" in out.err


def test_registry_counts_exactly_under_threads():
    import threading

    reg = MetricsRegistry()
    c = reg.counter("hits_total")
    h = reg.histogram("lat_ms", buckets=(1.0,))

    def work():
        for _ in range(2000):
            c.inc()
            h.observe(0.5)

    threads = [threading.Thread(target=work) for _ in range(8)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(60)
    assert not any(th.is_alive() for th in threads)
    assert c.value == 16000 and h.count == 16000
    assert np.isclose(h.sum, 8000.0)
