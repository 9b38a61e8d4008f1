"""The port's contract checks (``repro_torch.analysis``) on the CPU: one
seeded violation for each check flagged under its name, clean lints of real
plans, the baseline and ``Finding``, the CLI on one cell, ``analyze``
against a count made by hand, the sharded checks in a 2-rank gloo group,
and retrace-hazard and scatter-race held against the reference's lints on
the same seeded cases."""
from __future__ import annotations

import dataclasses
import datetime
import json
import math
import os
import subprocess
import sys
from pathlib import Path
from typing import List

import numpy as np
import pytest
import torch

from repro.analysis import schedule_lints as jschedule_lints
from repro.analysis import spec_lints as jspec_lints
from repro.core.coo import SparseCOO as JCOO
from repro.sparse import layout as jlayout
from repro_torch import analysis, tucker
from repro_torch.analysis import runner, schedule_lints, spec_lints, sweep_lints
from repro_torch.analysis.__main__ import main as cli_main
from repro_torch.convert import coo_from_numpy
from repro_torch.core.engine import ShardedSweepEngine, SweepEngine, make_engine
from repro_torch.sparse import layout
from repro_torch.sparse.generators import random_sparse_tensor

ROOT = Path(__file__).resolve().parents[1]
SHAPE, RANKS = (12, 10, 8), (3, 3, 2)
GROUP_TIMEOUT_S = 120


def _coo(seed: int = 0, density: float = 0.08):
    return random_sparse_tensor(SHAPE, density, seed=seed)


def _checks(findings) -> List[str]:
    return sorted({f.check for f in findings})


def _plan(engine=None, **kw):
    spec = tucker.TuckerSpec(shape=SHAPE, ranks=RANKS, n_iter=3, **{"method": "gram", **kw})
    return tucker.TuckerPlan(spec, device="cpu", engine=engine)


# -- findings and the baseline ---------------------------------------------------


def test_finding_validates_its_check_and_severity():
    f = analysis.Finding("transfer", "error", "cell@cpu", "a host read")
    assert str(f) == "[error] transfer @ cell@cpu: a host read"
    assert f.to_json() == {"check": "transfer", "severity": "error", "where": "cell@cpu",
                           "message": "a host read"}
    with pytest.raises(ValueError, match="unknown check"):
        analysis.Finding("hlo", "error", "x", "y")
    with pytest.raises(ValueError, match="unknown severity"):
        analysis.Finding("transfer", "fatal", "x", "y")
    assert analysis.CHECKS == ("transfer", "donation", "retrace-hazard", "precision",
                               "collective", "scatter-race")


def test_baseline_round_trip_and_filter(tmp_path):
    sups = [analysis.Suppression("transfer", "*@cpu*", "qrp.py:12", "plain version on the CPU"),
            analysis.Suppression("*", "sharded/*")]
    path = str(tmp_path / "baseline.json")
    analysis.Baseline(sups).save(path)
    assert json.loads(Path(path).read_text())["version"] == 1
    loaded = analysis.Baseline.load(path)
    assert loaded.suppressions == sups
    cpu = analysis.Finding("transfer", "error", "torch/scan/fp32@cpu", "at qrp.py:12 (x)")
    card = analysis.Finding("transfer", "error", "torch/scan/fp32@cuda", "at qrp.py:12 (x)")
    other = analysis.Finding("precision", "error", "torch/scan/fp32@cpu", "bf16")
    sharded = analysis.Finding("collective", "error", "sharded/scan/fp32@cpu", "twice")
    kept, dropped = loaded.filter([cpu, card, other, sharded])
    assert kept == [card, other] and dropped == [cpu, sharded]


def test_the_ports_baseline_is_its_own_and_loads():
    path = analysis.default_baseline_path()
    assert Path(path).parent == ROOT / "src" / "repro_torch" / "analysis"
    raw = json.loads(Path(path).read_text())
    assert raw["version"] == 1
    for s in analysis.Baseline.load(path).suppressions:
        assert s.check in analysis.CHECKS + ("*",) and s.reason


# -- retrace-hazard: seeded violations, held against the reference -------------


@dataclasses.dataclass(frozen=True)
class ListKey:
    shape: tuple
    extra: List[int] = dataclasses.field(default_factory=list)


@dataclasses.dataclass
class MutableKey:
    shape: tuple
    table: dict = dataclasses.field(default_factory=dict)


@dataclasses.dataclass(frozen=True)
class NanKey:
    shape: tuple
    tol: float = 0.0


class PlainKey:
    pass


RETRACE_CASES = {
    "mutable-field": ([ListKey], [ListKey((2, 3), [1])]),
    "not-frozen": ([MutableKey], []),
    "nan-template": ([NanKey], [NanKey((2, 3), float("nan"))]),
    "nan-accepted": ([], [NanKey((2, 3), 0.5)]),
    "not-a-dataclass": ([PlainKey], []),
}


@pytest.mark.parametrize("case", sorted(RETRACE_CASES))
def test_retrace_hazard_flags_the_seeded_key_as_the_reference(case):
    classes, templates = RETRACE_CASES[case]
    got = spec_lints.retrace_hazard_lint(classes, templates)
    want = jspec_lints.retrace_hazard_lint(classes, templates)
    assert got and _checks(got) == ["retrace-hazard"]
    assert [(f.check, f.severity, f.where, f.message) for f in got] == [
        (f.check, f.severity, f.where, f.message) for f in want]


def test_retrace_hazard_passes_the_ports_spec_classes():
    assert spec_lints.retrace_hazard_lint() == []


# -- scatter-race: seeded schedules, held against the reference ----------------


def _numpy_coo(seed: int = 3):
    rng = np.random.default_rng(seed)
    t = random_sparse_tensor(SHAPE, 0.3, seed=seed)
    return t.indices.numpy(), rng.standard_normal(t.nnz).astype(np.float32)


def _corrupt(sched, how: str, lib):
    """The same corruption of a SortedCOO in either package (``lib`` is numpy
    for the reference's arrays, torch for the port's)."""
    order = lib.asarray(sched.order).copy() if lib is np else sched.order.clone()
    rel = lib.asarray(sched.rel_row).copy() if lib is np else sched.rel_row.clone()
    blkmap = lib.asarray(sched.blkmap).copy() if lib is np else sched.blkmap.clone()
    valid = np.asarray(sched.valid) > 0 if lib is np else (sched.valid > 0).numpy()
    real = np.flatnonzero(valid)
    if how == "duplicate-slot":  # a nonzero summed twice, another dropped
        order[int(real[1])] = order[int(real[0])]
        return sched._replace(order=order)
    if how == "wrong-row":  # one nonzero written to a neighbouring row
        t = int(real[0])
        rel[t] = (int(rel[t]) + 1) % int(sched.bi)
        return sched._replace(rel_row=rel)
    if how == "split-row-block":  # a row block's blocks in two disjoint runs
        bm = np.asarray(blkmap)
        i = int(np.flatnonzero(bm[1:] != bm[:-1])[0])  # the last block of a group
        a, b = int(blkmap[i]), int(blkmap[i + 1])
        blkmap[i], blkmap[i + 1] = b, a
        return sched._replace(blkmap=blkmap)
    raise ValueError(how)


@pytest.mark.parametrize("how", ["duplicate-slot", "wrong-row", "split-row-block"])
def test_scatter_race_flags_the_seeded_schedule_as_the_reference(how):
    idx, vals = _numpy_coo()
    jcoo = JCOO.from_parts(idx, vals, SHAPE)
    tcoo = coo_from_numpy(idx, vals, SHAPE)
    for mode in range(3):
        jsched = jlayout.build_mode_layout(jcoo, mode, bn=4, bi=4)
        tsched = layout.build_mode_layout(tcoo, mode, bn=4, bi=4)
        assert jschedule_lints.scatter_race_lint_schedule(jsched, idx[:, mode]) == []
        assert schedule_lints.scatter_race_lint_schedule(tsched, idx[:, mode]) == []
        want = jschedule_lints.scatter_race_lint_schedule(_corrupt(jsched, how, np),
                                                          idx[:, mode])
        got = schedule_lints.scatter_race_lint_schedule(_corrupt(tsched, how, torch),
                                                        tcoo.indices[:, mode])
        assert want, (how, mode)
        assert _checks(got) == _checks(want) == ["scatter-race"]
        assert len(got) == len(want), (how, mode, got, want)


def _device_schedule(bn: int = 4, bi: int = 4, slots_per_part: int = 3):
    idx, vals = _numpy_coo()
    coo = coo_from_numpy(idx, vals, SHAPE)
    lay = layout.build_mode_layout(coo, 0, bn=bn, bi=bi)
    return coo, layout.DeviceSchedule.from_layout(lay, coo, slots_per_part=slots_per_part)


def test_device_schedule_of_a_real_tensor_is_write_disjoint():
    coo, sched = _device_schedule()
    assert sched.parts.numel() > 3  # several ranges, each opening on a row
    assert schedule_lints.scatter_race_lint_device(sched, coo) == []


def test_device_schedule_with_a_split_row_is_flagged():
    """A row-split boundary moved into the middle of a row: two warps would
    each store a partial sum of it."""
    coo, sched = _device_schedule()
    rows = layout.slot_rows(sched)
    real = sched.valid > 0
    inside = [t for t in range(1, rows.numel())
              if real[t] and real[t - 1] and rows[t] == rows[t - 1]]
    assert inside
    parts = torch.unique(torch.cat([sched.parts, torch.tensor([inside[0]])]))
    got = schedule_lints.scatter_race_lint_device(dataclasses.replace(sched, parts=parts), coo)
    assert _checks(got) == ["scatter-race"] and "inside a row" in got[0].message


@pytest.mark.parametrize("how", ["permutation", "padding-value", "idx"])
def test_device_schedule_seeded_faults_are_flagged(how):
    coo, sched = _device_schedule()
    real = torch.nonzero(sched.valid > 0).flatten()
    pad = torch.nonzero(sched.valid == 0).flatten()
    if how == "permutation":
        order = sched.order.clone()
        order[real[1]] = order[real[0]]
        bad = dataclasses.replace(sched, order=order)
    elif how == "padding-value":
        assert pad.numel()
        vals = sched.vals.clone()
        vals[pad[0]] = 1.0
        bad = dataclasses.replace(sched, vals=vals)
    else:
        idx = sched.idx.clone()
        idx[real[0], 0] = (idx[real[0], 0] + 1) % SHAPE[2]
        bad = dataclasses.replace(sched, idx=idx)
    got = schedule_lints.scatter_race_lint_device(bad, coo)
    assert _checks(got) == ["scatter-race"], got


def test_shared_memory_over_the_limit_is_flagged(monkeypatch):
    from repro_torch.kernels import autotune

    monkeypatch.setattr(autotune, "_smem_limit", lambda device: 1024)
    eng = make_engine("torch", "cpu")
    got = schedule_lints.scatter_race_lint(eng, _coo(), ranks=RANKS)
    assert _checks(got) == ["scatter-race"] and got[-1].where.endswith("/smem")


# -- the sweep checks: seeded violations -----------------------------------------


class ItemEngine(SweepEngine):
    """A kernel engine whose unfolding reads one value back to the host."""

    def mode_unfolding(self, coo, factors, mode):
        y = super().mode_unfolding(coo, factors, mode)
        y.abs().max().item()
        return y


class Bf16CoreEngine(SweepEngine):
    """A kernel engine whose core update returns bf16 under fp32."""

    def core_update(self, coo, factors, y_n):
        return super().core_update(coo, factors, y_n).to(torch.bfloat16)


@pytest.mark.parametrize("read", ["item", "bool", "int", "float", "tolist", "cpu", "numpy"])
def test_a_host_read_inside_the_sweep_is_a_transfer_finding(read):
    def reads(t):
        s = t.abs().max()
        {"item": s.item, "bool": lambda: bool(s), "int": lambda: int(s),
         "float": lambda: float(s), "tolist": s.tolist, "cpu": s.cpu,
         "numpy": s.numpy}[read]()

    class Reader(SweepEngine):
        def core_update(self, coo, factors, y_n):
            g = super().core_update(coo, factors, y_n)
            reads(g)
            return g

    got = _plan(engine=Reader(name="torch", device=torch.device("cpu"))).lint(_coo())
    assert _checks(got) == ["transfer"], got
    assert "test_torch_analysis.py" not in got[0].message  # the site is the port's frame
    assert "sweep" in got[0].message


def test_the_injected_item_is_flagged_at_its_site():
    got = _plan(engine=ItemEngine(name="torch", device=torch.device("cpu"))).lint(_coo())
    assert _checks(got) == ["transfer"]
    assert "item()" in got[0].message and "(3 sweep(s))" not in got[0].message
    assert "9 call(s) over 3 sweep(s)" in got[0].message  # one a mode, three modes


def test_a_sweep_on_another_thread_is_not_watched():
    """A sweep with host reads runs on a second thread while the lint's
    watched sweep is in progress (the two meet inside their sweeps): the
    lint records its own sweeps only, and the other sweep runs unhooked."""
    import threading

    in_lint, in_other, read_done = threading.Event(), threading.Event(), threading.Event()

    class Meeting(SweepEngine):
        armed = False

        def core_update(self, coo, factors, y_n):
            if self.armed and not in_lint.is_set():
                in_lint.set()
                assert read_done.wait(30)
            return super().core_update(coo, factors, y_n)

    class OtherItem(ItemEngine):
        def mode_unfolding(self, coo, factors, mode):
            in_other.set()
            assert in_lint.wait(30)
            y = super().mode_unfolding(coo, factors, mode)  # its .item()
            read_done.set()
            return y

    lint_eng = Meeting(name="torch", device=torch.device("cpu"))
    plan, other = _plan(engine=lint_eng), _plan(engine=OtherItem(name="torch",
                                                                device=torch.device("cpu")))
    coo = _coo()
    plan(coo)  # built and warm before the watch
    lint_eng.armed = True
    box = {}

    def run_other():
        try:
            box["result"] = other(_coo(seed=1))
        except BaseException as e:  # noqa: BLE001 - reported below
            box["error"] = e

    t = threading.Thread(target=run_other)
    t.start()
    assert in_other.wait(30)
    records, _ = sweep_lints.watch_sweeps(lambda: plan(coo), "cpu")
    t.join(30)
    assert read_done.is_set() and "error" not in box, box
    assert len(records) == plan.spec.n_iter
    assert all(not r.host_reads and len(r.unfolding_dtypes) == len(SHAPE) for r in records)
    assert box["result"].core.shape == RANKS


def test_watch_sweeps_refuses_a_nested_watch():
    with pytest.raises(RuntimeError, match="already watching"):
        sweep_lints.watch_sweeps(lambda: sweep_lints.watch_sweeps(lambda: None, "cpu"), "cpu")


def test_a_card_lint_refuses_beside_a_live_card_service(monkeypatch):
    """The card's sync debug mode is process-wide: with a service on the
    card live, the lint raises before it sets the mode. A CPU service
    counts as live until it is closed."""
    from repro_torch.serve import tucker_service

    with tucker_service.TuckerService(tucker_service.ServiceConfig(device="cpu")):
        assert tucker_service.live_services() == 1
        assert tucker_service.live_services("cuda") == 0
    assert tucker_service.live_services() == 0
    monkeypatch.setattr(tucker_service, "live_services", lambda device_type=None: 1)
    with pytest.raises(RuntimeError, match="TuckerService"):
        sweep_lints.sweep_lint(lambda: None, device="cuda", precision="fp32",
                               working_dtype=torch.float32, shape=SHAPE, ranks=RANKS,
                               sharded=False)


def test_the_tol_flag_between_sweeps_is_not_a_finding():
    """``run_segment`` reads one flag a sweep when ``tol > 0``, between the
    sweeps: the one read allowed."""
    plan = _plan(tol=1e-3)
    assert plan.spec.tol > 0
    assert plan.lint(_coo()) == []


def test_a_bf16_core_under_fp32_is_a_precision_finding():
    got = _plan(engine=Bf16CoreEngine(name="torch", device=torch.device("cpu"))).lint(_coo())
    assert _checks(got) == ["precision"]
    assert any("G came out as torch.bfloat16" in f.message for f in got)


def test_bf16_outside_the_kernels_under_bf16acc_is_a_precision_finding(monkeypatch):
    """A factor update that rounds Y_(n) to bf16: under bf16_fp32acc bf16 is
    only a kernel operand."""
    from repro_torch.core import hooi

    orig = hooi.factor_update
    monkeypatch.setattr(hooi, "factor_update",
                        lambda y, r, m: orig(y.to(torch.bfloat16).float(), r, m))
    got = _plan(precision="bf16_fp32acc").lint(_coo())
    assert _checks(got) == ["precision"]
    assert all("outside the kernel calls" in f.message for f in got)
    assert "repro_torch" not in got[0].message or "test_torch_analysis" not in got[0].message


def test_a_collective_in_an_unsharded_sweep_is_flagged(monkeypatch):
    import torch.distributed as dist

    calls = []

    class Reducer(SweepEngine):
        def core_update(self, coo, factors, y_n):
            g = super().core_update(coo, factors, y_n)
            dist.all_reduce(g)
            return g

    monkeypatch.setattr(dist, "all_reduce", lambda t, *a, **k: calls.append(t.numel()))
    got = _plan(engine=Reducer(name="torch", device=torch.device("cpu"))).lint(_coo())
    assert len(calls) == 6  # the warm call's three and the watched call's three
    assert _checks(got) == ["collective"] and "unsharded" in got[0].message


def test_a_batched_flush_that_writes_a_member_is_a_donation_finding(monkeypatch):
    from repro_torch.core import hooi

    orig = hooi.run_sweeps_batched
    coos = [_coo(i) for i in range(3)]

    def writes(stacked, *a, **k):
        coos[1].values.mul_(1.0)  # same values, a new version: the buffer was written
        return orig(stacked, *a, **k)

    plan = _plan()
    plan.batch(coos)
    monkeypatch.setattr(hooi, "run_sweeps_batched", writes)
    got = analysis.lint_batch_plan(plan, coos)
    assert _checks(got) == ["donation"] and got[0].where.endswith("/member1")


# -- clean lints of real plans -----------------------------------------------------


@pytest.mark.parametrize("kind", ["fp32", "householder", "bf16acc", "segment", "fused",
                                  "kron-reuse", "python", "float64"])
def test_real_plans_lint_clean(kind, tmp_path):
    kw = {"fp32": {}, "householder": {"method": "householder"},
          "bf16acc": {"precision": "bf16_fp32acc"},
          "segment": {"snapshot": tucker.SnapshotSpec(every_n_sweeps=2,
                                                      directory=str(tmp_path))},
          "fused": {}, "kron-reuse": {"use_kron_reuse": True, "engine": "torch"},
          "python": {"pipeline": "python"}, "float64": {"dtype": "float64"}}[kind]
    spec = tucker.TuckerSpec(shape=SHAPE, ranks=RANKS, n_iter=3,
                             **{"method": "gram", **kw})
    eng = make_engine("torch", "cpu", fuse_core=True) if kind == "fused" else None
    plan = tucker.TuckerPlan(spec, device="cpu", engine=eng)
    records, _ = sweep_lints.watch_sweeps(lambda: plan(_coo()), "cpu")
    assert len(records) == 3  # every sweep was watched
    assert plan.lint(_coo()) == []


def test_the_batched_flush_lints_clean():
    plan = _plan()
    coos = [_coo(i, 0.08 * (1 + 0.25 * i)) for i in range(4)]
    assert plan.lint_batch(coos) == []
    records, _ = sweep_lints.watch_sweeps(lambda: plan.batch(coos), "cpu")
    assert len(records) == 3
    with pytest.raises(ValueError, match="one by one"):
        _plan(pipeline="python").lint_batch(coos)


def test_the_default_matrix_maps_the_references_cells():
    from repro.analysis.runner import default_matrix as jdefault_matrix

    names = [c.name for c in runner.default_matrix()]
    want = [c.name.replace("xla/", "torch/").replace("pallas/", "cuda/")
            for c in jdefault_matrix()]
    assert names == want and len(names) == 11
    cells = {c.name: c for c in runner.default_matrix()}
    assert runner.cell_engine(cells["cuda/scan/fp32"], "cpu") == "torch"
    assert runner.cell_engine(cells["torch/scan/fp32"], "cuda") == "cuda"
    assert runner.cell_engine(cells["torch/scan/kron-reuse"], "cuda") == "torch"


def test_run_matrix_on_the_cpu_is_clean_and_skips_the_sharded_cells():
    report = analysis.run_matrix(device="cpu",
                                 baseline=analysis.Baseline.load(
                                     analysis.default_baseline_path()))
    assert report.ok, [str(f) for f in report.findings]
    by = {c.name: c for c in report.cells}
    assert by["plan-cache"].findings == []
    assert {n for n, c in by.items() if c.skipped} == {"sharded/scan/fp32",
                                                       "sharded/segment/fp32"}
    assert all(c.engine == "torch" for c in report.cells if c.skipped is None
               and c.name != "plan-cache")


def test_run_matrix_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default runs there")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        analysis.run_matrix(runner.default_matrix()[:1])


def test_run_matrix_keeps_the_callers_snapshot_cells_in_its_temporary_dir(tmp_path):
    given = tmp_path / "given"
    cells = [c for c in runner.default_matrix(snapshot_dir=str(given))
             if c.name == "torch/segment/fp32"]
    report = analysis.run_matrix(cells, device="cpu")
    assert report.ok and [c.name for c in report.cells] == ["plan-cache", "torch/segment/fp32"]
    assert not given.exists()


def test_cli_on_one_cell(tmp_path, capsys):
    out = tmp_path / "report.json"
    assert cli_main(["--cell", "cuda/scan/fused", "--device", "cpu", "--json", str(out)]) == 0
    text = capsys.readouterr().out
    assert "ok   cuda/scan/fused [torch]" in text and "all program contracts hold" in text
    report = json.loads(out.read_text())
    assert report["ok"] and [c["name"] for c in report["cells"]] == ["plan-cache",
                                                                     "cuda/scan/fused"]
    assert cli_main(["--list"]) == 0
    assert "sharded/scan/fp32  (needs 2 ranks)" in capsys.readouterr().out
    with pytest.raises(SystemExit):
        cli_main(["--cell", "nope", "--device", "cpu"])


def test_cli_exits_nonzero_on_a_finding(tmp_path, monkeypatch, capsys):
    """A seeded host read in every sweep: the CLI fails, and a baseline entry
    for the site suppresses it."""
    from repro_torch.core.hooi import factor_update as orig

    def reading(y_n, r, method):
        y_n.sum().item()
        return orig(y_n, r, method)

    monkeypatch.setattr("repro_torch.core.hooi.factor_update", reading)
    assert cli_main(["--cell", "torch/scan/fp32", "--device", "cpu"]) == 1
    assert "FAIL torch/scan/fp32" in capsys.readouterr().out
    path = tmp_path / "b.json"
    # the site is the port's innermost frame: the sweep that called the update
    analysis.Baseline([analysis.Suppression("transfer", "*@cpu", "core/hooi.py:",
                                            "the seeded read")]).save(str(path))
    assert cli_main(["--cell", "torch/scan/fp32", "--device", "cpu",
                     "--baseline", str(path)]) == 0
    assert "(1 suppressed)" in capsys.readouterr().out


# -- analyze -------------------------------------------------------------------------


@pytest.mark.parametrize("method", ["gram", "svd"])
def test_analyze_matches_a_count_by_hand(method):
    coo = _coo()
    plan = _plan(method=method)
    got = plan.analyze(coo)
    nnz, (i1, i2, i3), (r1, r2, r3) = coo.nnz, SHAPE, RANKS
    # the Kron chain a mode: nnz x (rows of the second operand built + 2 K)
    kron = nnz * ((r3 * r2) + 2 * r3 * r2) + nnz * ((r3 * r1) + 2 * r3 * r1) \
        + nnz * ((r2 * r1) + 2 * r2 * r1)

    def upd(m, n):
        return 2 * m * n * n + 11 * n ** 3 if method == "svd" else 2 * m * n * n - 2 * n ** 3 // 3

    flops = kron + upd(i1, r2 * r3) + upd(i2, r1 * r3) + upd(i3, r1 * r2) + 2 * r1 * r2 * r3 * i3
    from repro_torch.kernels.autotune import DEFAULT_CONFIG, sweep_bytes

    nbytes = sweep_bytes(DEFAULT_CONFIG, SHAPE, RANKS, nnz)
    assert got["dot_flops_per_sweep"] == flops and got["dot_flops"] == 3 * flops
    assert got["hbm_bytes_per_sweep"] == nbytes and got["hbm_bytes"] == 3 * nbytes
    assert got["arithmetic_intensity"] == pytest.approx(flops / nbytes)
    assert {k: got[k] for k in ("engine", "precision", "fuse_core", "program",
                                "n_sweeps_traced", "tuned_blocks")} == {
        "engine": "torch", "precision": "fp32", "fuse_core": False, "program": "scan",
        "n_sweeps_traced": 3, "tuned_blocks": None}
    assert "collective_bytes" not in got
    fused = tucker.TuckerPlan(plan.spec, device="cpu",
                              engine=make_engine("torch", "cpu", fuse_core=True)).analyze(coo)
    assert fused["fuse_core"] and fused["hbm_bytes_per_sweep"] == sweep_bytes(
        DEFAULT_CONFIG._replace(layout="fused"), SHAPE, RANKS, nnz)


def test_analyze_under_shard_reports_the_collective_bytes():
    from repro_torch.core.distributed import psum_bytes_per_sweep

    spec = tucker.TuckerSpec(shape=SHAPE, ranks=RANKS, n_iter=3,
                             shard=tucker.ShardSpec(num_devices=1))
    got = tucker.TuckerPlan(spec, device="cpu").analyze(_coo())
    assert got["program"] == "sharded" and got["collective_bytes_per_sweep"] == 0
    assert psum_bytes_per_sweep(SHAPE, RANKS) == 4 * (12 * 6 + 10 * 6 + 8 * 9)


# -- the sharded checks, in a 2-rank gloo group -------------------------------------


class TwiceReducing(ShardedSweepEngine):
    """A sharded engine that all-reduces each unfolding twice."""

    def mode_unfolding(self, coo, factors, mode):
        return self.all_reduce(super().mode_unfolding(coo, factors, mode))


def _rank_lint(rank: int, world: int, store: str, tmp: str) -> None:
    import torch.distributed as dist

    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(store, world), rank=rank,
                            world_size=world,
                            timeout=datetime.timedelta(seconds=GROUP_TIMEOUT_S))
    try:
        cells = [c for c in runner.default_matrix(snapshot_dir=os.path.join(tmp, "snap"))
                 if c.min_ranks > 1]
        report = analysis.run_matrix(cells, device="cpu")
        spec = tucker.TuckerSpec(shape=SHAPE, ranks=RANKS, method="gram", n_iter=3,
                                 shard=tucker.ShardSpec(num_devices=world))
        plan = tucker.TuckerPlan(spec, device="cpu")
        plan._sharded = TwiceReducing(plan.engine, plan.mesh)
        seeded = plan.lint(_coo())
        analyzed = plan.analyze(_coo())
        out = {"report": report.to_json(), "seeded": [f.to_json() for f in seeded],
               "analyze": analyzed}
    finally:
        dist.destroy_process_group()
    Path(tmp, f"lint-r{rank}.json").write_text(json.dumps(out))


def gloo_main(tmp: str) -> None:
    """Spawn the 2 ranks (in a subprocess: spawned ranks re-import this
    module) and print their reports as one JSON line."""
    import torch.multiprocessing as mp

    mp.start_processes(_rank_lint, args=(2, os.path.join(tmp, "store"), tmp), nprocs=2,
                       start_method="spawn")
    print(json.dumps([json.loads(Path(tmp, f"lint-r{r}.json").read_text()) for r in range(2)]))


@pytest.fixture(scope="module")
def gloo_reports(tmp_path_factory):
    tmp = str(tmp_path_factory.mktemp("lint-gloo"))
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([str(ROOT / "src"), str(ROOT / "tests")]))
    proc = subprocess.run([sys.executable, "-c",
                           f"import test_torch_analysis as t; t.gloo_main({tmp!r})"],
                          env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-4000:]
    return json.loads(proc.stdout.strip().splitlines()[-1])


def test_sharded_cells_lint_clean_on_two_ranks(gloo_reports):
    for rep in gloo_reports:
        cells = {c["name"]: c for c in rep["report"]["cells"]}
        assert rep["report"]["ok"], rep["report"]
        for name in ("sharded/scan/fp32", "sharded/segment/fp32"):
            assert cells[name]["skipped"] is None and cells[name]["findings"] == []


def test_a_sharded_engine_that_reduces_twice_is_flagged(gloo_reports):
    from repro_torch.core.distributed import psum_bytes_per_sweep

    want = psum_bytes_per_sweep(SHAPE, RANKS)
    for rep in gloo_reports:
        seeded = rep["seeded"]
        assert {f["check"] for f in seeded} == {"collective"}
        assert len(seeded) == 3  # each of the 3 sweeps
        assert f"6 all-reduce(s) of {2 * want} bytes, want 3 of {want}" in seeded[0]["message"]
        assert rep["analyze"]["collective_bytes_per_sweep"] == want
        assert rep["analyze"]["program"] == "sharded"
