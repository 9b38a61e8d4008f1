"""The config-matrix sweep behind ``python -m repro_torch.analysis``.

Port of ``repro.analysis.runner``. One :class:`Cell` is one (engine x
pipeline x shard x snapshot x precision) point: a spec (plus an optional
prebuilt engine) whose plan runs on a small seeded tensor with every
applicable contract check watching (``sweep_lints``: host syncs,
precision, collectives; ``schedule_lints``: the kernels' write
disjointness and shared memory). Unlike the reference, which lowers and
never executes, a cell RUNS its plan: the port has no compiled program to
read, so its contracts are checked on the sweeps themselves (a warm call,
after a first call has built the schedules).

The reference's 11 cells map to the port with ``xla`` as ``torch`` and
``pallas`` as ``cuda``. A cell's engine runs where it can: on the CPU the
kernel path is the ``torch`` engine (the kernels' plain versions on the
same schedules), and on the card every cell but the Kron-reuse one runs
``cuda`` (``torch`` runs on the card only with Kron reuse). The sharded
cells need a ``torch.distributed`` group of at least 2 ranks, on every one
of which ``run_matrix`` is then called; otherwise they are skipped.
"""
from __future__ import annotations

import dataclasses
import os
import shutil
import tempfile
from typing import Any, List, Optional, Sequence

import torch

from repro_torch.analysis.findings import Baseline, Finding
from repro_torch.analysis.schedule_lints import scatter_race_lint
from repro_torch.analysis.spec_lints import retrace_hazard_lint
from repro_torch.analysis.sweep_lints import sweep_lint


@dataclasses.dataclass
class Cell:
    """One point of the lint matrix. ``engine`` is the card's engine name
    (``"cuda"``, or ``"torch"`` with Kron reuse); ``fuse_core`` builds a
    prebuilt engine with the megakernel; ``batch > 0`` lints the batched
    flush (``TuckerPlan.batch`` over that many member tensors) instead of
    the per-tensor call; ``min_ranks`` is the world the cell needs."""

    name: str
    spec: object  # TuckerSpec, its engine resolved per device by cell_spec
    fuse_core: bool = False
    min_ranks: int = 1
    batch: int = 0


@dataclasses.dataclass
class CellReport:
    name: str
    findings: List[Finding]
    suppressed: int = 0
    skipped: Optional[str] = None
    engine: Optional[str] = None  # the engine that ran

    @property
    def ok(self) -> bool:
        return self.skipped is not None or not self.findings

    def to_json(self) -> dict:
        return {
            "name": self.name,
            "findings": [f.to_json() for f in self.findings],
            "suppressed": self.suppressed,
            "skipped": self.skipped,
            "engine": self.engine,
        }


@dataclasses.dataclass
class MatrixReport:
    cells: List[CellReport]

    @property
    def findings(self) -> List[Finding]:
        return [f for c in self.cells for f in c.findings]

    @property
    def ok(self) -> bool:
        return not self.findings

    def to_json(self) -> dict:
        return {
            "ok": self.ok,
            "n_findings": len(self.findings),
            "cells": [c.to_json() for c in self.cells],
        }


def default_matrix(snapshot_dir: Optional[str] = None) -> List[Cell]:
    """The lint matrix: the reference's 11 cells with ``xla`` as ``torch``
    and ``pallas`` as ``cuda`` — both precisions, householder, Kron reuse,
    the fused core update, the snapshot segments, the batched flush, and
    (given >= 2 ranks) the sharded sweeps plain and in segments. Small
    fixed shapes: the contracts are structural, not scale-dependent.
    ``snapshot_dir`` names the segment cells' directory; :func:`run_matrix`
    points each at a temporary one of its own whatever it names."""
    from repro_torch.tucker.spec import ShardSpec, SnapshotSpec, TuckerSpec

    snap_dir = snapshot_dir or os.path.join(tempfile.gettempdir(),
                                            "repro-torch-analysis-snap")
    base = dict(shape=(12, 10, 8), ranks=(3, 3, 2), method="gram", n_iter=3, tol=1e-7)
    snap = SnapshotSpec(every_n_sweeps=2, directory=snap_dir)
    return [
        Cell("torch/scan/fp32", TuckerSpec(engine="torch", **base)),
        Cell("torch/scan/householder",
             TuckerSpec(engine="torch", **{**base, "method": "householder"})),
        Cell("torch/scan/kron-reuse", TuckerSpec(engine="torch", use_kron_reuse=True, **base)),
        Cell("torch/scan/bf16acc", TuckerSpec(engine="torch", precision="bf16_fp32acc", **base)),
        Cell("cuda/scan/fp32", TuckerSpec(engine="cuda", **base)),
        Cell("cuda/scan/bf16acc", TuckerSpec(engine="cuda", precision="bf16_fp32acc", **base)),
        Cell("cuda/scan/fused", TuckerSpec(engine="cuda", **base), fuse_core=True),
        Cell("torch/segment/fp32", TuckerSpec(engine="torch", snapshot=snap, **base)),
        Cell("torch/batched/fp32", TuckerSpec(engine="torch", **base), batch=4),
        Cell("sharded/scan/fp32",
             TuckerSpec(engine="torch", shard=ShardSpec(num_devices=2), **base), min_ranks=2),
        Cell("sharded/segment/fp32",
             TuckerSpec(engine="torch", shard=ShardSpec(num_devices=2), snapshot=snap, **base),
             min_ranks=2),
    ]


def cell_engine(cell: Cell, device) -> str:
    """The engine ``cell`` runs on ``device``: its own where it can run,
    the kernel path's engine of that device otherwise (``torch`` on the
    CPU, ``cuda`` on the card unless the cell reuses Kron rows)."""
    on_card = torch.device(device).type == "cuda"
    if cell.spec.use_kron_reuse:
        return "torch"
    return "cuda" if on_card else "torch"


def cell_spec(cell: Cell, device) -> Any:
    """The cell's spec on ``device``: its engine resolved (:func:`cell_engine`)
    and a sharded cell's ranks set to the group's world."""
    from repro_torch.tucker.spec import ShardSpec

    spec = dataclasses.replace(cell.spec, engine=cell_engine(cell, device))
    if spec.shard is not None:
        spec = dataclasses.replace(spec, shard=ShardSpec(num_devices=_group_size()))
    return spec


def cell_plan(cell: Cell, device) -> Any:
    """The cell's plan on ``device`` (a fresh one, outside the plan cache)."""
    from repro_torch.core.engine import make_engine
    from repro_torch.tucker.planning import TuckerPlan

    spec = cell_spec(cell, device)
    engine = (make_engine(spec.engine, device, precision=spec.precision, fuse_core=True)
              if cell.fuse_core else None)
    return TuckerPlan(spec, device=device, engine=engine)


def _working_dtype(coo: Any) -> torch.dtype:
    return torch.promote_types(coo.values.dtype, torch.float32)


def lint_plan(plan: Any, x: Any, *, baseline: Optional[Baseline] = None,
              where: Optional[str] = None) -> List[Finding]:
    """Every applicable contract check on one plan's sweeps over ``x``:
    transfer, precision and collective while a warm call runs, and
    scatter-race on the kernel engine's schedules. A first, unwatched call
    builds the schedules (set-up, outside the sweep's contract). The engine
    behind ``TuckerPlan.lint``."""
    from repro_torch.tucker.planning import program_kind

    spec, eng = plan.spec, plan.engine
    if spec.algorithm != "sparse" or eng is None:
        raise ValueError("lint() checks the sparse sweeps: the plan has none")
    coo = plan._check_sparse_input(x)
    where = where or f"{eng.name}/{program_kind(spec)}/{eng.precision}@{plan.device.type}"
    plan(coo)
    findings = sweep_lint(lambda: plan(coo), device=plan.device, precision=eng.precision,
                          working_dtype=_working_dtype(coo), shape=spec.shape,
                          ranks=spec.ranks, sharded=plan.mesh is not None
                          and plan.mesh.group is not None, where=where)
    if not eng.reuses_kron:
        local = coo
        if plan.mesh is not None:
            local = eng.shard_schedule(coo, plan.mesh).coo
        findings += scatter_race_lint(eng, local, ranks=spec.ranks, precision=eng.precision,
                                      where=where)
    if baseline is not None:
        findings, _suppressed = baseline.filter(findings)
    return findings


def lint_batch_plan(plan: Any, coos: Sequence[Any], *, baseline: Optional[Baseline] = None,
                    where: Optional[str] = None) -> List[Finding]:
    """The checks on the batched flush ``TuckerPlan.batch(coos)`` runs (one
    batched sweep program for k members), and its inverse donation
    contract: the flush consumes nothing of the caller's — every member's
    ``indices`` and ``values`` keep their version counter and their values.
    Raises for a plan whose batch runs member by member (there is no
    batched sweep to watch: lint the per-tensor call). The engine behind
    ``TuckerPlan.lint_batch``."""
    spec = plan.spec
    coos = [plan._check_sparse_input(c) for c in coos]
    if not coos:
        raise ValueError("lint_batch() needs at least one member tensor")
    if not plan.batch_is_vmappable():
        raise ValueError(
            "this plan's batch() runs its members one by one (pipeline, precision, "
            "fuse_core, Kron reuse or shard): there is no batched sweep program to "
            "check; lint the per-member call with lint() instead")
    where = where or f"{plan.engine.name}/batched/fp32@{plan.device.type}"
    plan.batch(coos)
    before = [(c.indices._version, c.values._version, c.indices.clone(), c.values.clone())
              for c in coos]
    findings = sweep_lint(lambda: plan.batch(coos), device=plan.device, precision="fp32",
                          working_dtype=_working_dtype(coos[0]), shape=spec.shape,
                          ranks=spec.ranks, sharded=False, where=where)
    for i, (c, (vi, vv, idx, val)) in enumerate(zip(coos, before)):
        if (c.indices._version, c.values._version) != (vi, vv) or not (
                torch.equal(c.indices, idx) and torch.equal(c.values, val)):
            findings.append(Finding(
                "donation", "error", f"{where}/member{i}",
                "the batched flush wrote member tensor's indices or values — a flush "
                "donates nothing: the caller keeps its buffers (retries, metrics)"))
    if baseline is not None:
        findings, _suppressed = baseline.filter(findings)
    return findings


def _snapshots_in(cell: Cell, directory: str) -> Cell:
    """``cell`` with its snapshots (if any) written under ``directory``."""
    snap = cell.spec.snapshot
    if snap is None:
        return cell
    path = os.path.join(directory, cell.name.replace("/", "-"))
    return dataclasses.replace(cell, spec=dataclasses.replace(
        cell.spec, snapshot=dataclasses.replace(snap, directory=path)))


def _group_size() -> int:
    import torch.distributed as dist

    return dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1


def run_matrix(
    cells: Optional[Sequence[Cell]] = None,
    *,
    baseline: Optional[Baseline] = None,
    seed: int = 0,
    density: float = 0.08,
    device="cuda",
) -> MatrixReport:
    """Run the lint matrix on ``device`` (the card unless the caller asks
    for the CPU), with one global retrace-hazard audit of the plan-cache key
    classes beside the per-cell checks. Every snapshot cell, the caller's
    too, writes to a temporary directory of its own, removed afterwards."""
    from repro_torch.base import resolve_device
    from repro_torch.sparse.generators import random_sparse_tensor

    dev = resolve_device(device)
    tmp = tempfile.mkdtemp(prefix="repro-torch-analysis-")
    cells = [_snapshots_in(c, tmp) for c in (default_matrix() if cells is None else cells)]
    world = _group_size()
    reports: List[CellReport] = []

    spec_findings = retrace_hazard_lint()
    suppressed = 0
    if baseline is not None:
        spec_findings, dropped = baseline.filter(spec_findings)
        suppressed = len(dropped)
    reports.append(CellReport("plan-cache", spec_findings, suppressed=suppressed))

    try:
        for cell in cells:
            if world < cell.min_ranks:
                reports.append(CellReport(
                    cell.name, [],
                    skipped=(f"needs a torch.distributed group of {cell.min_ranks} ranks, "
                             f"have {world} (run it under torchrun --nproc-per-node="
                             f"{cell.min_ranks}, every rank calling run_matrix)")))
                continue
            plan_obj = cell_plan(cell, dev)
            where = f"{cell.name}@{dev.type}"
            if cell.batch > 0:
                # distinct nnz per member, as a mixed-nnz serving flush
                coos = [random_sparse_tensor(cell.spec.shape, density * (1.0 + 0.25 * i),
                                             seed=seed + i) for i in range(cell.batch)]
                findings = lint_batch_plan(plan_obj, coos, where=where)
            else:
                coo = random_sparse_tensor(cell.spec.shape, density, seed=seed)
                findings = lint_plan(plan_obj, coo, where=where)
            suppressed = 0
            if baseline is not None:
                findings, dropped = baseline.filter(findings)
                suppressed = len(dropped)
            reports.append(CellReport(cell.name, findings, suppressed=suppressed,
                                      engine=plan_obj.engine.name))
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return MatrixReport(reports)


def default_baseline_path() -> str:
    """The port's committed suppression file, beside this module
    (``repro_torch/analysis/baseline.json``). The repository root's
    ``analysis-baseline.json`` is the reference's."""
    return os.path.join(os.path.dirname(os.path.abspath(__file__)), "baseline.json")
