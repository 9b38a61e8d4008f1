"""The plan/execute front-end: ``plan(spec) -> TuckerPlan``.

Port of ``repro.tucker.planning`` for one device: the sparse path (paper
Alg. 2) on the multi-sweep ``scan`` pipeline or the per-sweep ``python``
one, the batched sweeps of ``TuckerPlan.batch`` (k same-shape tensors in
one program), dense HOOI (Alg. 1) and EM completion over it, and the LRU
plan cache. A plan is bound to one device, ``"cuda"`` unless the caller
asks for the CPU; without a CUDA device the default raises instead of
running on the CPU. A sparse plan owns its sweep engine, whose schedules
are built once per tensor: hand the plan a tensor already on its device
(``coo.to(device)``) to reuse them across calls. The dense and completion
paths run torch products (the reference leaves them to XLA): no kernel of
the port's and no schedule.

A spec with ``shard=ShardSpec(num_devices=N)`` runs SPMD over a
``torch.distributed`` group of N ranks (``core.distributed``): every rank
calls ``plan(spec)(coo)`` with the same tensor, keeps its slice of the
nonzeros on its device, and sums each partial unfolding with one
all-reduce (``core.engine.ShardedSweepEngine``); the factor update runs
replicated. The library never starts the group: the caller does (torchrun,
a test), and without one ``num_devices=1`` is a world of one.

A spec with ``snapshot=SnapshotSpec(...)`` runs its sweeps in segments
(``core.hooi.run_segment``) with the carry written to an atomic checkpoint
at the spec's cadence, each segment retried on a transient failure;
:func:`resume` restarts such a job from its latest snapshot. A spec with
``autotune=True`` applies the tuned kernel launch parameters
(``kernels.autotune``) to the plan's engine at its first sparse call.

Every call opens ``repro_torch.obs`` spans (``plan.call``, ``plan.batch``,
``plan.assemble``, ``sweep.dispatch``; ``snapshot.spill`` and
``resume.restore`` on snapshot specs); with tracing on, each result
carries the call's per-stage milliseconds in ``trace_summary``.
"""
from __future__ import annotations

import dataclasses
import threading
import time
import warnings
from collections import OrderedDict
from typing import Any, Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.base import resolve_device, unported
from repro_torch.core import hooi as _hooi
from repro_torch.core.coo import SparseCOO, fold_dense, unfold_dense
from repro_torch.core.distributed import ShardMesh, psum_bytes_per_sweep, world_size
from repro_torch.core.engine import ShardedSweepEngine, SweepEngine, make_engine
from repro_torch.core.qrp import factor_update
from repro_torch.core.reconstruct import compression_ratio, reconstruct_dense
from repro_torch.core.ttm import ttm_chain
from repro_torch.kernels import launch_count
from repro_torch.obs import event as _obs_event
from repro_torch.obs import registry as _obs_registry
from repro_torch.obs import span as _obs_span
from repro_torch.obs import tracer as _obs_tracer
from repro_torch.sparse.layout import stack_coo_batch
from repro_torch.tucker.result import TuckerResult
from repro_torch.tucker.spec import TuckerSpec, spec_for

__all__ = [
    "PlanCache",
    "PlanStats",
    "TuckerPlan",
    "add_plan_eviction_hook",
    "clear_plan_cache",
    "decompose",
    "mesh_fingerprint",
    "mesh_for_shard",
    "plan",
    "plan_cache_info",
    "resume",
    "set_plan_cache_capacity",
]

# plan-cache counters, registered at their source (every PlanCache reports
# into the same family; in practice the process-wide one).
_MX_PLAN_HITS = _obs_registry.counter("repro_plan_cache_hits_total", "plan cache hits")
_MX_PLAN_MISSES = _obs_registry.counter(
    "repro_plan_cache_misses_total", "plan cache misses (plan builds)")
_MX_PLAN_EVICTIONS = _obs_registry.counter(
    "repro_plan_cache_evictions_total", "plan cache LRU evictions")
_MX_SNAPSHOTS = _obs_registry.counter(
    "repro_snapshots_written_total", "sweep-carry snapshots spilled to disk")


def mesh_for_shard(shard: Any, group: Any = None, *, device="cuda") -> ShardMesh:
    """The ranks a :class:`~repro_torch.tucker.spec.ShardSpec` runs on:
    ``group``, else the default group when one is initialised, whose world
    size must be ``shard.num_devices``. With no group, ``num_devices=1`` is
    a world of one, with no collective; any other count raises.

    ``device`` is this rank's device, the plan's (``"cuda"`` is the card the
    caller chose with ``torch.cuda.set_device(LOCAL_RANK)``). Every rank's
    device is gathered once with ``all_gather_object``, so building the
    mesh is a collective: every rank must build the plan, as every rank
    runs the same program (the SPMD contract)."""
    dev = resolve_device(device)
    n = shard.num_devices
    if group is None:
        group = _default_group()
    recipe = (f"start one rank per shard (torchrun --nproc-per-node={n}, or "
              f"torch.distributed.init_process_group(..., world_size={n}) on every rank)")
    if group is None:
        if n != 1:
            raise ValueError(
                f"ShardSpec wants {n} ranks but no process group is initialised: {recipe}")
        return ShardMesh(group=None, world_size=1, rank=0, axis=shard.axis,
                         devices=(str(dev),))
    size = dist.get_world_size(group)
    if size != n:
        raise ValueError(f"ShardSpec wants {n} ranks but the process group has {size}: {recipe}")
    devices: List[Any] = [None] * size
    dist.all_gather_object(devices, str(dev), group=group)
    return ShardMesh(group=group, world_size=size, rank=dist.get_rank(group), axis=shard.axis,
                     devices=tuple(devices))


def _check_mesh(spec: TuckerSpec, mesh: ShardMesh, device: torch.device) -> None:
    """``mesh`` is one that a plan of ``spec`` on ``device`` may run on."""
    if spec.shard is None:
        raise ValueError("mesh= only applies to specs with a ShardSpec")
    if (mesh.world_size, mesh.axis) != (spec.shard.num_devices, spec.shard.axis):
        raise ValueError(f"the plan's mesh has {mesh.world_size} ranks on axis {mesh.axis!r} "
                         f"but the spec wants {spec.shard.num_devices} on "
                         f"{spec.shard.axis!r}")
    if mesh.device != device:
        raise ValueError(f"this rank's mesh device is {mesh.device}, the plan's {device}")


def _default_group() -> Any:
    """The default process group, or None when none is initialised."""
    return dist.group.WORLD if dist.is_available() and dist.is_initialized() else None


def mesh_fingerprint(mesh: ShardMesh) -> str:
    """Stable identity of a mesh for the plan-cache key and the snapshot
    manifest: backend, every rank's device in rank order, the axis and the
    world size. Every rank computes the same string."""
    return f"{mesh.backend}:{','.join(mesh.devices)}/{mesh.axis}={mesh.world_size}"


def _xnorm2(coo: SparseCOO, device: torch.device) -> torch.Tensor:
    """||X||^2 from the whole tensor's values on ``device`` (its indices
    stay where they are; values already there are not copied): the bits of
    the unsharded run, which moves the tensor and then takes the norm, and
    the same bits on every rank."""
    return torch.square(dataclasses.replace(coo, values=coo.values.to(device)).norm())


def _collective_bytes(spec: TuckerSpec, sched: Any) -> int:
    """All-reduce bytes of one sweep of a sharded plan, at the working
    precision of its values."""
    return psum_bytes_per_sweep(spec.shape, spec.ranks, dtype=torch.promote_types(
        sched.values.dtype, torch.float32))


def _attach_trace_summary(results: Any, root_span: Any) -> None:
    """Per-stage milliseconds of everything under this call's root span,
    only when tracing is on (the disabled path must stay free)."""
    if root_span.span_id < 0:  # the shared no-op span: tracing disabled
        return
    summary = _obs_tracer.subtree_summary(root_span.span_id)
    for res in results if isinstance(results, list) else [results]:
        res.trace_summary = dict(summary)


@dataclasses.dataclass
class PlanStats:
    """Cumulative counters over a plan's lifetime (per-call numbers live on
    each :class:`TuckerResult`): calls (a batch of k counts k), top-level
    dispatches, kernel launches and schedule builds."""

    calls: int = 0
    dispatches: int = 0
    launches: int = 0
    schedule_builds: int = 0


class TuckerPlan:
    """A reusable executable for one :class:`TuckerSpec` on one device.

    Call it on one tensor (``plan(coo)``) or on a batch of same-shape
    sparse tensors (``plan.batch(coos)``). A prebuilt ``engine``
    (``make_engine``) replaces the one the spec would build, with its own
    precision and core layout; it must run on the plan's device. Dense and
    completion plans have no engine.

    A sharded spec runs on ``mesh`` (:func:`mesh_for_shard` by default),
    whose world size must be the spec's ``num_devices`` and whose rank's
    device is the plan's. The plan's engine runs on this rank's slice of
    the nonzeros, wrapped in a :class:`ShardedSweepEngine`; a prebuilt one
    must not fuse the core update (each rank holds only a partial Y_(N)).
    Sharded plans do not autotune.

    Thread safety, in two locks (the reference's contract):

    * ``_exec_lock`` serializes per-tensor calls: the engine's schedule
      caches are bound to one tensor at a time.
    * ``_dispatch_lock`` serializes the device half of :meth:`batch`, which
      runs on the plan's second engine (the batch engine), so a flush never
      evicts the per-tensor schedules. The members' stacking and factor
      draws run outside it: one flush assembles while another runs.

    All launches go to the calling thread's current stream, the device's
    default stream unless the caller set another; kernel 2's scratch
    (``ttm_kernel._scratch``) assumes launches on one device are ordered,
    so concurrent callers must keep to one stream.
    """

    def __init__(self, spec: TuckerSpec, device="cuda",
                 engine: Optional[SweepEngine] = None,
                 mesh: Optional[ShardMesh] = None) -> None:
        self.spec = spec
        self.device = resolve_device(device)
        if self.device.type == "cuda" and spec.dtype == "float64":
            raise unported("float64 on the card", "queue 1, item 8: float64 on the card")
        self.mesh: Optional[ShardMesh] = None
        if mesh is not None:
            _check_mesh(spec, mesh, self.device)
        if spec.shard is not None:
            self.mesh = mesh if mesh is not None else mesh_for_shard(spec.shard,
                                                                     device=self.device)
            _check_mesh(spec, self.mesh, self.device)
            if engine is not None and engine.fuse_core:
                raise ValueError(
                    "a sharded plan runs the split core update on the summed Y_(N): the "
                    "prebuilt engine has fuse_core=True, which would contract a rank's "
                    "partial Y_(N)")
        if spec.algorithm != "sparse":
            if engine is not None:
                raise ValueError(
                    f"a SweepEngine only applies to algorithm='sparse' plans, not "
                    f"{spec.algorithm!r} (the dense path runs torch products)"
                )
        elif engine is None:
            engine = make_engine(spec.engine, self.device, precision=spec.precision)
        elif (engine.device.type != self.device.type
              or resolve_device(engine.device) != self.device):
            raise ValueError(
                f"the prebuilt engine runs on {engine.device}, the plan on "
                f"{self.device}: pass device= to match the engine"
            )
        self.engine: Optional[SweepEngine] = engine
        # the batched sweeps' own engine (fp32, as they run only in fp32):
        # their schedules are the stacked tensor's, built once a flush, and
        # must not evict the per-tensor ones. A sharded plan runs its batch
        # member by member and has none.
        self._batch_engine: Optional[SweepEngine] = (
            make_engine(engine.name, self.device)
            if engine is not None and spec.shard is None else None)
        # the engine the sweeps of a sharded plan run on
        self._sharded: Optional[ShardedSweepEngine] = (
            ShardedSweepEngine(engine, self.mesh) if self.mesh is not None else None)
        # the autotuned launch parameters, applied once per plan at its first
        # sparse call (spec.autotune)
        self._tuned_blocks = None
        self.stats = PlanStats()
        self._exec_lock = threading.RLock()
        self._dispatch_lock = threading.Lock()
        # the stats are bumped from concurrent flushes
        self._stats_lock = threading.Lock()

    def __repr__(self) -> str:  # pragma: no cover - cosmetic
        name = self.engine.name if self.engine is not None else "torch"
        return (f"TuckerPlan(shape={self.spec.shape}, ranks={self.spec.ranks}, "
                f"algorithm={self.spec.algorithm}, engine={name}, device={self.device})")

    def __call__(self, x: Any, generator: Optional[torch.Generator] = None,
                 factors_init: Any = None, device=None, resume_from: Any = None,
                 injector: Any = None, pad_nnz_to: Optional[int] = None) -> TuckerResult:
        """Decompose ``x`` (moved to the plan's device if it is elsewhere): a
        ``SparseCOO`` for the sparse and completion algorithms, a dense array
        (numpy or torch) for the dense one.

        ``device`` defaults to the plan's device and must match it.
        ``factors_init`` (arrays, numpy or torch) warm-starts the sweeps (the
        first EM round of a completion); otherwise
        :func:`~repro_torch.core.hooi.init_factors` draws them from
        ``generator`` (a CPU generator seeded with 0 by default).

        ``resume_from`` (snapshot specs only) restarts the job from a
        snapshot: a checkpoint directory, or a loaded
        :class:`~repro_torch.tucker.snapshot.SnapshotState` (as
        :func:`resume` passes); ``generator`` and ``factors_init`` are then
        unused. ``injector`` (tests) is a
        :class:`~repro_torch.runtime.fault_tolerance.FailureInjector`
        consulted at every segment boundary, inside the retried step.

        ``pad_nnz_to`` (sparse algorithm only; below the tensor's nnz
        raises) raises a sharded plan's pad floor, with the imbalance still
        counted on the real nonzeros, as the reference folds it into the
        shard padding. Unsharded plans pad nothing: they have no compiled
        shape to keep stable.

        On a sharded plan, ``x`` stays where the caller keeps it: only this
        rank's slice of the nonzeros goes to the plan's device (and the
        values once, for the norm). Every rank sweeps rank 0's initial
        factors (one broadcast a call), whatever its own ``generator`` or
        ``factors_init``.
        """
        if device is not None and resolve_device(device) != self.device:
            raise ValueError(f"this plan runs on {self.device}, not {device}")
        spec = self.spec
        with self._exec_lock, _obs_span("plan.call", algorithm=spec.algorithm,
                                        shape=list(spec.shape), ranks=list(spec.ranks)) as sp:
            with self._stats_lock:
                self.stats.calls += 1
            if spec.algorithm != "sparse" and (resume_from is not None or injector is not None):
                raise ValueError("resume_from/injector require algorithm='sparse' with "
                                 "snapshot=SnapshotSpec(...)")
            if spec.algorithm != "sparse" and pad_nnz_to is not None:
                raise ValueError("pad_nnz_to requires algorithm='sparse'")
            if spec.algorithm == "dense":
                res = self._run_dense(x, generator, factors_init)
            else:
                coo = self._check_sparse_input(x)
                if spec.algorithm == "complete":
                    res = self._run_complete(coo, generator, factors_init)
                else:
                    res = self._run_sparse(coo, generator, factors_init, resume_from, injector,
                                           pad_nnz_to)
            _attach_trace_summary(res, sp)
            return res

    def _run_sparse(self, coo: SparseCOO, generator, factors_init, resume_from,
                    injector, pad_nnz_to: Optional[int] = None) -> TuckerResult:
        spec = self.spec
        if pad_nnz_to is not None and int(pad_nnz_to) < coo.nnz:
            raise ValueError(
                f"pad_nnz_to={int(pad_nnz_to)} would drop nonzeros: the tensor has {coo.nnz}")
        self._maybe_autotune(coo)
        if spec.snapshot is not None:
            return self._run_sparse_snapshot(coo, generator, factors_init, resume_from,
                                             injector, pad_nnz_to)
        if resume_from is not None or injector is not None:
            raise ValueError("resume_from/injector require a spec with "
                             "snapshot=SnapshotSpec(...)")
        factors = self._init_factors(generator, factors_init)
        xnorm2 = _xnorm2(coo, self.device)
        if spec.shard is not None:
            return self._run_sparse_sharded(coo, self._sharded.replicate(factors), xnorm2,
                                            pad_nnz_to)
        if spec.pipeline == "scan":
            return self._run_sparse_scan(coo, factors, xnorm2)
        return self._run_sparse_python(coo, factors, xnorm2)

    def _maybe_autotune(self, coo: SparseCOO) -> None:
        """Apply the tuned launch parameters once per plan (spec.autotune):
        the tuning table's entry for this problem's fingerprint (a warm
        entry costs no trial), else a search, then the engine rebinds its
        schedule geometry and core layout. On both engines: ``torch`` runs
        the kernels' plain versions on the same schedules. Runs under the
        exec lock (callers hold it)."""
        if (not self.spec.autotune or self.engine is None or self._tuned_blocks is not None
                or self.spec.shard is not None):
            return
        from repro_torch.kernels import autotune as _autotune

        cfg = _autotune.autotune(
            self.spec.shape, self.spec.ranks, coo.nnz,
            dtype=str(coo.values.dtype).replace("torch.", ""),
            precision=self.engine.precision, device=self.device,
        )
        self.engine.apply_blocks(cfg)
        self._tuned_blocks = cfg

    @property
    def supports_batched_dispatch(self) -> bool:
        """Whether :meth:`batch` runs its members as one batched sweep
        program: the spec's property and an engine that can run it (fp32,
        without ``fuse_core``, whose megakernel would sum the core over all
        members). The serving plane reads this."""
        eng = self.engine
        return (self.spec.supports_batched_dispatch and eng is not None
                and eng.precision == "fp32" and not eng.fuse_core)

    def batch_is_vmappable(self, generators: Any = None) -> bool:
        """Whether :meth:`batch` with these generators runs as one batched
        program, under the reference's name. Every ``torch.Generator`` gives
        the per-tensor draw inside the batch (the members' factors are drawn
        one by one), so this is :attr:`supports_batched_dispatch`."""
        return self.supports_batched_dispatch

    def batch(self, coos: Sequence[SparseCOO], generators: Any = None,
              pad_nnz_to: Optional[int] = None,
              factors_init: Any = None) -> List[TuckerResult]:
        """Decompose k same-shape sparse tensors as one batched program.

        The members are stacked block-diagonally into one tensor and swept
        together (``core.hooi.run_sweeps_batched``): one kernel-1 launch (or
        one kernel 3 + 4 chain) per mode per sweep for the whole batch, one
        batched factor update, and the core update once per member. Each
        member's result is its per-tensor run's from the same initial
        factors, to the rounding of other summation orders.

        ``generators`` (one per member, or None) draw each member's initial
        factors as ``__call__`` does (a CPU generator seeded with 0 by
        default); ``factors_init`` (one list of arrays per member, or None)
        warm-starts a member instead. ``pad_nnz_to`` is checked as the
        reference checks it (below the batch max raises: padding never drops
        nonzeros) and otherwise unused by the batched program: the stack has
        no compiled shape to stabilize, so nothing is padded.

        Plans whose batch cannot share one program (``pipeline="python"``,
        ``precision="bf16_fp32acc"``, a prebuilt ``fuse_core`` engine, a
        sharded spec) run the members as k sequential calls: the same
        results, k dispatches; a sharded plan pads each to ``pad_nnz_to``.
        An empty ``coos`` gives ``[]``; a member with no stored nonzeros
        raises (its relative error is 0/0).

        Counters on the results describe the whole batch: the first
        result counts its dispatch, launches and schedule builds, the others
        0.
        """
        if self.spec.algorithm != "sparse":
            raise ValueError(f"batch() requires algorithm='sparse', got {self.spec.algorithm!r}")
        if self.spec.snapshot is not None:
            raise ValueError(
                "batch() does not compose with snapshot=SnapshotSpec(...): the "
                "members would interleave step sequences in one checkpoint "
                "directory; run snapshot jobs as single calls"
            )
        coos = [self._check_sparse_input(c) for c in coos]
        generators = [None] * len(coos) if generators is None else list(generators)
        inits = [None] * len(coos) if factors_init is None else list(factors_init)
        for what, got in (("generators", generators), ("factors_init lists", inits)):
            if len(got) != len(coos):
                raise ValueError(f"got {len(got)} {what} for {len(coos)} tensors")
        if not coos:
            return []
        empty = [i for i, c in enumerate(coos) if c.nnz == 0]
        if empty:
            raise ValueError(
                f"batch() members {empty} have zero stored nonzeros: an all-zero "
                f"tensor has no defined Tucker fit (relative error is 0/0); filter "
                f"empties out before submitting"
            )
        nnz_max = max(c.nnz for c in coos)
        if pad_nnz_to is not None and int(pad_nnz_to) < nnz_max:
            raise ValueError(
                f"target_nnz={int(pad_nnz_to)} would drop nonzeros: batch max nnz is {nnz_max}")
        batched = self.batch_is_vmappable(generators)
        with _obs_span("plan.batch", size=len(coos), vmapped=batched) as sp:
            if not batched:
                # k sequential calls, each serialized on _exec_lock; a
                # sharded plan's members take the pad floor, as the reference's
                pad = pad_nnz_to if self.spec.shard is not None else None
                return [self(c, generator=g, factors_init=f, pad_nnz_to=pad)
                        for c, g, f in zip(coos, generators, inits)]
            with self._stats_lock:
                self.stats.calls += len(coos)  # as the sequential calls count
            results = self._run_sparse_batched(coos, generators, inits)
            _attach_trace_summary(results, sp)
            return results

    def _check_sparse_input(self, coo: Any) -> SparseCOO:
        """``coo`` checked, at the spec's dtype, on the plan's device; a
        sharded plan leaves it where it is (it moves only its slice)."""
        if not isinstance(coo, SparseCOO):
            raise TypeError(f"expected a repro_torch SparseCOO, got {type(coo).__name__}")
        if tuple(coo.shape) != self.spec.shape:
            raise ValueError(
                f"input shape {tuple(coo.shape)} does not match the planned "
                f"spec shape {self.spec.shape}"
            )
        if self.spec.shard is None:
            coo = coo.to(self.device)
        dt = self.spec.resolved_dtype()
        if dt is not None and coo.values.dtype != dt:
            coo = SparseCOO(coo.indices, coo.values.to(dt), coo.shape)
        if self.device.type == "cuda" and coo.values.dtype != torch.float32:
            raise unported(f"{coo.values.dtype} values on the card",
                           "queue 1, item 8: float64 on the card")
        return coo

    def _init_factors(self, generator, factors_init):
        if factors_init is None:
            dt = self.spec.resolved_dtype() or torch.float32
            return _hooi.init_factors(self.spec.shape, self.spec.ranks, generator,
                                      dtype=dt, device=self.device)
        # copies: the sweeps replace factors in a list, and a caller's seed
        # arrays (numpy, possibly read-only) must stay as they were.
        factors = [(f.clone() if isinstance(f, torch.Tensor) else torch.tensor(np.asarray(f)))
                   .to(self.device) for f in factors_init]
        want = [(i, r) for i, r in zip(self.spec.shape, self.spec.ranks)]
        if [tuple(f.shape) for f in factors] != want:
            raise ValueError(
                f"factors_init shapes {[tuple(f.shape) for f in factors]} do not "
                f"match the spec's {want}"
            )
        if self.device.type == "cuda" and any(f.dtype != torch.float32 for f in factors):
            raise unported("non-float32 factors on the card",
                           "queue 1, item 8: float64 on the card")
        return factors

    def _result(self, core, factors, hist, **counts) -> TuckerResult:
        eng = self.engine
        with self._stats_lock:
            for name in ("dispatches", "launches", "schedule_builds"):
                setattr(self.stats, name, getattr(self.stats, name) + counts.get(name, 0))
        return TuckerResult.from_history(
            core, factors, hist, engine=eng.name if eng is not None else "torch",
            spec=self.spec,
            compression_ratio=compression_ratio(self.spec.shape, self.spec.ranks),
            precision=eng.precision if eng is not None else "fp32",
            tuned_blocks=self._tuned_blocks, **counts,
        )

    def _run_sparse_scan(self, coo: SparseCOO, factors, xnorm2) -> TuckerResult:
        spec, eng = self.spec, self.engine
        builds0, launches0 = eng.schedule_builds, launch_count.tally()
        # the span ends after the history's one read, so its duration is
        # the device's work and not only its launches
        with _obs_span("sweep.dispatch", program="scan", engine=eng.name,
                       nnz=coo.nnz) as dsp:
            fs, core, hist = _hooi.run_sweeps(
                coo, factors, xnorm2, spec.tol, eng,
                ranks=spec.ranks, method=spec.method, n_iter=spec.n_iter,
            )
            n_done = int(np.sum(hist != _hooi._SKIPPED))
            launches = launch_count.since(launches0)
            dsp.set_attr("sweeps_run", n_done)
            dsp.set_attr("launches", launches)
        return self._result(core, fs, hist[:n_done], dispatches=1,
                            launches=sum(launches.values()),
                            schedule_builds=eng.schedule_builds - builds0)

    def _run_sparse_sharded(self, coo: SparseCOO, factors, xnorm2,
                            pad_nnz_to: Optional[int] = None) -> TuckerResult:
        """The sweeps of a sharded plan: the multi-sweep loop of
        ``run_sweeps`` on this rank's slice (the engine's cached
        :class:`~repro_torch.sparse.layout.ShardSchedule`) through the
        :class:`ShardedSweepEngine`, one all-reduce per mode per sweep.
        One dispatch, as the reference's one shard_map program."""
        spec, eng = self.spec, self.engine
        builds0, launches0 = eng.schedule_builds, launch_count.tally()
        sched = eng.shard_schedule(coo, self.mesh, pad_nnz_to)
        coll = _collective_bytes(spec, sched)
        with _obs_span("sweep.dispatch", program="sharded", engine=eng.name,
                       nnz=sched.indices.shape[0], collective_bytes_per_sweep=coll) as dsp:
            fs, core, hist = _hooi.run_sweeps(
                sched.coo, factors, xnorm2, spec.tol, self._sharded,
                ranks=spec.ranks, method=spec.method, n_iter=spec.n_iter,
            )
            n_done = int(np.sum(hist != _hooi._SKIPPED))
            launches = launch_count.since(launches0)
            dsp.set_attr("sweeps_run", n_done)
            dsp.set_attr("launches", launches)
        res = self._result(core, fs, hist[:n_done], dispatches=1,
                           launches=sum(launches.values()),
                           schedule_builds=eng.schedule_builds - builds0)
        res.collective_bytes_per_sweep = coll
        res.shard_imbalance = sched.imbalance
        return res

    def _run_sparse_snapshot(self, coo: SparseCOO, generator, factors_init, resume_from,
                             injector, pad_nnz_to: Optional[int] = None) -> TuckerResult:
        """The resumable segment loop: the job's ``n_iter`` sweeps run as
        segments of ``snapshot.segment_len`` sweeps (``core.hooi.run_segment``,
        the unsegmented loop's operations, so the same bits), each under
        ``run_with_retries``, with one host read of the carry per segment. A
        fresh job writes a step-0 snapshot first, so a kill at any later
        boundary finds a resumable job; each boundary then spills its carry
        ("interval", or "wall-clock" once ``every_seconds`` have passed, else
        a ``snapshot.skip`` event), and the last one always does ("final").

        On a sharded plan the segments run on this rank's slice through the
        :class:`ShardedSweepEngine`; rank 0 alone writes each snapshot, with
        the mesh's fingerprint in its manifest, and every rank waits at a
        barrier after the write. The carry is replicated, so rank 0's is
        every rank's."""
        from repro_torch.checkpoint.manager import CheckpointManager
        from repro_torch.runtime.fault_tolerance import FtConfig, run_with_retries
        from repro_torch.tucker import snapshot as _snap

        spec, eng, snap = self.spec, self.engine, self.spec.snapshot
        state = None
        if resume_from is not None:
            if isinstance(resume_from, _snap.SnapshotState):
                state = resume_from
            else:
                with _obs_span("resume.restore", directory=str(resume_from)) as rsp:
                    state = _snap.load_snapshot(str(resume_from))
                    rsp.set_attr("sweeps_done", int(state.sweeps_done))
            _snap.check_compatible(spec, state)
        xnorm2 = _xnorm2(coo, self.device)
        core_dtype = torch.promote_types(coo.values.dtype, torch.float32)
        if state is not None:
            factors = self._init_factors(None, state.factors)
            carry = (torch.as_tensor(state.core, dtype=core_dtype).to(self.device),
                     torch.tensor(state.prev_err, dtype=torch.float32, device=self.device),
                     bool(state.done), int(state.sweeps_done))
            prev_err = float(state.prev_err)  # the host's copy, for the manifest
            hist: List[float] = list(state.fit_history)
            resumed_from: Optional[int] = int(state.sweeps_done)
        else:
            factors = self._init_factors(generator, factors_init)
            if self._sharded is not None:
                factors = self._sharded.replicate(factors)
            carry = _hooi.fresh_carry(spec.ranks, core_dtype, self.device)
            prev_err, hist, resumed_from = float("inf"), [], None

        mesh = self.mesh
        # one writer: rank 0 (another rank's manager would sweep rank 0's
        # half-written step directories)
        writes = mesh is None or mesh.rank == 0
        mgr = CheckpointManager(snap.directory, keep=snap.keep) if writes else None
        ft = FtConfig(max_retries=snap.max_retries, retry_backoff_s=snap.retry_backoff_s)
        retries = dispatches = snapshots_written = 0
        builds0, launches0 = eng.schedule_builds, launch_count.tally()
        sched = None
        run_coo, sweep_eng = coo, eng
        if mesh is not None:
            sched = eng.shard_schedule(coo, mesh, pad_nnz_to)
            run_coo, sweep_eng = sched.coo, self._sharded
        last_spill = time.monotonic()

        def on_retry(attempt: int, exc: BaseException) -> None:
            nonlocal retries
            retries += 1

        def save(step: int, decision: str) -> None:
            # ``decision`` says why this boundary spilled: "initial",
            # "interval", "wall-clock" or "final"
            nonlocal snapshots_written, last_spill
            with _obs_span("snapshot.spill", step=int(step), decision=decision):
                _snap.save_snapshot(mgr, spec, factors=factors, core=carry[0],
                                    prev_err=prev_err, done=carry[2], sweeps_done=step,
                                    fit_history=hist,
                                    mesh_fp=mesh_fingerprint(mesh) if mesh else None,
                                    group=mesh.group if mesh else None)
            if writes:
                _MX_SNAPSHOTS.inc()
            snapshots_written += 1
            last_spill = time.monotonic()

        if state is None:
            save(0, "initial")
        while carry[3] < spec.n_iter and not carry[2]:
            n_done = carry[3]

            def step():
                if injector is not None:
                    # inside the retried step: a one-shot injected failure
                    # retries in place; with max_retries=0 it propagates
                    # after the last snapshot, the kill a resume restarts from
                    injector.maybe_fail(n_done)
                return _hooi.run_segment(run_coo, factors, carry, xnorm2, spec.tol, sweep_eng,
                                         ranks=spec.ranks, method=spec.method,
                                         segment_len=snap.segment_len,
                                         total_sweeps=spec.n_iter)

            with _obs_span("sweep.dispatch", program="segment",
                           engine="sharded" if mesh is not None else eng.name,
                           segment_len=snap.segment_len, sweeps_done=n_done) as dsp:
                seg_launches0, seg_builds0 = launch_count.tally(), eng.schedule_builds
                factors, _, seg_hist, carry = run_with_retries(step, ft, on_retry=on_retry)
                dispatches += 1
                ran = seg_hist[seg_hist != _hooi._SKIPPED]
                hist.extend(float(h) for h in ran)
                if ran.size:  # the carry's prev_err is the last sweep's error
                    prev_err = float(ran[-1])
                dsp.set_attr("sweeps_run", carry[3])
                dsp.set_attr("launches", launch_count.since(seg_launches0))
                dsp.set_attr("schedule_builds", eng.schedule_builds - seg_builds0)
            if carry[2] or carry[3] >= spec.n_iter:
                save(carry[3], "final")
            elif snap.every_seconds is None:
                save(carry[3], "interval")
            elif time.monotonic() - last_spill >= snap.every_seconds:
                save(carry[3], "wall-clock")
            else:  # the interval has not passed: no write at this boundary
                _obs_event("snapshot.skip", step=carry[3], decision="wall-clock",
                           elapsed_s=time.monotonic() - last_spill)

        res = self._result(carry[0], factors, np.asarray(hist, dtype=np.float32),
                           dispatches=dispatches,
                           launches=sum(launch_count.since(launches0).values()),
                           schedule_builds=eng.schedule_builds - builds0)
        res.snapshots_written = snapshots_written
        res.resumed_from_sweep = resumed_from
        res.retries = retries
        if sched is not None:
            res.collective_bytes_per_sweep = _collective_bytes(spec, sched)
            res.shard_imbalance = sched.imbalance
        return res

    def _run_sparse_batched(self, coos: List[SparseCOO], generators,
                            inits) -> List[TuckerResult]:
        spec, eng = self.spec, self._batch_engine
        k = len(coos)
        # host-side assembly, outside the dispatch lock: another flush of
        # this plan may be running its sweeps meanwhile
        with _obs_span("plan.assemble", batch=k):
            factors = [self._init_factors(g, f) for g, f in zip(generators, inits)]
            xnorm2 = torch.stack([torch.square(c.norm()) for c in coos])
            stacked, _ = stack_coo_batch(coos)
        with self._dispatch_lock, _obs_span("sweep.dispatch", program="batched",
                                            engine=eng.name, batch=k, nnz=stacked.nnz,
                                            shape=list(spec.shape)) as dsp:
            builds0, launches0 = eng.schedule_builds, launch_count.tally()
            fs, cores, hists = _hooi.run_sweeps_batched(
                stacked, factors, xnorm2, spec.tol, eng,
                ranks=spec.ranks, method=spec.method, n_iter=spec.n_iter,
            )  # ends in the history's one read
            n_done = np.sum(hists != _hooi._SKIPPED, axis=1)
            launches = launch_count.since(launches0)
            builds = eng.schedule_builds - builds0
            dsp.set_attr("sweeps_run", int(n_done.max()))
            dsp.set_attr("launches", launches)
        return [self._result(cores[i], fs[i], hists[i, :n_done[i]],
                             dispatches=int(i == 0),
                             launches=sum(launches.values()) if i == 0 else 0,
                             schedule_builds=builds if i == 0 else 0)
                for i in range(k)]

    def _run_sparse_python(self, coo: SparseCOO, factors, xnorm2) -> TuckerResult:
        """The per-sweep loop (the reference's benchmark baseline): the
        sweeps of the scan pipeline, with the fit read back after each one
        and the ``tol`` rule decided on the host."""
        spec, eng = self.spec, self.engine
        builds0, launches0 = eng.schedule_builds, launch_count.tally()
        core_dtype = torch.promote_types(coo.values.dtype, torch.float32)
        hist: List[float] = []
        core = None
        for _ in range(spec.n_iter):
            with _obs_span("sweep.dispatch", program="python", engine=eng.name):
                factors, g = _hooi.sparse_sweep(coo, factors, spec.ranks, spec.method, eng)
                core = g.to(core_dtype)
                err = _hooi.projection_error(xnorm2, core).to(torch.float32)
                hist.append(float(err))  # the host read, one a sweep
            if spec.tol and len(hist) > 1 and abs(hist[-2] - hist[-1]) < spec.tol:
                break
        return self._result(core, factors, np.asarray(hist), dispatches=len(hist),
                            launches=sum(launch_count.since(launches0).values()),
                            schedule_builds=eng.schedule_builds - builds0)

    # -- dense (paper Alg. 1) and completion ------------------------------------

    def _run_dense(self, x: Any, generator, factors_init) -> TuckerResult:
        spec = self.spec
        x = x if isinstance(x, torch.Tensor) else torch.tensor(np.asarray(x))
        if tuple(x.shape) != spec.shape:
            raise ValueError(
                f"input shape {tuple(x.shape)} does not match the planned "
                f"spec shape {spec.shape}"
            )
        x = x.to(self.device)
        x = x.to(spec.resolved_dtype() or torch.promote_types(x.dtype, torch.float32))
        if self.device.type == "cuda" and x.dtype != torch.float32:
            raise unported(f"{x.dtype} input on the card", "queue 1, item 8: float64 on the card")
        n, ranks = x.dim(), spec.ranks
        factors = [f.to(x.dtype) for f in self._init_factors(generator, factors_init)]
        # the norm's reduction squares in registers: no temporary of X's size
        xnorm2 = torch.square(torch.linalg.vector_norm(x))
        hist: List[float] = []
        core = None
        for _ in range(spec.n_iter):
            for mode in range(n):
                y = ttm_chain(x, factors, skip=mode, transpose=True)
                factors[mode] = factor_update(unfold_dense(y, mode), ranks[mode], spec.method)
            # the core from the last power iterate: G = Y x_N U_N^T (Eq. 10)
            core = fold_dense(factors[n - 1].T @ unfold_dense(y, n - 1), n - 1, list(ranks))
            hist.append(float(_hooi.projection_error(xnorm2, core)))
            if spec.tol and len(hist) > 1 and abs(hist[-2] - hist[-1]) < spec.tol:
                break
        return self._result(core, factors, np.asarray(hist))

    def _run_complete(self, coo: SparseCOO, generator, factors_init) -> TuckerResult:
        """EM Tucker completion (the paper's MRI [27] and process-variation
        [15] use cases): dense HOOI rounds, each warm-started from the last
        round's factors, on the observed entries with the others imputed
        from the last reconstruction. ``factors_init`` seeds the first
        round."""
        x_obs = coo.to_dense()
        mask = SparseCOO(coo.indices, torch.ones_like(coo.values), coo.shape).to_dense() > 0
        x, res, factors = x_obs, None, factors_init
        for _ in range(self.spec.n_rounds):
            res = self._run_dense(x, generator, factors)
            factors = res.factors
            x = torch.where(mask, x_obs, reconstruct_dense(res.core, res.factors))
        return res


# ---------------------------------------------------------------------------
# The plan cache: one TuckerPlan (one engine and its schedules) per (spec,
# device). LRU and thread-safe: concurrent ``submit`` callers of
# ``repro_torch.serve.TuckerService`` share one plan instead of racing two
# builds of the same spec.
# ---------------------------------------------------------------------------

PlanCacheKey = Tuple
EvictionHook = Callable[[PlanCacheKey, TuckerPlan], None]

# each cached sparse plan keeps its last tensor's schedules on the device
# (~0.9 GB a mode at NELL-2 size), so the process-wide cache is bounded
DEFAULT_PLAN_CACHE_CAPACITY = 8


class PlanCache:
    """Thread-safe LRU cache of :class:`TuckerPlan` keyed by (spec, device).

    ``capacity=None`` means unbounded. Eviction hooks (``hook(key, plan)``)
    observe every plan dropped by the capacity or by :meth:`clear`; they
    run outside the lock, so a hook may re-enter the cache.
    """

    def __init__(self, capacity: Optional[int] = None) -> None:
        self._lock = threading.RLock()
        self._entries: "OrderedDict[PlanCacheKey, TuckerPlan]" = OrderedDict()
        self._capacity = capacity
        self._hooks: List[EvictionHook] = []
        self.hits = 0
        self.misses = 0
        self.evictions = 0
        # bumps on every set_capacity call: lets a scoped capacity holder
        # (repro_torch.serve) detect a manual override even to the same value
        self.capacity_version = 0

    def __len__(self) -> int:
        with self._lock:
            return len(self._entries)

    @property
    def capacity(self) -> Optional[int]:
        return self._capacity

    def get_or_create(self, key: PlanCacheKey,
                      factory: Callable[[], TuckerPlan]) -> TuckerPlan:
        """The cached plan for ``key``. Concurrent callers always share ONE
        plan: the build runs outside the lock (a cold spec must not stall
        hits on hot ones), and a racing builder drops its plan for the one
        inserted first."""
        with self._lock:
            cached = self._entries.get(key)
            if cached is not None:
                self._entries.move_to_end(key)
                self.hits += 1
                _MX_PLAN_HITS.inc()
                _obs_event("plan.cache.lookup", hit=True)
                return cached
        with _obs_span("plan.cache.build"):
            built = factory()
        evicted = []
        with self._lock:
            cached = self._entries.get(key)
            if cached is not None:  # lost the build race: share the winner
                self._entries.move_to_end(key)
                self.hits += 1
                _MX_PLAN_HITS.inc()
                _obs_event("plan.cache.lookup", hit=True, lost_race=True)
                return cached
            self.misses += 1
            _MX_PLAN_MISSES.inc()
            _obs_event("plan.cache.lookup", hit=False)
            self._entries[key] = built
            while self._capacity is not None and len(self._entries) > self._capacity:
                evicted.append(self._entries.popitem(last=False))
                self.evictions += 1
                _MX_PLAN_EVICTIONS.inc()
        for k, p in evicted:
            _obs_event("plan.cache.evict")
            self._fire_hooks(k, p)
        return built

    def set_capacity(self, capacity: Optional[int]) -> None:
        """Set (or lift, with ``None``) the LRU capacity, evicting the least
        recently used plans at once if over the new bound."""
        if capacity is not None and int(capacity) < 1:
            raise ValueError(f"plan cache capacity must be >= 1, got {capacity}")
        evicted = []
        with self._lock:
            self._capacity = None if capacity is None else int(capacity)
            self.capacity_version += 1
            while self._capacity is not None and len(self._entries) > self._capacity:
                evicted.append(self._entries.popitem(last=False))
                self.evictions += 1
                _MX_PLAN_EVICTIONS.inc()
        for k, p in evicted:
            self._fire_hooks(k, p)

    def add_eviction_hook(self, hook: EvictionHook) -> Callable[[], None]:
        """Register ``hook(key, plan)`` for every eviction (capacity or
        ``clear``). Returns a zero-argument deregistration callable."""
        with self._lock:
            self._hooks.append(hook)

        def remove() -> None:
            with self._lock:
                if hook in self._hooks:
                    self._hooks.remove(hook)

        return remove

    def clear(self) -> None:
        """Drop all cached plans (and with them their schedules); eviction
        hooks observe every dropped plan."""
        with self._lock:
            dropped = list(self._entries.items())
            self._entries.clear()
        for k, p in dropped:
            self._fire_hooks(k, p)

    def info(self) -> dict:
        """Counters: size, capacity, capacity_version, hits, misses,
        evictions."""
        with self._lock:
            return {"size": len(self._entries), "capacity": self._capacity,
                    "capacity_version": self.capacity_version, "hits": self.hits,
                    "misses": self.misses, "evictions": self.evictions}

    def _fire_hooks(self, key: PlanCacheKey, plan: TuckerPlan) -> None:
        with self._lock:
            hooks = list(self._hooks)
        for hook in hooks:
            hook(key, plan)


_PLAN_CACHE = PlanCache(DEFAULT_PLAN_CACHE_CAPACITY)


def plan(spec: TuckerSpec, *, device="cuda", engine: Optional[SweepEngine] = None,
         mesh: Optional[ShardMesh] = None) -> TuckerPlan:
    """The :class:`TuckerPlan` for ``spec`` on ``device`` (``"cuda"`` by
    default), from the process-wide LRU cache keyed by (spec, device), so
    every caller asking for the same problem shares one engine and its
    schedules (:func:`set_plan_cache_capacity` bounds it; 8 plans by
    default).

    Passing a prebuilt ``engine`` (``make_engine(..., fuse_core=True)``, say)
    bypasses the cache and wraps that engine directly; its device must be
    ``device``.

    ``mesh`` (sharded specs only) pins the plan to a
    :func:`mesh_for_shard` mesh; by default it is built over the default
    group. The cache key then carries the group, so a re-plan over the
    same group is a hit and another group never reuses this one's plan.
    Only a miss builds the mesh, a collective (every rank plans, in the
    same order); a hit runs none.
    """
    dev = resolve_device(device)
    if mesh is not None:  # before the cache: a hit must not take a mesh the spec refuses
        _check_mesh(spec, mesh, dev)
    if engine is not None:
        return TuckerPlan(spec, device=dev, engine=engine, mesh=mesh)
    key: PlanCacheKey = (spec, str(dev))
    if spec.shard is not None:
        key += (mesh.group if mesh is not None else _default_group(),)
    return _PLAN_CACHE.get_or_create(key, lambda: TuckerPlan(spec, device=dev, mesh=mesh))


def clear_plan_cache() -> None:
    """Drop every cached plan (and with them their schedules)."""
    _PLAN_CACHE.clear()


def set_plan_cache_capacity(capacity: Optional[int]) -> None:
    """Bound the process-wide plan cache to ``capacity`` plans (LRU), or
    lift the bound with ``None``. Takes effect at once."""
    _PLAN_CACHE.set_capacity(capacity)


def plan_cache_info() -> dict:
    """Size, capacity, hit, miss and eviction counters of the process-wide
    plan cache."""
    return _PLAN_CACHE.info()


def add_plan_eviction_hook(hook: EvictionHook) -> Callable[[], None]:
    """Observe the process-wide cache's evictions; returns a deregistration
    callable (see :meth:`PlanCache.add_eviction_hook`)."""
    return _PLAN_CACHE.add_eviction_hook(hook)


def resume(spec: TuckerSpec, x: Any, directory: Optional[str] = None, *,
           generator: Optional[torch.Generator] = None, injector: Any = None,
           device="cuda", group: Any = None) -> TuckerResult:
    """Restart a snapshotted decomposition from its latest snapshot.

    Loads the newest snapshot in ``directory`` (default: the spec's
    ``snapshot.directory``), checks that it describes the same problem
    (shape, ranks, method, algorithm) and runs the remaining sweeps through
    the cached plan for ``spec`` on ``device``, continuing the convergence
    state, so the final factors, core and fit history are the bits of a run
    that was never interrupted. ``generator`` is accepted as ``__call__``
    takes it and unused: the factors come from the snapshot.

    Elastic: a sharded spec whose ``num_devices`` exceeds the ranks of
    ``group`` (else of the default group, else 1) is clamped to them with a
    ``RuntimeWarning`` instead of failing. The snapshot's carry is
    replicated, so only the nonzeros re-shard: a job snapshotted on 4 ranks
    resumes on 2 (or 1), every rank reading the snapshot.
    """
    from repro_torch.tucker import snapshot as _snap

    if spec.snapshot is None:
        raise ValueError("resume() requires a spec with snapshot=SnapshotSpec(...)")
    directory = directory if directory is not None else spec.snapshot.directory
    with _obs_span("resume.restore", directory=str(directory)) as rsp:
        state = _snap.load_snapshot(directory)
        rsp.set_attr("sweeps_done", int(state.sweeps_done))
    _snap.check_compatible(spec, state)
    mesh = None
    if spec.shard is not None:
        n = world_size(group)
        if spec.shard.num_devices > n:
            warnings.warn(
                f"resuming a {spec.shard.num_devices}-device job on {n} attached "
                f"device(s): clamping ShardSpec.num_devices — the replicated snapshot "
                f"carry restores unchanged and the nonzeros re-shard over the smaller mesh",
                RuntimeWarning,
                stacklevel=2,
            )
            spec = dataclasses.replace(
                spec, shard=dataclasses.replace(spec.shard, num_devices=n))
        mesh = mesh_for_shard(spec.shard, group, device=device)
    return plan(spec, device=device, mesh=mesh)(x, generator=generator, resume_from=state,
                                                injector=injector)


def decompose(x: Any, ranks: Sequence[int], *, generator=None,
              factors_init: Any = None, device="cuda", **spec_kwargs) -> TuckerResult:
    """One-shot convenience: infer the spec from ``x`` (sparse for a
    ``SparseCOO``, dense for a numpy array or a tensor), plan (cached), run.

    ``spec_kwargs`` are :class:`TuckerSpec` fields (method, engine,
    pipeline, n_iter, tol, dtype, precision, algorithm, n_rounds).
    """
    spec = spec_for(x, ranks, **spec_kwargs)
    return plan(spec, device=device)(x, generator=generator, factors_init=factors_init)
