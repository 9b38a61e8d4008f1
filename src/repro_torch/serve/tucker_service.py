"""TuckerService — the micro-batching Tucker decomposition service.

Port of ``repro.serve.tucker_service``. The paper's hybrid platform wins by
division of labor: the CPU aggregates and schedules, the accelerator runs
saturated batched TTM/Kron pipelines. ``repro_torch.tucker`` has the device
half (``TuckerPlan.batch``: one batched sweep program decomposes k
tensors, on the card through kernels 1 and 2, or 3 and 4 for order >= 4);
this module is the host half that feeds it. Callers ``submit()``
independent decomposition requests and get a future-style
:class:`TuckerTicket` back; a bounded pool of executor threads groups
compatible requests — same :class:`~repro_torch.tucker.spec.TuckerSpec`
and value dtype, whatever their nnz — into micro-batches and flushes each
as ONE batched dispatch the moment a queue holds ``max_batch`` requests or
its oldest request has waited ``max_wait_ms``. The service runs on the card
(``ServiceConfig.device``, ``"cuda"`` by default) unless asked for the CPU.

Concurrency model (the division of labor the paper's hybrid platform is
built on — CPU aggregates, accelerator never idles):

  * ``max_inflight_flushes`` executor threads pop ready batches
    independently, so flushes of *distinct* ``BatchKey``\\ s dispatch
    concurrently — one key's device wait no longer idles every other key.
  * Flushes of the *same* plan pipeline: host-side batch assembly (the
    members' factor draws and their stacking) runs outside the plan's
    dispatch lock, so one executor assembles flush N+1 while another runs
    flush N (see ``TuckerPlan``'s two-lock contract in
    ``tucker/planning.py``). Every executor launches on its thread's
    current stream, the device's default one: the kernels' launches stay
    ordered on one stream.
  * Admission control bounds the work in flight: with ``max_pending`` set,
    ``submit`` blocks (``backpressure='block'``) or raises
    :class:`ServiceOverloadedError` (``'reject'``) once that many requests
    are unresolved — queued *or* executing.
  * An optional adaptive batch policy (``adaptive_target_p99_ms``) closes
    the loop on the recorded latency distributions, narrowing a key's
    ``max_batch``/``max_wait_ms`` when its observed p99 overshoots the
    target and widening back when there is headroom.

Every execute path resolves every ticket it dequeued — error paths fail
them, and a belt-and-braces guard converts any would-be leak into a pointed
``RuntimeError`` rather than a silent ``result()`` hang.

Amortization contract (checked by ``chip_smoke.py`` phase 12 on the card):
under load, dispatches ≈ requests / max_batch, and every result carries a
:class:`~repro_torch.tucker.result.RequestTiming` showing where its
wall-clock went (queue wait vs. shared batched execute).

    with TuckerService(ServiceConfig(max_batch=8, max_wait_ms=2.0)) as svc:
        tickets = [svc.submit(idx, vals, spec) for idx, vals in requests]
        results = [t.result() for t in tickets]   # TuckerResult each

Synchronous API, internally queued: ``submit`` never blocks on device work;
``TuckerTicket.result()`` blocks until the request's batch has executed.

Across ranks (``ServiceConfig(shard=ShardSpec(n))``, ``n > 1``): every rank
of an n-rank ``torch.distributed`` group starts it, rank 0 as
``TuckerService(config)`` and every other rank as
:func:`serve_follower(config) <serve_follower>`. Rank 0 alone takes
requests (``TuckerService`` elsewhere raises) and runs admission, the batcher and
the executors as above; every flush that reaches dispatch goes through
rank 0's one dispatcher thread, the only place the service issues
collectives, so their order is total. Before each dispatch the dispatcher
announces it (``broadcast_object_list`` of a header: the spec and each
member's nnz and dtypes; then the members' indices and values as two
tensors), and every rank runs the same sharded ``plan(spec).batch``
(``ShardedSweepEngine``: each call broadcasts rank 0's initial factors,
then one all-reduce per mode a sweep). Results return on rank 0. While
idle the dispatcher announces a no-op every ``FOLLOWER_HEARTBEAT_S``, so
that waiting followers stay inside the group's collective timeout;
``close()`` announces the stop on which every follower returns. A failure
after an announce breaks the ranks' step: later dispatches fail, and the
followers' collectives time out and raise.
"""
from __future__ import annotations

import dataclasses
import itertools
import pickle
import queue
import threading
import time
import warnings
import weakref
from typing import Any, List, Optional, Sequence, Set

import torch
import torch.distributed as dist

from repro_torch.base import resolve_device
from repro_torch.core.coo import SparseCOO
from repro_torch.obs import event as _obs_event
from repro_torch.obs import span as _obs_span
from repro_torch.runtime.fault_tolerance import FtConfig, run_with_retries
from repro_torch.serve.batching import (
    AdaptiveBatchPolicy,
    BatchKey,
    Flush,
    MicroBatcher,
)
from repro_torch.serve.metrics import ServiceMetrics
from repro_torch.tucker.result import RequestTiming, TuckerResult
from repro_torch.tucker.spec import ShardSpec, TuckerSpec

__all__ = [
    "ServiceConfig",
    "ServiceOverloadedError",
    "TuckerService",
    "TuckerTicket",
    "live_services",
    "serve_follower",
]

_BACKPRESSURE_POLICIES = ("block", "reject")

# seconds between rank 0's no-op announces while a service across ranks is
# idle: a waiting follower must hear from rank 0 within the group's
# collective timeout (gloo's and NCCL's defaults are minutes)
FOLLOWER_HEARTBEAT_S = 5.0


class ServiceOverloadedError(RuntimeError):
    """``submit`` refused by admission control: the service already holds
    ``max_pending`` unresolved requests and ``backpressure='reject'``. The
    request was NOT enqueued — callers shed load or retry later."""


# The plan-cache capacity knob is process-global, but services come and go:
# this registry tracks which live services installed a capacity, so closing
# one never loosens the bound a still-running service relies on. The newest
# live holder's capacity rules; when the last holder closes, the capacity
# observed before ANY service touched it comes back.
_CAPACITY_LOCK = threading.Lock()
_CAPACITY_HOLDERS: List["TuckerService"] = []
_CAPACITY_BASELINE: Optional[int] = None
_CAPACITY_VERSION: Optional[int] = None  # cache version of OUR last install


def _install_capacity(svc: "TuckerService") -> None:
    from repro_torch import tucker

    global _CAPACITY_BASELINE, _CAPACITY_VERSION
    with _CAPACITY_LOCK:
        if not _CAPACITY_HOLDERS:
            _CAPACITY_BASELINE = tucker.plan_cache_info()["capacity"]
        _CAPACITY_HOLDERS.append(svc)
        tucker.set_plan_cache_capacity(svc.config.plan_cache_capacity)
        _CAPACITY_VERSION = tucker.plan_cache_info()["capacity_version"]


def _uninstall_capacity(svc: "TuckerService") -> None:
    from repro_torch import tucker

    global _CAPACITY_VERSION
    with _CAPACITY_LOCK:
        if svc not in _CAPACITY_HOLDERS:
            return
        _CAPACITY_HOLDERS.remove(svc)
        if tucker.plan_cache_info()["capacity_version"] != _CAPACITY_VERSION:
            # someone called set_plan_cache_capacity() manually since our
            # install (detected by version, so even re-setting the SAME
            # value counts) — their bound wins, don't clobber it
            return
        if _CAPACITY_HOLDERS:
            tucker.set_plan_cache_capacity(
                _CAPACITY_HOLDERS[-1].config.plan_cache_capacity
            )
            _CAPACITY_VERSION = tucker.plan_cache_info()["capacity_version"]
        else:
            tucker.set_plan_cache_capacity(_CAPACITY_BASELINE)


def _check_service_shard(shard: Any) -> None:
    """``shard`` is a :class:`~repro_torch.tucker.spec.ShardSpec`."""
    if not isinstance(shard, ShardSpec):
        raise TypeError(f"shard must be a ShardSpec or None, got {type(shard).__name__}")


def _across_ranks(shard: Optional[ShardSpec]) -> bool:
    return shard is not None and shard.num_devices > 1


def _service_group(shard: ShardSpec, group: Any, device) -> Any:
    """The group a service across ranks runs on (``group``, else the
    default one), checked: its world size must be ``shard.num_devices``,
    or ``mesh_for_shard``'s message is raised (before any collective)."""
    from repro_torch.tucker import planning

    if group is None:
        group = planning._default_group()
    if group is None or dist.get_world_size(group) != shard.num_devices:
        planning.mesh_for_shard(shard, group, device=device)  # raises: wrong world
    return group


class _Dispatcher:
    """Rank 0's one dispatcher thread of a service across ranks: the only
    thread that issues the service's collectives. Each dispatch is
    announced to the followers (a header, then the members' indices and
    values), then run as ``plan.batch`` on this thread while every
    follower runs the same; while idle, a no-op header every
    FOLLOWER_HEARTBEAT_S. A failure after an announce breaks the
    dispatcher: the ranks are out of step, so every later dispatch raises."""

    def __init__(self, mesh: Any) -> None:
        self.mesh = mesh
        self._src = dist.get_global_rank(mesh.group, 0)
        self._jobs: "queue.Queue" = queue.Queue()
        self._broken: Optional[BaseException] = None
        self._thread = threading.Thread(target=self._loop, name="tucker-service-dispatch",
                                        daemon=True)
        self._thread.start()

    def run(self, plan: Any, coos: Sequence[SparseCOO], generators: Sequence[Any]):
        """``plan.batch(coos, generators)`` on every rank; returns rank 0's
        results and the announce's ``{"bytes", "ms"}``."""
        job = {"plan": plan, "coos": list(coos), "generators": list(generators),
               "done": threading.Event()}
        self._jobs.put(job)
        while not job["done"].wait(FOLLOWER_HEARTBEAT_S):
            if not self._thread.is_alive():  # died outside a dispatch
                raise RuntimeError("the service's dispatcher thread has died: restart "
                                   "every rank")
        if "error" in job:
            raise job["error"]
        return job["results"], job["announce"]

    def stop(self) -> None:
        """Announce the stop (unless broken) and end the thread."""
        self._jobs.put(None)
        self._thread.join()

    def _header(self, header: dict) -> int:
        dist.broadcast_object_list([header], src=self._src, group=self.mesh.group)
        return len(pickle.dumps(header))

    def _payload(self, coos: List[SparseCOO]):
        """The members' indices and values, each as one tensor on the
        mesh's device (the collectives' device)."""
        dev = self.mesh.device
        return (torch.cat([c.indices for c in coos]).to(dev).contiguous(),
                torch.cat([c.values for c in coos]).to(dev).contiguous())

    def _announce(self, plan: Any, coos: List[SparseCOO], idx, vals) -> dict:
        t0 = time.perf_counter()
        dev = self.mesh.device
        nbytes = self._header({"op": "dispatch", "spec": plan.spec,
                               "nnz": [c.nnz for c in coos], "index_dtype": str(idx.dtype),
                               "value_dtype": str(vals.dtype)})
        for t in (idx, vals):
            dist.broadcast(t, src=self._src, group=self.mesh.group)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        return {"bytes": nbytes + idx.numel() * idx.element_size()
                + vals.numel() * vals.element_size(),
                "ms": (time.perf_counter() - t0) * 1e3}

    def _loop(self) -> None:
        while True:
            try:
                job = self._jobs.get(timeout=FOLLOWER_HEARTBEAT_S)
            except queue.Empty:
                self._tell_followers({"op": "noop"})
                continue
            if job is None:
                self._tell_followers({"op": "stop"})
                return
            try:
                self._dispatch(job)
            finally:
                job["done"].set()

    def _tell_followers(self, header: dict) -> None:
        """A header with no dispatch (a heartbeat, the stop), unless the
        ranks are out of step; a follower gone breaks the dispatcher."""
        if self._broken is None:
            try:
                self._header(header)
            except Exception as exc:
                self._broken = exc

    def _dispatch(self, job: dict) -> None:
        if self._broken is not None:
            job["error"] = RuntimeError(
                f"the service's ranks are out of step after a failed dispatch "
                f"({self._broken!r}): restart every rank")
            return
        try:  # before the announce: fails this dispatch's tickets only
            payload = self._payload(job["coos"])
        except Exception as exc:
            job["error"] = exc
            return
        try:
            job["announce"] = self._announce(job["plan"], job["coos"], *payload)
            job["results"] = job["plan"].batch(job["coos"], generators=job["generators"])
        except Exception as exc:  # in or after the announce: fails the run
            self._broken = exc
            job["error"] = exc


def serve_follower(config: "ServiceConfig", group: Any = None) -> None:
    """Follow rank 0's :class:`TuckerService` of a service across ranks,
    on every rank but 0 of ``group`` (the default group by default):
    receive each announced dispatch, run the same sharded
    ``plan(spec).batch`` on this rank's device (``config.device``), and
    repeat until rank 0's ``close()`` announces the stop. Returns nothing:
    results are rank 0's.

    ``config`` is rank 0's (its ``shard`` of ``num_devices > 1`` ranks).
    Raises without a group, on a group of another world size
    (``mesh_for_shard``'s message), on rank 0, and when a collective fails
    or times out (the group's ``timeout``)."""
    from repro_torch import tucker

    shard = config.shard
    if not _across_ranks(shard):
        raise ValueError("serve_follower follows a service across ranks: "
                         "ServiceConfig(shard=ShardSpec(num_devices > 1))")
    device = resolve_device(config.device)
    group = _service_group(shard, group, device)
    if dist.get_rank(group) == 0:
        raise RuntimeError("rank 0 runs the TuckerService; serve_follower is for the other "
                           "ranks")
    mesh = tucker.mesh_for_shard(shard, group, device=device)  # rank 0 builds it too
    src = dist.get_global_rank(group, 0)
    while True:
        box: List[Any] = [None]
        dist.broadcast_object_list(box, src=src, group=group)
        header = box[0]
        if header["op"] == "stop":
            return
        if header["op"] != "dispatch":
            continue  # rank 0's heartbeat
        spec, counts = header["spec"], header["nnz"]
        total = sum(counts)
        idx = torch.empty((total, len(spec.shape)), device=mesh.device,
                          dtype=getattr(torch, header["index_dtype"].replace("torch.", "")))
        vals = torch.empty((total,), device=mesh.device,
                           dtype=getattr(torch, header["value_dtype"].replace("torch.", "")))
        for t in (idx, vals):
            dist.broadcast(t, src=src, group=group)
        coos = [SparseCOO(i, v, spec.shape)
                for i, v in zip(idx.split(counts), vals.split(counts))]
        tucker.plan(spec, device=device, mesh=mesh).batch(coos)


@dataclasses.dataclass(frozen=True)
class ServiceConfig:
    """Tuning knobs of one :class:`TuckerService`.

    Attributes:
      max_batch: flush a queue the moment it holds this many requests (the
        batched program's leading axis; also the amortization ceiling).
      max_wait_ms: flush a non-full queue once its oldest request has waited
        this long — the latency bound a trickle of traffic pays for
        batching. 0 flushes on every scheduler wakeup (minimum latency,
        batches only form within one submit burst).
      plan_cache_capacity: if set, bound the global plan cache (LRU) so a
        long-lived service cannot pin every compiled program + device
        schedule it has ever seen (``tucker.set_plan_cache_capacity``). The
        knob is process-global: the newest live service's capacity rules,
        and the pre-service capacity returns when the last one closes.
      latency_window: samples retained per latency distribution.
      device: where the service's plans run: ``"cuda"`` (default; raises
        without a card) or ``"cpu"`` (the kernels' plain versions).
      shard: a :class:`~repro_torch.tucker.spec.ShardSpec`: every
        submitted spec without its own ``shard`` is planned with it, and
        each request runs as one sharded dispatch. One device is a world of
        one, with no collective; ``num_devices > 1`` serves across the ranks
        of a process group of that world size (the module docstring: rank 0
        constructs the service, every other rank runs
        :func:`serve_follower`). A spec submitted with its own shard of
        more than one device must carry the service's.
      max_retries: transient flush failures (RuntimeError) retried in place,
        on the same path, before the whole batch fails. 0 (default) fails
        fast; the terminal failure always reaches the tickets with no
        trailing backoff sleep.
      retry_backoff_ms: base of the exponential retry backoff.
      max_inflight_flushes: size of the executor pool — how many flushes may
        execute concurrently. 2 (default) overlaps one flush's device wait
        with another's host assembly; 1 restores the strictly sequential
        single-scheduler behavior.
      max_pending: admission bound — the most *unresolved* requests (queued
        or executing) the service accepts before applying backpressure.
        ``None`` (default) is unbounded.
      backpressure: what an over-``max_pending`` submit does: ``'block'``
        (default) waits for capacity; ``'reject'`` raises
        :class:`ServiceOverloadedError` immediately (counted in
        ``ServiceMetrics.rejected``).
      adaptive_target_p99_ms: if set, enable the per-key
        :class:`~repro_torch.serve.batching.AdaptiveBatchPolicy` with this target
        end-to-end p99 (ms); ``max_batch``/``max_wait_ms`` become the
        ceilings the policy widens back toward. ``None`` disables
        adaptation (static limits).
    """

    max_batch: int = 8
    max_wait_ms: float = 2.0
    plan_cache_capacity: Optional[int] = None
    latency_window: int = 8192
    device: str = "cuda"
    shard: Optional[ShardSpec] = None
    max_retries: int = 0
    retry_backoff_ms: float = 50.0
    max_inflight_flushes: int = 2
    max_pending: Optional[int] = None
    backpressure: str = "block"
    adaptive_target_p99_ms: Optional[float] = None

    def __post_init__(self) -> None:
        if self.shard is not None:
            _check_service_shard(self.shard)
        if int(self.max_inflight_flushes) < 1:
            raise ValueError(
                f"max_inflight_flushes must be >= 1, got "
                f"{self.max_inflight_flushes}"
            )
        if self.max_pending is not None and int(self.max_pending) < 1:
            raise ValueError(
                f"max_pending must be >= 1 (or None for unbounded), got "
                f"{self.max_pending}"
            )
        if self.backpressure not in _BACKPRESSURE_POLICIES:
            raise ValueError(
                f"backpressure must be one of {_BACKPRESSURE_POLICIES}, got "
                f"{self.backpressure!r}"
            )
        if (
            self.adaptive_target_p99_ms is not None
            and not float(self.adaptive_target_p99_ms) > 0.0
        ):
            raise ValueError(
                f"adaptive_target_p99_ms must be > 0 (or None to disable), "
                f"got {self.adaptive_target_p99_ms}"
            )


# process-wide monotonic ticket ids: the `ticket` span attribute that links a
# request's submit span (producer thread) to its batch's flush/dispatch/split
# spans (scheduler thread) in one exported trace.
_TICKET_IDS = itertools.count(1)


class TuckerTicket:
    """Future-style handle for one submitted request. Deliberately NOT a
    ``concurrent.futures.Future``: requests are never cancellable once
    queued (a flush takes its whole batch), so the Future cancel/running
    state machine would be dead API surface here.

    ``ticket_id`` is a process-wide monotonic id; it is also the ``ticket``
    attribute on the request's serve-plane spans, so one request's queue
    wait and its batch's execute can be correlated in a trace.
    """

    def __init__(self) -> None:
        self.ticket_id = next(_TICKET_IDS)
        self._done = threading.Event()
        self._result: Optional[TuckerResult] = None
        self._exception: Optional[BaseException] = None

    def done(self) -> bool:
        return self._done.is_set()

    def result(self, timeout: Optional[float] = None) -> TuckerResult:
        """Block until the request's batch executed; raise its error if the
        batch failed, ``TimeoutError`` if ``timeout`` elapsed first."""
        if not self._done.wait(timeout):
            raise TimeoutError("TuckerService request not done within timeout")
        if self._exception is not None:
            raise self._exception
        return self._result

    def exception(self, timeout: Optional[float] = None) -> Optional[BaseException]:
        if not self._done.wait(timeout):
            raise TimeoutError("TuckerService request not done within timeout")
        return self._exception

    # -- service-side completion ------------------------------------------

    def _set_result(self, result: TuckerResult) -> None:
        self._result = result
        self._done.set()

    def _set_exception(self, exc: BaseException) -> None:
        self._exception = exc
        self._done.set()


@dataclasses.dataclass
class _Pending:
    """One queued request (internal)."""

    coo: SparseCOO
    generator: Optional[object]  # per-request torch.Generator for factor init (or None)
    ticket: TuckerTicket
    submitted_at: float


_LIVE: "weakref.WeakSet[TuckerService]" = weakref.WeakSet()


def live_services(device_type: Optional[str] = None) -> int:
    """How many services of this process are started and not yet closed
    (on ``device_type`` only, when given)."""
    return sum(1 for s in list(_LIVE)
               if device_type is None or s.device.type == device_type)


class TuckerService:
    """Synchronous-API, internally queued micro-batching decomposition
    service. See the module docstring for the architecture and the
    concurrency model; thread-safe: any number of threads may ``submit``
    concurrently, and up to ``max_inflight_flushes`` flushes execute
    concurrently on the executor pool.
    """

    def __init__(self, config: Optional[ServiceConfig] = None, *, group: Any = None) -> None:
        """``group`` (a service across ranks only; the default group by
        default) is the process group the service shards over. Rank 0 of
        it builds the shard mesh here, a collective that the followers'
        :func:`serve_follower` joins; on another rank it raises
        ``RuntimeError``: that rank runs :func:`serve_follower`."""
        self.config = config or ServiceConfig()
        self.device = resolve_device(self.config.device)
        # a service across ranks: rank 0's mesh and dispatcher
        self._mesh = None
        self._dispatcher: Optional[_Dispatcher] = None
        if _across_ranks(self.config.shard):
            from repro_torch import tucker

            group = _service_group(self.config.shard, group, self.device)
            rank = dist.get_rank(group)
            if rank != 0:
                raise RuntimeError(
                    f"rank {rank} follows rank 0's TuckerService: only rank 0 submits; "
                    f"run serve_follower(config) on this rank")
            self._mesh = tucker.mesh_for_shard(self.config.shard, group, device=self.device)
            self._dispatcher = _Dispatcher(self._mesh)
        self.metrics = ServiceMetrics(latency_window=self.config.latency_window)
        self._lock = threading.Lock()
        self._cv = threading.Condition(self._lock)
        self._batcher = MicroBatcher(
            max_batch=self.config.max_batch,
            max_wait_s=self.config.max_wait_ms / 1e3,
        )
        self._policy: Optional[AdaptiveBatchPolicy] = None
        if self.config.adaptive_target_p99_ms is not None:
            self._policy = AdaptiveBatchPolicy(
                max_batch=self.config.max_batch,
                max_wait_s=self.config.max_wait_ms / 1e3,
                target_p99_ms=self.config.adaptive_target_p99_ms,
            )
        self._closing = False
        self._closed = False
        self._drain_on_close = True
        # admission-control state, guarded by self._cv: unresolved counts
        # every accepted request from enqueue until its ticket resolves;
        # inflight counts batches currently inside _execute.
        self._unresolved = 0
        self._inflight = 0
        self._warned_specs: Set[TuckerSpec] = set()
        self._remove_eviction_hook = None
        if self.config.plan_cache_capacity is not None:
            from repro_torch import tucker

            _install_capacity(self)
            self._remove_eviction_hook = tucker.add_plan_eviction_hook(
                self._on_plan_evicted
            )
        self._executors = [
            threading.Thread(
                target=self._executor_loop,
                name=f"tucker-service-exec-{i}",
                daemon=True,
            )
            for i in range(self.config.max_inflight_flushes)
        ]
        for t in self._executors:
            t.start()
        _LIVE.add(self)

    # -- public API ---------------------------------------------------------

    def submit(
        self,
        indices: Any,
        values: Any,
        spec: TuckerSpec,
        *,
        generator: Any = None,
    ) -> TuckerTicket:
        """Enqueue one decomposition of the COO tensor (``indices``,
        ``values``, shape = ``spec.shape``; numpy or torch, moved to the
        service's device at flush); returns immediately with a
        :class:`TuckerTicket`. ``generator`` (a ``torch.Generator``) draws
        the random initial factors (default: a CPU generator seeded with 0,
        as ``tucker.decompose``). The draw happens at flush, so a generator
        shared by several requests gives draws in flush order."""
        coo = SparseCOO.from_parts(indices, values, spec.shape)
        return self.submit_coo(coo, spec, generator=generator)

    def submit_coo(
        self, coo: SparseCOO, spec: TuckerSpec, *, generator: Any = None
    ) -> TuckerTicket:
        """`submit` for callers who already hold a ``SparseCOO``."""
        if spec.algorithm != "sparse":
            raise ValueError(
                f"TuckerService serves algorithm='sparse' specs, got "
                f"{spec.algorithm!r} (dense inputs have no nnz axis to batch)"
            )
        if spec.snapshot is not None:
            raise ValueError(
                "TuckerService does not serve snapshot specs: batch members "
                "would interleave step sequences in one checkpoint directory "
                "— run snapshot jobs directly via tucker.plan(spec)(coo)"
            )
        if tuple(coo.shape) != spec.shape:
            raise ValueError(
                f"input shape {tuple(coo.shape)} does not match the spec "
                f"shape {spec.shape}"
            )
        if spec.shard is not None:
            _check_service_shard(spec.shard)
            if _across_ranks(spec.shard) and spec.shard != self.config.shard:
                raise ValueError(
                    f"a spec sharded across {spec.shard.num_devices} ranks needs a "
                    f"TuckerService(ServiceConfig(shard={spec.shard!r})) on rank 0 of such a "
                    f"group, with serve_follower on the other ranks; this service's shard "
                    f"is {self.config.shard!r}")
        elif self.config.shard is not None:
            # the service's shard: plans built here run sharded
            spec = dataclasses.replace(spec, shard=self.config.shard)
        if coo.nnz == 0:
            raise ValueError(
                "cannot serve a tensor with zero stored nonzeros: an "
                "all-zero tensor has no defined Tucker fit (relative error "
                "is 0/0)"
            )
        # check-and-claim under the lock: concurrent first-submits of one
        # new spec used to race the bare set read/mutation below and both
        # run the synchronous plan() (duplicated compile) and both warn.
        # Exactly one submitter wins the claim; the plan() itself runs
        # OUTSIDE the lock (it can compile — holding the service lock across
        # it would stall every submit and executor).
        with self._lock:
            first_submit = spec not in self._warned_specs
            if first_submit:
                self._warned_specs.add(spec)
        if first_submit:
            from repro_torch import tucker

            # plan once per new spec, synchronously: a misconfigured spec
            # must raise HERE at the submit call site, like every other
            # validation error — not asynchronously as a whole-batch flush
            # failure in an executor thread. (A concurrent submit of the
            # same spec that lost the claim proceeds without waiting; if the
            # spec is truly broken its ticket fails at flush.)
            try:
                spec_plan = tucker.plan(spec, device=self.device, mesh=self._mesh_for(spec))
            except BaseException:
                # release the claim so the next submit re-validates instead
                # of silently treating a never-planned spec as known-good
                with self._lock:
                    self._warned_specs.discard(spec)
                raise
            # plan-level check, as batch() decides; a sharded request is one
            # dispatch by design, not a fallback
            if spec.shard is None and not spec_plan.supports_batched_dispatch:
                warnings.warn(
                    f"spec {spec.engine=} {spec.pipeline=} "
                    f"{spec.precision=} cannot share one batched "
                    f"dispatch; its flushes fall back to sequential "
                    f"execution (correct results, no amortization)",
                    RuntimeWarning,
                    stacklevel=3,
                )
        ticket = TuckerTicket()
        now = time.perf_counter()
        item = _Pending(coo=coo, generator=generator, ticket=ticket, submitted_at=now)
        dt = spec.resolved_dtype()
        bkey = BatchKey(
            spec=spec,
            dtype=str(dt) if dt is not None else str(coo.values.dtype),
        )
        with _obs_span("serve.submit", ticket=ticket.ticket_id, nnz=int(coo.nnz)):
            with self._cv:
                if self._closing:
                    raise RuntimeError("TuckerService is closed")
                if (
                    self.config.max_pending is not None
                    and self._unresolved >= self.config.max_pending
                ):
                    if self.config.backpressure == "reject":
                        self.metrics.on_reject()
                        _obs_event(
                            "serve.reject", ticket=ticket.ticket_id,
                            unresolved=self._unresolved,
                        )
                        raise ServiceOverloadedError(
                            f"TuckerService holds "
                            f"{self._unresolved} unresolved requests "
                            f"(max_pending={self.config.max_pending}, "
                            f"backpressure='reject')"
                        )
                    # block: wait for executors to resolve work (they
                    # notify_all on every batch completion) — or for close.
                    while self._unresolved >= self.config.max_pending:
                        self._cv.wait()
                        if self._closing:
                            raise RuntimeError("TuckerService is closed")
                self._unresolved += 1
                self._batcher.add(bkey, item, now)
                self.metrics.set_queue_depth(len(self._batcher))
                _obs_event("serve.enqueue", ticket=ticket.ticket_id)
                # counted before the notify can race a flush: 'submitted'
                # never trails 'completed' in a concurrent snapshot
                self.metrics.on_submit()
                # notify_all: executors AND admission-blocked submitters
                # share this condition; a single notify could wake only a
                # blocked submitter and leave the new work waiting out a
                # timeout before any executor re-checks.
                self._cv.notify_all()
        return ticket

    def decompose_batch(
        self,
        coos: Sequence[SparseCOO],
        spec: TuckerSpec,
        *,
        generators: Any = None,
        timeout: Optional[float] = None,
    ) -> List[TuckerResult]:
        """Convenience: submit many tensors, block for all results (in
        submission order). The scheduler still micro-batches them.
        ``timeout`` bounds the WHOLE call, not each ticket."""
        gens = list(generators) if generators is not None else [None] * len(coos)
        if len(gens) != len(coos):
            raise ValueError(f"got {len(gens)} generators for {len(coos)} tensors")
        tickets = [
            self.submit_coo(c, spec, generator=g) for c, g in zip(coos, gens)
        ]
        deadline = None if timeout is None else time.monotonic() + timeout
        results = []
        for t in tickets:
            left = (
                None if deadline is None
                else max(0.0, deadline - time.monotonic())
            )
            results.append(t.result(timeout=left))
        return results

    def flush(self) -> int:
        """Execute every queued request NOW, on the calling thread (drain
        semantics — partial batches allowed). Returns the number of requests
        flushed. Deterministic tests and latency-sensitive callers use this
        instead of waiting out ``max_wait_ms``. Raises ``RuntimeError`` on a
        closed (or closing) service: post-close the plan-cache capacity and
        eviction hooks are already uninstalled, so silently executing work
        there would run outside every bound the service promised."""
        flushed = 0
        while True:
            with self._cv:
                if self._closing:
                    raise RuntimeError("TuckerService is closed")
                batch = self._batcher.pop_any()
                if batch is not None:
                    self.metrics.set_queue_depth(len(self._batcher))
            if batch is None:
                return flushed
            flushed += len(batch.items)
            self._execute(batch)

    def pending(self) -> int:
        with self._cv:
            return len(self._batcher)

    def inflight(self) -> int:
        """Batches currently executing across the executor pool."""
        with self._cv:
            return self._inflight

    def close(self, drain: bool = True) -> None:
        """Stop the service. ``drain=True`` (default) executes everything
        still queued first; ``drain=False`` fails pending tickets with
        ``RuntimeError``. Idempotent. Joins the whole executor pool, so any
        in-flight flush finishes (and resolves its tickets) before close
        returns; across ranks it then announces the stop, on which every
        follower returns."""
        with self._cv:
            if self._closed:
                return
            self._closing = True
            self._drain_on_close = bool(drain)
            self._cv.notify_all()
        for t in self._executors:
            t.join()
        if self._dispatcher is not None:
            self._dispatcher.stop()
        with self._cv:
            self._closed = True
        _LIVE.discard(self)
        if self._remove_eviction_hook is not None:
            self._remove_eviction_hook()
        if self.config.plan_cache_capacity is not None:
            _uninstall_capacity(self)

    def __enter__(self) -> "TuckerService":
        return self

    def __exit__(self, *exc) -> None:
        self.close(drain=exc == (None, None, None))

    # -- executor pool -------------------------------------------------------

    def _executor_loop(self) -> None:
        """One executor thread: wait for a ready batch, execute it, repeat.
        ``max_inflight_flushes`` of these run concurrently — each pops under
        the shared condition variable, then executes OUTSIDE it, so distinct
        keys' flushes overlap and same-plan flushes pipeline on the plan's
        own dispatch lock."""
        while True:
            with self._cv:
                batch = None
                while True:
                    if self._closing and not self._drain_on_close:
                        break  # don't pop ready work just to throw it away
                    now = time.perf_counter()
                    batch = self._batcher.pop_ready(now)
                    if batch is not None or self._closing:
                        break
                    deadline = self._batcher.next_deadline()
                    # tiny epsilon past the deadline so the re-check after a
                    # timed wait sees it strictly expired.
                    self._cv.wait(
                        timeout=None
                        if deadline is None
                        else max(deadline - now, 0.0) + 1e-4
                    )
                if batch is None and self._closing:
                    if self._drain_on_close:
                        batch = self._batcher.pop_any()
                    else:
                        while True:
                            dropped = self._batcher.pop_any()
                            if dropped is None:
                                break
                            for item in dropped.items:
                                item.ticket._set_exception(
                                    RuntimeError(
                                        "TuckerService closed before execution"
                                    )
                                )
                            self.metrics.on_failure(len(dropped.items))
                            self._unresolved -= len(dropped.items)
                        self._cv.notify_all()
                    if batch is None:
                        self.metrics.set_queue_depth(len(self._batcher))
                        return
                self.metrics.set_queue_depth(len(self._batcher))
            self._execute(batch)

    # -- execution ----------------------------------------------------------

    def _execute(self, batch: Flush) -> None:
        # safe from any thread (an executor or a flush() caller): device
        # executions of one plan serialize on the plan's own dispatch lock,
        # where the engine schedule-cache hazard actually lives; host
        # assembly pipelines outside it.
        items = batch.items
        with self._cv:
            self._inflight += 1
            self.metrics.set_inflight(self._inflight)
        internal: Optional[BaseException] = None
        try:
            self._execute_inner(batch)
        except Exception as exc:
            # _execute_inner fails its batch internally on dispatch errors;
            # anything escaping it is a serve-plane bug (timing/metrics/
            # adaptation bookkeeping). The guard below turns it into ticket
            # failures — the executor itself must survive to keep the pool
            # at its configured width.
            internal = exc
            _obs_event(
                "serve.internal_error", error=type(exc).__name__,
                detail=str(exc),
            )
        finally:
            # NO execute path may leave a ticket permanently unresolved —
            # a leaked ticket is a silent result() hang. Anything not
            # resolved by the happy path or the batch-failure path (e.g. an
            # exception out of the timing/metrics code) fails loudly here.
            leaked = [it for it in items if not it.ticket.done()]
            if leaked:
                cause = (
                    f"({internal!r})" if internal is not None
                    else "(please report)"
                )
                for it in leaked:
                    it.ticket._set_exception(
                        RuntimeError(
                            "TuckerService internal error: flush finished "
                            f"without resolving this ticket {cause}"
                        )
                    )
                self.metrics.on_failure(len(leaked))
            with self._cv:
                self._unresolved -= len(items)
                self._inflight -= 1
                self.metrics.set_inflight(self._inflight)
                # capacity freed: wake admission-blocked submitters (and
                # close()-waiters)
                self._cv.notify_all()

    def _execute_inner(self, batch: Flush) -> None:
        from repro_torch import tucker

        items = batch.items
        tickets = [it.ticket.ticket_id for it in items]
        dequeued_at = time.perf_counter()
        with _obs_span(
            "serve.flush", reason=batch.reason, batch_size=len(items),
            tickets=tickets, executor=threading.current_thread().name,
        ) as fsp:
            try:
                spec = batch.key.spec
                plan = tucker.plan(spec, device=self.device, mesh=self._mesh_for(spec))
                generators = [it.generator for it in items]
                fsp.set_attr("vmappable", bool(plan.batch_is_vmappable(generators)))

                def dispatch() -> Any:
                    with _obs_span(
                        "serve.dispatch", tickets=tickets,
                        batch_size=len(items),
                    ) as dsp:
                        coos = [it.coo for it in items]
                        if self._dispatcher is None or not _across_ranks(spec.shard):
                            return plan.batch(coos, generators=generators)
                        # every rank runs this dispatch: rank 0's dispatcher
                        # announces it, then runs it
                        results, announce = self._dispatcher.run(plan, coos, generators)
                        dsp.set_attr("announce_bytes", announce["bytes"])
                        dsp.set_attr("announce_ms", announce["ms"])
                        return results

                if self.config.max_retries > 0:
                    results = run_with_retries(
                        dispatch,
                        FtConfig(max_retries=self.config.max_retries,
                                 retry_backoff_s=self.config.retry_backoff_ms / 1e3),
                        on_retry=lambda attempt, exc: self.metrics.on_retry(),
                    )
                else:
                    results = dispatch()
                if len(results) != len(items):
                    # a short (or long) result list would silently drop
                    # tickets in the zips below — result() would then hang
                    # forever. Fail the WHOLE batch with a pointed error.
                    raise RuntimeError(
                        f"plan.batch returned {len(results)} results for "
                        f"{len(items)} requests (spec={batch.key.spec!r}) — "
                        f"failing the whole batch instead of leaving "
                        f"{abs(len(items) - len(results))} tickets unresolved"
                    )
            except Exception as exc:  # fail the batch, keep the executor alive
                for it in items:
                    it.ticket._set_exception(exc)
                self.metrics.on_failure(len(items))
                fsp.set_attr("error", type(exc).__name__)
                return
            # plan.batch is synchronous through its device->host history
            # read, so `done` is an honest end-to-end execute timestamp.
            done = time.perf_counter()
            execute_ms = (done - dequeued_at) * 1e3
            queue_ms, total_ms = [], []
            for it, res in zip(items, results):
                q_ms = (dequeued_at - it.submitted_at) * 1e3
                t_ms = (done - it.submitted_at) * 1e3
                res.timing = RequestTiming(
                    queue_ms=q_ms,
                    execute_ms=execute_ms,
                    total_ms=t_ms,
                    batch_size=len(items),
                    nnz=it.coo.nnz,
                    # the batched sweeps stack the members and pad nothing
                    nnz_padded=it.coo.nnz,
                    flush_reason=batch.reason,
                )
                queue_ms.append(q_ms)
                total_ms.append(t_ms)
            self.metrics.on_flush(
                reason=batch.reason,
                batch_size=len(items),
                dispatches=sum(r.dispatches for r in results),
                nnz_real=sum(it.coo.nnz for it in items),
                nnz_padded=sum(r.timing.nnz_padded for r in results),
                execute_ms=execute_ms,
                queue_ms=queue_ms,
                total_ms=total_ms,
            )
            if self._policy is not None:
                with self._cv:
                    # policy state and batcher limits mutate under the
                    # service lock: concurrent flushes of one key must not
                    # interleave observe/apply
                    update = self._policy.observe(batch.key, total_ms)
                    if update is not None:
                        self._batcher.set_limits(
                            batch.key, update.max_batch, update.max_wait_s
                        )
                        # limits may have tightened: waiting executors must
                        # recompute deadlines/fullness
                        self._cv.notify_all()
                if update is not None:
                    self.metrics.on_adaptation(update.direction)
                    _obs_event(
                        "serve.adapt", direction=update.direction,
                        max_batch=update.max_batch,
                        max_wait_ms=update.max_wait_s * 1e3,
                        p99_ms=update.p99_ms,
                    )
            for it, res in zip(items, results):
                with _obs_span(
                    "serve.split", ticket=it.ticket.ticket_id,
                    queue_ms=res.timing.queue_ms,
                    total_ms=res.timing.total_ms,
                    nnz=int(it.coo.nnz),
                ):
                    it.ticket._set_result(res)

    def _mesh_for(self, spec: TuckerSpec) -> Any:
        """The mesh a plan of ``spec`` runs on here: the service's, for a
        spec sharded across its ranks (no collective at plan time); None
        otherwise (a world of one builds its own, with none)."""
        return self._mesh if _across_ranks(spec.shard) else None

    # -- plan-cache eviction observation ------------------------------------

    def _on_plan_evicted(self, key: Any, plan: Any) -> None:
        self.metrics.on_plan_eviction()
