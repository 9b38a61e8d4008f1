"""Service observability: latency percentiles + amortization counters.

Port of ``repro.serve.metrics``. The whole point of the micro-batching plane
is amortization — many requests per batched dispatch — so the metrics a
``TuckerService`` keeps are exactly the ones that prove (or disprove) it:
dispatch count vs. request count, flush reasons (did batches fill, or did
the timeout fire half-empty?), achieved batch sizes, padding overhead, and
queue/execute/total latency distributions (p50/p99). Thread-safe;
``snapshot()`` returns plain dicts.

Every counter here is a handle into the process-wide
:data:`repro_torch.obs.registry` — labeled ``service="svc-N"`` so concurrent
services coexist in one exposition — which puts the amortization counters
on ``registry.render_prometheus()``. One ``ServiceMetrics``-level lock covers
every multi-metric update and read: a flush's counter bumps land
atomically, never as a torn snapshot.
"""
from __future__ import annotations

import itertools
import threading
from collections import Counter, deque
from typing import Deque, Dict, Sequence

import numpy as np

from repro_torch.obs import registry as _obs_registry

# serve-plane latency histogram buckets (ms): finer than the default grid at
# the micro-batching sweet spot (sub-ms queue waits to ~100 ms executes).
_LATENCY_BUCKETS_MS = (
    0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 25.0, 50.0, 100.0, 250.0, 500.0,
    1000.0, 2500.0,
)

# one label per ServiceMetrics instance so N live services report distinct
# children of the same metric families.
_SERVICE_IDS = itertools.count()


class LatencyTracker:
    """Bounded reservoir of latency samples (milliseconds) with percentile
    summaries. A plain ``deque(maxlen=...)`` reservoir: a service soak cares
    about the *recent* distribution, and a hard bound keeps a long-lived
    process from growing an unbounded sample list."""

    def __init__(self, maxlen: int = 8192) -> None:
        self._samples: Deque[float] = deque(maxlen=maxlen)
        self.count = 0  # lifetime observations (reservoir may hold fewer)

    def observe(self, ms: float) -> None:
        self._samples.append(float(ms))
        self.count += 1

    def percentile(self, p: float) -> float:
        """p-th percentile of the retained samples; NaN when empty."""
        if not self._samples:
            return float("nan")
        return float(np.percentile(np.asarray(self._samples), p))

    def summary(self) -> Dict[str, float]:
        """``count`` is lifetime observations; ``window`` is the samples
        actually retained in the reservoir — the ones the percentiles are
        computed over. On a long soak the two diverge (count >> window):
        p50/p99 describe the recent window, not the whole run."""
        if not self._samples:
            return {"count": int(self.count), "window": 0,
                    "p50_ms": float("nan"), "p99_ms": float("nan"),
                    "mean_ms": float("nan"), "max_ms": float("nan")}
        arr = np.asarray(self._samples)
        return {
            "count": int(self.count),
            "window": int(arr.size),
            "p50_ms": float(np.percentile(arr, 50)),
            "p99_ms": float(np.percentile(arr, 99)),
            "mean_ms": float(arr.mean()),
            "max_ms": float(arr.max()),
        }


class ServiceMetrics:
    """Counters + latency trackers for one :class:`TuckerService`.

    Everything mutates under one lock; reads take consistent snapshots. The
    derived numbers the acceptance gates read:

      * ``requests_per_dispatch`` — the amortization factor (>> 1 is the
        service earning its keep; 1.0 is a sequential loop in disguise);
      * ``padding_overhead`` — padded nnz slots / real nnz (1.0 on the
        port, whose batched sweeps pad nothing);
      * latency summaries for queue wait, batched execute, and end-to-end.

    Counter state lives in :data:`repro_torch.obs.registry` handles labeled with
    this instance's ``service`` id; the instance lock (not the per-metric
    registry locks) is what makes multi-metric updates and ``snapshot()``
    reads atomic with respect to each other.
    """

    def __init__(self, latency_window: int = 8192,
                 service: str = "") -> None:
        self._lock = threading.Lock()
        self.service = service or f"svc-{next(_SERVICE_IDS)}"
        lbl = {"service": self.service}
        reg = _obs_registry
        self._submitted = reg.counter(
            "repro_serve_submitted_total", "requests submitted", labels=lbl
        )
        self._completed = reg.counter(
            "repro_serve_completed_total", "requests completed", labels=lbl
        )
        self._failed = reg.counter(
            "repro_serve_failed_total", "requests failed", labels=lbl
        )
        self._dispatches = reg.counter(
            "repro_serve_dispatches_total",
            "top-level dispatches issued by flushes", labels=lbl,
        )
        self._batch_size_sum = reg.counter(
            "repro_serve_batch_size_sum", "sum of flushed batch sizes",
            labels=lbl,
        )
        self._batch_size_max = reg.gauge(
            "repro_serve_batch_size_max", "largest batch flushed so far",
            labels=lbl,
        )
        self._nnz_real = reg.counter(
            "repro_serve_nnz_real_total", "real nonzeros streamed",
            labels=lbl,
        )
        self._nnz_padded = reg.counter(
            "repro_serve_nnz_padded_total",
            "padded nonzero slots streamed", labels=lbl,
        )
        self._plan_evictions = reg.counter(
            "repro_serve_plan_evictions_total",
            "global plan-cache evictions observed", labels=lbl,
        )
        self._retries = reg.counter(
            "repro_serve_retries_total",
            "transient flush failures retried in place", labels=lbl,
        )
        self._pending = reg.gauge(
            "repro_serve_pending", "requests queued but not yet resolved",
            labels=lbl,
        )
        self._rejected = reg.counter(
            "repro_serve_rejected_total",
            "submissions refused by admission control (backpressure='reject')",
            labels=lbl,
        )
        self._queue_depth = reg.gauge(
            "repro_serve_queue_depth",
            "requests sitting in micro-batch queues (not yet popped)",
            labels=lbl,
        )
        self._inflight = reg.gauge(
            "repro_serve_inflight_flushes",
            "flushes currently executing across the executor pool",
            labels=lbl,
        )
        # reason-labeled flush counters materialize lazily (reasons are a
        # small closed set: full/timeout/drain); likewise the
        # direction-labeled adaptation counters (narrow/widen).
        self._flush_counters: Dict[str, object] = {}
        self._adaptation_counters: Dict[str, object] = {}
        # exact recent-window percentiles stay on the deque reservoirs
        # (snapshot() bit-compat); the registry histograms expose the same
        # streams to Prometheus with cumulative-bucket semantics.
        self.queue = LatencyTracker(latency_window)
        self.execute = LatencyTracker(latency_window)
        self.total = LatencyTracker(latency_window)
        self._hist = {
            name: reg.histogram(
                f"repro_serve_{name}_latency_ms",
                f"{name} latency (milliseconds)",
                labels=lbl, buckets=_LATENCY_BUCKETS_MS,
            )
            for name in ("queue", "execute", "total")
        }

    # -- registry-backed views (names mirror the historical attributes) -----

    @property
    def submitted(self) -> int:
        return int(self._submitted.value)

    @property
    def completed(self) -> int:
        return int(self._completed.value)

    @property
    def failed(self) -> int:
        return int(self._failed.value)

    @property
    def dispatches(self) -> int:
        return int(self._dispatches.value)

    @property
    def batch_size_sum(self) -> int:
        return int(self._batch_size_sum.value)

    @property
    def batch_size_max(self) -> int:
        return int(self._batch_size_max.value)

    @property
    def nnz_real_sum(self) -> int:
        return int(self._nnz_real.value)

    @property
    def nnz_padded_sum(self) -> int:
        return int(self._nnz_padded.value)

    @property
    def plan_evictions(self) -> int:
        return int(self._plan_evictions.value)

    @property
    def retries(self) -> int:
        return int(self._retries.value)

    @property
    def rejected(self) -> int:
        return int(self._rejected.value)

    @property
    def queue_depth(self) -> int:
        return int(self._queue_depth.value)

    @property
    def inflight_flushes(self) -> int:
        return int(self._inflight.value)

    @property
    def flushes(self) -> Counter:
        """reason -> count, as a plain Counter (historical shape)."""
        with self._lock:
            return Counter(
                {r: int(c.value) for r, c in self._flush_counters.items()}
            )

    @property
    def adaptations(self) -> Counter:
        """direction -> count of adaptive batch-policy limit changes."""
        with self._lock:
            return Counter(
                {d: int(c.value) for d, c in self._adaptation_counters.items()}
            )

    def _flush_counter(self, reason: str):
        c = self._flush_counters.get(reason)
        if c is None:
            c = _obs_registry.counter(
                "repro_serve_flushes_total", "flushes by reason",
                labels={"service": self.service, "reason": reason},
            )
            self._flush_counters[reason] = c
        return c

    def _adaptation_counter(self, direction: str):
        c = self._adaptation_counters.get(direction)
        if c is None:
            c = _obs_registry.counter(
                "repro_serve_adaptations_total",
                "adaptive batch-policy limit changes by direction",
                labels={"service": self.service, "direction": direction},
            )
            self._adaptation_counters[direction] = c
        return c

    # -- recording (called by the service) ---------------------------------

    def on_submit(self, n: int = 1) -> None:
        with self._lock:
            self._submitted.inc(n)
            self._pending.inc(n)

    def on_flush(
        self,
        reason: str,
        batch_size: int,
        dispatches: int,
        nnz_real: int,
        nnz_padded: int,
        execute_ms: float,
        queue_ms: Sequence[float],
        total_ms: Sequence[float],
    ) -> None:
        with self._lock:
            self._flush_counter(reason).inc()
            self._dispatches.inc(int(dispatches))
            self._completed.inc(int(batch_size))
            self._pending.dec(int(batch_size))
            self._batch_size_sum.inc(int(batch_size))
            if int(batch_size) > int(self._batch_size_max.value):
                self._batch_size_max.set(int(batch_size))
            self._nnz_real.inc(int(nnz_real))
            self._nnz_padded.inc(int(nnz_padded))
            self.execute.observe(execute_ms)
            self._hist["execute"].observe(float(execute_ms))
            for q in queue_ms:
                self.queue.observe(q)
                self._hist["queue"].observe(float(q))
            for t in total_ms:
                self.total.observe(t)
                self._hist["total"].observe(float(t))

    def on_failure(self, batch_size: int) -> None:
        with self._lock:
            self._failed.inc(int(batch_size))
            self._pending.dec(int(batch_size))

    def on_plan_eviction(self) -> None:
        with self._lock:
            self._plan_evictions.inc()

    def on_retry(self) -> None:
        """A flush's dispatch failed transiently and is being retried in
        place (``ServiceConfig.max_retries``); the batch is
        not failed — only the terminal failure reaches ``on_failure``."""
        with self._lock:
            self._retries.inc()

    def on_reject(self, n: int = 1) -> None:
        """Admission control refused a submit (backpressure='reject'). The
        request never entered the queue, so ``submitted`` does NOT count
        it — ``submitted`` stays 'accepted submissions'."""
        with self._lock:
            self._rejected.inc(n)

    def on_adaptation(self, direction: str) -> None:
        with self._lock:
            self._adaptation_counter(direction).inc()

    def set_queue_depth(self, depth: int) -> None:
        with self._lock:
            self._queue_depth.set(int(depth))

    def set_inflight(self, n: int) -> None:
        with self._lock:
            self._inflight.set(int(n))

    # -- derived -----------------------------------------------------------

    # unlocked formula helpers: the one definition each, shared by the
    # public accessors and snapshot() (whose non-reentrant lock is already
    # held when it needs them)
    def _requests_per_dispatch(self) -> float:
        d = int(self._dispatches.value)
        return int(self._completed.value) / d if d else 0.0

    def _padding_overhead(self) -> float:
        real = int(self._nnz_real.value)
        if not real:
            return float("nan")
        return int(self._nnz_padded.value) / real

    def requests_per_dispatch(self) -> float:
        with self._lock:
            return self._requests_per_dispatch()

    def padding_overhead(self) -> float:
        """padded/real nnz slot ratio (>= 1.0; 1.0 means zero waste)."""
        with self._lock:
            return self._padding_overhead()

    def snapshot(self) -> dict:
        """Consistent JSON-ready view of every counter and distribution."""
        with self._lock:
            flushes = {
                r: int(c.value) for r, c in self._flush_counters.items()
            }
            n_flushes = sum(flushes.values())
            submitted = int(self._submitted.value)
            completed = int(self._completed.value)
            failed = int(self._failed.value)
            snap = {
                "submitted": submitted,
                "completed": completed,
                "failed": failed,
                "pending": submitted - completed - failed,
                "dispatches": int(self._dispatches.value),
                "flushes": flushes,
                "requests_per_dispatch": self._requests_per_dispatch(),
                "batch_size_mean": (
                    int(self._batch_size_sum.value) / n_flushes
                    if n_flushes else 0.0
                ),
                "batch_size_max": int(self._batch_size_max.value),
                "plan_evictions": int(self._plan_evictions.value),
                "retries": int(self._retries.value),
                "rejected": int(self._rejected.value),
                "queue_depth": int(self._queue_depth.value),
                "inflight_flushes": int(self._inflight.value),
                "adaptations": {
                    d: int(c.value)
                    for d, c in self._adaptation_counters.items()
                },
                "padding_overhead": self._padding_overhead(),
                "queue": self.queue.summary(),
                "execute": self.execute.summary(),
                "total": self.total.summary(),
            }
        return snap
