"""Micro-batching queue plane of the Tucker decomposition service.

Port of ``repro.serve.batching``. The paper's hybrid platform keeps the
accelerator saturated by letting the CPU aggregate work into full dataflow
batches before streaming them to the FPGA (Sec. III-B); this module is that
host-side aggregation, made explicit: requests land in per-:class:`BatchKey`
queues — one queue per (spec, value dtype), because only same-spec
tensors can ride one batched program — and a flush pops up to
``max_batch`` of them the moment a queue fills or its oldest request has
waited ``max_wait_s``.

The reference also keys its queues by an nnz bucket, the padded shape of
its compiled program. The port's batched sweeps stack the members and pad
nothing, so requests of any nnz share a queue.

Pure data structure, no threads, no device: the service holds its lock
around every call, and the deterministic tests drive it with a fake clock.
"""
from __future__ import annotations

import dataclasses
from collections import OrderedDict, deque
from typing import Any, Deque, Dict, Optional, Sequence, Tuple

import numpy as np

from repro_torch.tucker.spec import TuckerSpec

# why a batch left its queue (RequestTiming.flush_reason / metrics label)
FLUSH_FULL = "full"  # queue reached max_batch
FLUSH_TIMEOUT = "timeout"  # oldest member waited max_wait_s
FLUSH_DRAIN = "drain"  # explicit flush() / service close


@dataclasses.dataclass(frozen=True)
class BatchKey:
    """What must match for requests to share one batched dispatch: the whole
    (hashable) spec and the working value dtype. For a concrete spec dtype
    every request lands on that dtype (the plan casts); under dtype='auto'
    the observed input dtype routes, so one flush never mixes precisions
    (which would silently promote the narrow members)."""

    spec: TuckerSpec
    dtype: str = "float32"


@dataclasses.dataclass(frozen=True)
class Flush:
    """One popped micro-batch, ready to execute as a single dispatch."""

    key: BatchKey
    items: Tuple[Any, ...]
    reason: str  # FLUSH_FULL / FLUSH_TIMEOUT / FLUSH_DRAIN


class MicroBatcher:
    """Per-key FIFO queues with a full-or-timeout flush policy.

    Not thread-safe by design — the owner serializes access (the service
    wraps every call in its condition-variable lock). Time is an argument,
    never read from a clock, so flush decisions are exactly reproducible.
    """

    def __init__(self, max_batch: int, max_wait_s: float) -> None:
        if int(max_batch) < 1:
            raise ValueError(f"max_batch must be >= 1, got {max_batch}")
        if not float(max_wait_s) >= 0.0:  # also rejects NaN
            raise ValueError(f"max_wait_s must be >= 0, got {max_wait_s}")
        self.max_batch = int(max_batch)
        self.max_wait_s = float(max_wait_s)
        # insertion-ordered so pop scans oldest-created queues first (fairness
        # between keys under sustained load).
        self._queues: "OrderedDict[BatchKey, Deque[Tuple[float, Any]]]" = (
            OrderedDict()
        )
        # per-key (max_batch, max_wait_s) overrides, fed by the adaptive
        # policy; they outlive queue churn because the policy's view of a
        # key's latency does.
        self._limits: Dict[BatchKey, Tuple[int, float]] = {}

    def __len__(self) -> int:
        return sum(len(q) for q in self._queues.values())

    def depth(self, key: BatchKey) -> int:
        q = self._queues.get(key)
        return 0 if q is None else len(q)

    def limits(self, key: BatchKey) -> Tuple[int, float]:
        """Effective (max_batch, max_wait_s) for ``key`` — the per-key
        override when one is set, the constructor defaults otherwise."""
        return self._limits.get(key, (self.max_batch, self.max_wait_s))

    def set_limits(self, key: BatchKey, max_batch: int, max_wait_s: float) -> None:
        """Install a per-key flush-policy override (adaptive batch policy)."""
        if int(max_batch) < 1:
            raise ValueError(f"max_batch must be >= 1, got {max_batch}")
        if not float(max_wait_s) >= 0.0:
            raise ValueError(f"max_wait_s must be >= 0, got {max_wait_s}")
        self._limits[key] = (int(max_batch), float(max_wait_s))

    def add(self, key: BatchKey, item: Any, now: float) -> int:
        """Enqueue one request; returns the queue's new depth."""
        q = self._queues.get(key)
        if q is None:
            q = self._queues[key] = deque()
        q.append((now, item))
        return len(q)

    def next_deadline(self) -> Optional[float]:
        """Earliest instant any queue becomes flushable by timeout (its
        oldest enqueue + that key's ``max_wait_s``); ``None`` when everything
        is empty. A full queue's deadline is *now* — callers re-check
        ``pop_ready``."""
        deadlines = [
            q[0][0] + self.limits(key)[1]
            for key, q in self._queues.items()
            if q
        ]
        return min(deadlines) if deadlines else None

    def pop_ready(self, now: float) -> Optional[Flush]:
        """Pop ONE flushable micro-batch. Queues whose oldest request has
        waited past its key's ``max_wait_s`` go first, earliest deadline
        first — otherwise sustained traffic that keeps one key's queue full
        would starve every other key past its latency bound. With no deadline
        expired, any full queue pops immediately (it saturates a dispatch —
        no reason to wait)."""
        due = [
            (q[0][0] + self.limits(key)[1], key)
            for key, q in self._queues.items()
            if q and now - q[0][0] >= self.limits(key)[1]
        ]
        if due:
            # key= guards timestamp ties: BatchKey itself is unordered, and
            # a bare tuple-min would fall through to comparing keys and raise.
            _, key = min(due, key=lambda d: d[0])
            full = len(self._queues[key]) >= self.limits(key)[0]
            return self._pop(key, FLUSH_FULL if full else FLUSH_TIMEOUT)
        for key, q in self._queues.items():
            if len(q) >= self.limits(key)[0]:
                return self._pop(key, FLUSH_FULL)
        return None

    def pop_any(self) -> Optional[Flush]:
        """Pop ONE micro-batch regardless of readiness (drain/close path)."""
        for key, q in self._queues.items():
            if q:
                return self._pop(key, FLUSH_DRAIN)
        return None

    def _pop(self, key: BatchKey, reason: str) -> Flush:
        q = self._queues[key]
        cap = self.limits(key)[0]
        items = tuple(q.popleft()[1] for _ in range(min(len(q), cap)))
        if not q:
            del self._queues[key]  # keys churn; don't accumulate empties
        return Flush(key=key, items=items, reason=reason)


@dataclasses.dataclass
class _KeyPolicyState:
    batch: int
    wait_s: float
    samples: Deque[float]
    flushes_since_eval: int = 0


@dataclasses.dataclass(frozen=True)
class PolicyUpdate:
    """One adaptation decision for a key: the new effective limits plus the
    direction ("narrow" / "widen") and the p99 that triggered it."""

    max_batch: int
    max_wait_s: float
    direction: str
    p99_ms: float


class AdaptiveBatchPolicy:
    """Closed-loop per-key (max_batch, max_wait) controller.

    PR 5 records per-request p50/p99 but never acts on it; this closes the
    loop. Each key keeps a sliding window of observed end-to-end latencies
    (queue wait + execute, in ms). Every ``period`` flushes of a key the
    window's p99 is compared against ``target_p99_ms``:

    * p99 above target → **narrow**: halve both the wait budget and the
      batch ceiling (floors ``min_batch`` / ``min_wait_s``), trading device
      efficiency for latency.
    * p99 under half the target → **widen**: grow both multiplicatively
      back toward the configured ceilings, recovering batching efficiency
      once the tail has headroom.
    * otherwise → hold.

    Pure host-side arithmetic — no clock reads, no threads; the service
    serializes calls and pushes accepted updates into
    :meth:`MicroBatcher.set_limits`. Deterministic given the observed
    samples, so unit tests drive it with synthetic latencies.
    """

    def __init__(
        self,
        max_batch: int,
        max_wait_s: float,
        target_p99_ms: float,
        *,
        window: int = 128,
        period: int = 4,
        min_batch: int = 1,
        min_wait_s: float = 0.0,
    ) -> None:
        if not float(target_p99_ms) > 0.0:
            raise ValueError(f"target_p99_ms must be > 0, got {target_p99_ms}")
        if int(period) < 1:
            raise ValueError(f"period must be >= 1, got {period}")
        self.max_batch = int(max_batch)
        self.max_wait_s = float(max_wait_s)
        self.target_p99_ms = float(target_p99_ms)
        self.window = int(window)
        self.period = int(period)
        self.min_batch = int(min_batch)
        self.min_wait_s = float(min_wait_s)
        self._keys: Dict[BatchKey, _KeyPolicyState] = {}

    def limits(self, key: BatchKey) -> Tuple[int, float]:
        """Current effective (max_batch, max_wait_s) for ``key``."""
        st = self._keys.get(key)
        if st is None:
            return (self.max_batch, self.max_wait_s)
        return (st.batch, st.wait_s)

    def observe(
        self, key: BatchKey, total_ms: Sequence[float]
    ) -> Optional[PolicyUpdate]:
        """Feed one flush's per-request end-to-end latencies; returns a
        :class:`PolicyUpdate` when the control law changes the key's limits,
        ``None`` when it holds (or this flush isn't an evaluation point)."""
        st = self._keys.get(key)
        if st is None:
            st = self._keys[key] = _KeyPolicyState(
                batch=self.max_batch,
                wait_s=self.max_wait_s,
                samples=deque(maxlen=self.window),
            )
        st.samples.extend(float(t) for t in total_ms)
        st.flushes_since_eval += 1
        if st.flushes_since_eval < self.period or not st.samples:
            return None
        st.flushes_since_eval = 0
        p99 = float(np.percentile(np.asarray(st.samples, dtype=np.float64), 99))
        old = (st.batch, st.wait_s)
        if p99 > self.target_p99_ms:
            st.batch = max(self.min_batch, st.batch // 2)
            st.wait_s = max(self.min_wait_s, st.wait_s / 2.0)
            direction = "narrow"
        elif p99 < 0.5 * self.target_p99_ms:
            st.batch = min(self.max_batch, max(st.batch + 1, int(st.batch * 1.5)))
            # max() lets the wait recover even after narrowing drove it to ~0
            st.wait_s = min(
                self.max_wait_s, max(st.wait_s * 1.5, self.max_wait_s / 64.0)
            )
            direction = "widen"
        else:
            return None
        if (st.batch, st.wait_s) == old:
            return None
        return PolicyUpdate(
            max_batch=st.batch,
            max_wait_s=st.wait_s,
            direction=direction,
            p99_ms=p99,
        )
