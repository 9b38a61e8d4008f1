"""Structured tracing: spans into a bounded ring buffer, Perfetto export.

The paper's evaluation is a per-module cost ledger — TTM vs. Kron vs. QRP
wall-clock on each device — and this module is that ledger for the whole
stack: every lifecycle boundary (plan-cache lookup, plan call, batch
assembly, dispatch, serve-plane submit→flush→split) opens a :meth:`Tracer.span` and the finished span
events land in one process-wide, thread-safe ring buffer. From there they
export as Chrome trace-event JSON (``tracer.export_perfetto(path)`` —
loadable in Perfetto / ``chrome://tracing``) or aggregate into per-stage
millisecond summaries (``tracer.summary()``, ``TuckerResult.trace_summary``).

Design constraints, in order:

1. **Disabled is free.** The default is off; ``span()`` then returns a
   shared no-op context manager after one attribute check, so instrumented
   hot paths cost nanoseconds.
2. **Bounded.** The ring holds ``ring_capacity`` finished spans; a
   long-lived service overwrites its oldest history instead of growing.
3. **No device runtime.** Pure Python, importable from anywhere in the
   stack.

Parentage is a thread-local span stack: a span opened while another is
active on the same thread records it as ``parent``, which is how one served
request's ``serve.submit`` (producer thread) and its batch's ``serve.flush``
(scheduler thread) stay linkable — not by stack, but by the ``ticket``
attribute threaded through both.
"""
from __future__ import annotations

import dataclasses
import itertools
import json
import os
import threading
import time
from collections import deque
from typing import Any, Deque, Dict, Iterator, List, Optional

__all__ = ["SpanEvent", "Span", "Tracer"]


@dataclasses.dataclass(frozen=True)
class SpanEvent:
    """One finished span (immutable once in the ring).

    Attributes:
      name: the span taxonomy name (e.g. ``"sweep.dispatch"``).
      t0: start, ``time.perf_counter()`` seconds.
      t1: end, same clock.
      span_id: unique id within this tracer session.
      parent_id: enclosing span on the same thread, or ``None`` for roots.
      thread_id: ``threading.get_ident()`` of the emitting thread.
      thread_name: its ``Thread.name`` (Perfetto lane label).
      attrs: structured attributes (JSON-serializable values only).
    """

    name: str
    t0: float
    t1: float
    span_id: int
    parent_id: Optional[int]
    thread_id: int
    thread_name: str
    attrs: Dict[str, Any]

    @property
    def duration_ms(self) -> float:
        return (self.t1 - self.t0) * 1e3


class Span:
    """A live span handed to the ``with`` body; finished on exit.

    ``set_attr`` adds attributes discovered mid-span (e.g. ``sweeps_run``
    is only known after the dispatch returns)."""

    __slots__ = ("name", "span_id", "parent_id", "attrs", "_t0", "_tracer")

    def __init__(self, tracer: "Tracer", name: str,
                 parent_id: Optional[int], span_id: int,
                 attrs: Dict[str, Any]) -> None:
        self._tracer = tracer
        self.name = name
        self.span_id = span_id
        self.parent_id = parent_id
        self.attrs = attrs
        self._t0 = 0.0

    def set_attr(self, key: str, value: Any) -> None:
        self.attrs[key] = value

    def __enter__(self) -> "Span":
        self._tracer._push(self)
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, exc_type: Any, exc: Any, tb: Any) -> None:
        t1 = time.perf_counter()
        if exc_type is not None:
            self.attrs["error"] = exc_type.__name__
        self._tracer._pop(self, t1)


class _NoopSpan:
    """The shared disabled-path span: every method is a constant no-op."""

    __slots__ = ()
    name = ""
    span_id = -1
    parent_id = None

    def set_attr(self, key: str, value: Any) -> None:
        pass

    def __enter__(self) -> "_NoopSpan":
        return self

    def __exit__(self, *exc: Any) -> None:
        pass


_NOOP_SPAN = _NoopSpan()

DEFAULT_RING_CAPACITY = 65536


class Tracer:
    """Process-wide, thread-safe span recorder (see module docstring).

    One default instance lives in :mod:`repro_torch.obs`; libraries call
    ``obs.span(...)`` which delegates here. A disabled tracer's ``span``
    returns a shared no-op after a single attribute check — the fast path
    the overhead gate measures.
    """

    def __init__(self, enabled: bool = False,
                 ring_capacity: int = DEFAULT_RING_CAPACITY) -> None:
        self.enabled = bool(enabled)
        self._lock = threading.Lock()
        self._ring: Deque[SpanEvent] = deque(maxlen=int(ring_capacity))
        self._ids = itertools.count(1)
        self._tls = threading.local()
        # wall-clock anchor so perf_counter timestamps export as absolute
        # microseconds (Perfetto aligns multiple dumps by wall time).
        self._epoch_wall = time.time()
        self._epoch_perf = time.perf_counter()

    # -- configuration ------------------------------------------------------

    def configure(self, enabled: Optional[bool] = None,
                  ring_capacity: Optional[int] = None) -> None:
        """Flip tracing on/off and/or resize the ring (resizing keeps the
        newest events that fit)."""
        with self._lock:
            if enabled is not None:
                self.enabled = bool(enabled)
            if ring_capacity is not None:
                cap = int(ring_capacity)
                if cap < 1:
                    raise ValueError(
                        f"ring_capacity must be >= 1, got {ring_capacity}"
                    )
                self._ring = deque(self._ring, maxlen=cap)

    @property
    def ring_capacity(self) -> int:
        return self._ring.maxlen or 0

    def clear(self) -> None:
        with self._lock:
            self._ring.clear()

    # -- recording ----------------------------------------------------------

    def span(self, name: str, **attrs: Any) -> Any:
        """Context manager recording one span. Disabled: a shared no-op."""
        if not self.enabled:
            return _NOOP_SPAN
        return Span(self, name, self._current_id(), next(self._ids), attrs)

    def event(self, name: str, **attrs: Any) -> None:
        """Record an instantaneous event (a zero-duration span)."""
        if not self.enabled:
            return
        t = time.perf_counter()
        th = threading.current_thread()
        ev = SpanEvent(
            name=name, t0=t, t1=t, span_id=next(self._ids),
            parent_id=self._current_id(), thread_id=th.ident or 0,
            thread_name=th.name, attrs=dict(attrs),
        )
        with self._lock:
            self._ring.append(ev)

    def _stack(self) -> List[Span]:
        st = getattr(self._tls, "stack", None)
        if st is None:
            st = self._tls.stack = []
        return st

    def _current_id(self) -> Optional[int]:
        st = getattr(self._tls, "stack", None)
        return st[-1].span_id if st else None

    def _push(self, span: Span) -> None:
        self._stack().append(span)

    def _pop(self, span: Span, t1: float) -> None:
        st = self._stack()
        # tolerate misnesting (a span closed out of order drops cleanly)
        if span in st:
            while st and st[-1] is not span:
                st.pop()
            if st:
                st.pop()
        th = threading.current_thread()
        ev = SpanEvent(
            name=span.name, t0=span._t0, t1=t1, span_id=span.span_id,
            parent_id=span.parent_id, thread_id=th.ident or 0,
            thread_name=th.name, attrs=span.attrs,
        )
        with self._lock:
            self._ring.append(ev)

    # -- reading ------------------------------------------------------------

    def events(self) -> List[SpanEvent]:
        """Snapshot of the ring, oldest first."""
        with self._lock:
            return list(self._ring)

    def summary(self) -> Dict[str, Dict[str, float]]:
        """Per-span-name aggregate: count / total / mean / max milliseconds,
        over everything currently in the ring."""
        agg: Dict[str, Dict[str, float]] = {}
        for ev in self.events():
            ms = ev.duration_ms
            s = agg.setdefault(
                ev.name, {"count": 0, "total_ms": 0.0, "max_ms": 0.0}
            )
            s["count"] += 1
            s["total_ms"] += ms
            s["max_ms"] = max(s["max_ms"], ms)
        for s in agg.values():
            s["mean_ms"] = s["total_ms"] / max(1, s["count"])
        return agg

    def subtree_summary(self, root_id: int) -> Dict[str, float]:
        """Total milliseconds per span name over the *descendants* of
        ``root_id`` still in the ring — the per-stage breakdown
        ``TuckerResult.trace_summary`` carries. The root itself is excluded
        (it is usually still open when this is computed)."""
        events = self.events()
        parent = {ev.span_id: ev.parent_id for ev in events}
        cache: Dict[int, bool] = {root_id: True}

        def descends(sid: int) -> bool:
            seen = []
            cur: Optional[int] = sid
            while cur is not None and cur not in cache:
                seen.append(cur)
                cur = parent.get(cur)
            hit = cache.get(cur, False) if cur is not None else False
            for s in seen:
                cache[s] = hit
            return hit

        out: Dict[str, float] = {}
        for ev in events:
            if ev.span_id != root_id and descends(ev.span_id):
                out[ev.name] = out.get(ev.name, 0.0) + ev.duration_ms
        return out

    # -- export -------------------------------------------------------------

    def _to_us(self, t: float) -> float:
        return (self._epoch_wall + (t - self._epoch_perf)) * 1e6

    def perfetto_events(self) -> List[dict]:
        """The ring as Chrome trace-event dicts (phase ``X`` complete
        events; instantaneous events as phase ``i``)."""
        pid = os.getpid()
        out = []
        for ev in self.events():
            rec: Dict[str, Any] = {
                "name": ev.name,
                "cat": ev.name.split(".", 1)[0],
                "ph": "X" if ev.t1 > ev.t0 else "i",
                "ts": self._to_us(ev.t0),
                "pid": pid,
                "tid": ev.thread_id,
                "args": dict(
                    ev.attrs, span_id=ev.span_id, parent_id=ev.parent_id
                ),
            }
            if rec["ph"] == "X":
                rec["dur"] = (ev.t1 - ev.t0) * 1e6
            else:
                rec["s"] = "t"  # instant event scoped to its thread
            out.append(rec)
        return out

    def export_perfetto(self, path: str) -> int:
        """Write the ring as Chrome trace-event JSON (Perfetto-loadable).
        Returns the number of events written. Thread names ride along as
        metadata events so Perfetto labels the lanes."""
        events = self.perfetto_events()
        pid = os.getpid()
        seen_tids = {}
        for ev in self.events():
            seen_tids.setdefault(ev.thread_id, ev.thread_name)
        meta = [
            {
                "name": "thread_name", "ph": "M", "pid": pid, "tid": tid,
                "args": {"name": tname},
            }
            for tid, tname in seen_tids.items()
        ]
        payload = {
            "traceEvents": meta + events,
            "displayTimeUnit": "ms",
        }
        with open(path, "w") as f:
            json.dump(payload, f)
            f.write("\n")
        return len(events)

    def dump(self, path: str, metrics: Optional[dict] = None) -> None:
        """Write the whole session (span events + an optional metrics
        snapshot) as JSON, the format ``python -m repro_torch.obs`` reads back."""
        payload = {
            "format": "repro-obs-session",
            "version": 1,
            "pid": os.getpid(),
            "created_unix": time.time(),
            "spans": [dataclasses.asdict(ev) for ev in self.events()],
            "metrics": metrics or {},
        }
        with open(path, "w") as f:
            json.dump(payload, f)
            f.write("\n")

    def __iter__(self) -> Iterator[SpanEvent]:
        return iter(self.events())

    def __len__(self) -> int:
        with self._lock:
            return len(self._ring)
