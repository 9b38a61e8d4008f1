"""Typed metrics registry: Counter/Gauge/Histogram, Prometheus + JSON export.

One process-wide :class:`MetricsRegistry` (the default lives in
:mod:`repro_torch.obs`) subsumes the stack's scattered stats: the plan cache's
hit/miss/eviction counts and the serving plane's amortization counters
(``ServiceMetrics`` is built on these primitives). Every metric registered
anywhere in the stack shows up in ``registry.render_prometheus()`` (text
exposition format, scrapeable) and ``registry.snapshot()`` (a JSON dict).

Metrics are cheap and always on — unlike spans they don't gate on
``obs.configure(enabled=...)``; a counter bump is one lock + one add.
Handles are identified by ``(name, labels)``: calling ``registry.counter``
twice with the same identity returns the same handle (so module-level
instrumentation and tests share state), and label sets let N service
instances coexist in one registry (``service="svc-0"``, ``service="svc-1"``)
without name collisions.
"""
from __future__ import annotations

import bisect
import math
import threading
from typing import Dict, List, Mapping, Optional, Sequence, Tuple

__all__ = [
    "Counter",
    "Gauge",
    "Histogram",
    "MetricsRegistry",
]

_LabelKey = Tuple[Tuple[str, str], ...]


def _label_key(labels: Optional[Mapping[str, str]]) -> _LabelKey:
    if not labels:
        return ()
    return tuple(sorted((str(k), str(v)) for k, v in labels.items()))


def _validate_name(name: str) -> str:
    if not name or not all(c.isalnum() or c in "_:" for c in name):
        raise ValueError(
            f"invalid metric name {name!r}: use [a-zA-Z0-9_:] only"
        )
    if name[0].isdigit():
        raise ValueError(f"invalid metric name {name!r}: starts with digit")
    return name


class _Metric:
    """Shared identity + lock for all metric kinds."""

    kind = "untyped"

    def __init__(self, name: str, help: str, labels: _LabelKey) -> None:
        self.name = name
        self.help = help
        self.labels = labels
        self._lock = threading.Lock()

    @property
    def label_str(self) -> str:
        if not self.labels:
            return ""
        inner = ",".join(f'{k}="{v}"' for k, v in self.labels)
        return "{" + inner + "}"


class Counter(_Metric):
    """Monotonically increasing count. ``inc`` rejects negative deltas."""

    kind = "counter"

    def __init__(self, name: str, help: str, labels: _LabelKey) -> None:
        super().__init__(name, help, labels)
        self._value = 0.0

    def inc(self, amount: float = 1.0) -> None:
        if amount < 0:
            raise ValueError(f"counter {self.name} cannot decrease")
        with self._lock:
            self._value += amount

    @property
    def value(self) -> float:
        with self._lock:
            return self._value

    def snapshot(self) -> float:
        return self.value


class Gauge(_Metric):
    """A value that can go up and down (queue depth, pending requests)."""

    kind = "gauge"

    def __init__(self, name: str, help: str, labels: _LabelKey) -> None:
        super().__init__(name, help, labels)
        self._value = 0.0

    def set(self, value: float) -> None:
        with self._lock:
            self._value = float(value)

    def inc(self, amount: float = 1.0) -> None:
        with self._lock:
            self._value += amount

    def dec(self, amount: float = 1.0) -> None:
        with self._lock:
            self._value -= amount

    @property
    def value(self) -> float:
        with self._lock:
            return self._value

    def snapshot(self) -> float:
        return self.value


# Default buckets span the stack's latency range: sub-ms counter bumps up
# through multi-second cold compiles (milliseconds).
DEFAULT_BUCKETS_MS = (
    0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 25.0, 50.0,
    100.0, 250.0, 500.0, 1000.0, 2500.0, 5000.0,
)


class Histogram(_Metric):
    """Cumulative-bucket histogram (Prometheus semantics): each observation
    lands in every bucket whose upper bound is >= the value, plus ``sum``
    and ``count``."""

    kind = "histogram"

    def __init__(self, name: str, help: str, labels: _LabelKey,
                 buckets: Sequence[float] = DEFAULT_BUCKETS_MS) -> None:
        super().__init__(name, help, labels)
        bs = sorted(float(b) for b in buckets)
        if not bs:
            raise ValueError(f"histogram {name} needs at least one bucket")
        self.buckets = tuple(bs)
        self._counts = [0] * (len(bs) + 1)  # +1 for +Inf
        self._sum = 0.0
        self._count = 0

    def observe(self, value: float) -> None:
        v = float(value)
        idx = bisect.bisect_left(self.buckets, v)
        with self._lock:
            self._counts[idx] += 1
            self._sum += v
            self._count += 1

    @property
    def count(self) -> int:
        with self._lock:
            return self._count

    @property
    def sum(self) -> float:
        with self._lock:
            return self._sum

    def snapshot(self) -> Dict[str, object]:
        with self._lock:
            counts = list(self._counts)
            total, n = self._sum, self._count
        cumulative = []
        running = 0
        for c in counts:
            running += c
            cumulative.append(running)
        return {
            "count": n,
            "sum": total,
            "mean": (total / n) if n else 0.0,
            "buckets": {
                ("+Inf" if i == len(self.buckets) else repr(self.buckets[i])):
                    cumulative[i]
                for i in range(len(counts))
            },
        }


class MetricsRegistry:
    """The single home for every metric in the process.

    ``counter``/``gauge``/``histogram`` are get-or-create by
    ``(name, labels)`` identity; re-registering with a different kind or
    (for histograms) different buckets is an error — two call sites that
    disagree about a metric are a bug worth surfacing."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._metrics: Dict[Tuple[str, _LabelKey], _Metric] = {}
        self._help: Dict[str, str] = {}

    def _get_or_create(self, cls, name: str, help: str,
                       labels: Optional[Mapping[str, str]],
                       **kwargs) -> _Metric:
        _validate_name(name)
        key = (name, _label_key(labels))
        with self._lock:
            existing = self._metrics.get(key)
            if existing is not None:
                if not isinstance(existing, cls):
                    raise ValueError(
                        f"metric {name!r} already registered as "
                        f"{existing.kind}, not {cls.kind}"
                    )
                if (cls is Histogram
                        and tuple(sorted(float(b) for b in kwargs.get(
                            "buckets", DEFAULT_BUCKETS_MS)))
                        != existing.buckets):
                    raise ValueError(
                        f"histogram {name!r} already registered with "
                        f"different buckets"
                    )
                return existing
            if help:
                self._help.setdefault(name, help)
            m = cls(name, self._help.get(name, help), key[1], **kwargs)
            self._metrics[key] = m
            return m

    def counter(self, name: str, help: str = "",
                labels: Optional[Mapping[str, str]] = None) -> Counter:
        return self._get_or_create(Counter, name, help, labels)

    def gauge(self, name: str, help: str = "",
              labels: Optional[Mapping[str, str]] = None) -> Gauge:
        return self._get_or_create(Gauge, name, help, labels)

    def histogram(self, name: str, help: str = "",
                  labels: Optional[Mapping[str, str]] = None,
                  buckets: Sequence[float] = DEFAULT_BUCKETS_MS,
                  ) -> Histogram:
        return self._get_or_create(
            Histogram, name, help, labels, buckets=buckets
        )

    def metrics(self) -> List[_Metric]:
        with self._lock:
            return list(self._metrics.values())

    def reset(self) -> None:
        """Drop every registered metric (tests only — live handles held by
        modules keep working but detach from the registry)."""
        with self._lock:
            self._metrics.clear()
            self._help.clear()

    # -- export -------------------------------------------------------------

    def snapshot(self) -> Dict[str, object]:
        """JSON-serializable snapshot of every metric: scalar for
        counters/gauges, a dict for histograms. Labeled metrics key as
        ``name{k="v"}``."""
        out: Dict[str, object] = {}
        for m in sorted(
            self.metrics(), key=lambda m: (m.name, m.labels)
        ):
            out[m.name + m.label_str] = m.snapshot()
        return out

    def render_prometheus(self) -> str:
        """Text exposition format (one HELP/TYPE header per family, then
        one line per labeled child; histograms expand to
        ``_bucket{le=...}``/``_sum``/``_count``)."""
        by_name: Dict[str, List[_Metric]] = {}
        for m in self.metrics():
            by_name.setdefault(m.name, []).append(m)
        lines: List[str] = []
        for name in sorted(by_name):
            family = sorted(by_name[name], key=lambda m: m.labels)
            kind = family[0].kind
            help_text = family[0].help or name
            lines.append(f"# HELP {name} {help_text}")
            lines.append(f"# TYPE {name} {kind}")
            for m in family:
                if isinstance(m, Histogram):
                    snap = m.snapshot()
                    base = dict(m.labels)
                    running = snap["buckets"]
                    bounds = [repr(b) for b in m.buckets] + ["+Inf"]
                    for le in bounds:
                        lbl = dict(base)
                        lbl["le"] = le
                        inner = ",".join(
                            f'{k}="{v}"' for k, v in sorted(lbl.items())
                        )
                        lines.append(
                            f"{name}_bucket{{{inner}}} {running[le]}"
                        )
                    lines.append(
                        f"{name}_sum{m.label_str} {_fmt(snap['sum'])}"
                    )
                    lines.append(f"{name}_count{m.label_str} {snap['count']}")
                else:
                    lines.append(
                        f"{name}{m.label_str} {_fmt(m.snapshot())}"
                    )
        return "\n".join(lines) + ("\n" if lines else "")


def _fmt(v: float) -> str:
    f = float(v)
    if math.isinf(f):
        return "+Inf" if f > 0 else "-Inf"
    if f == int(f) and abs(f) < 1e15:
        return str(int(f))
    return repr(f)
