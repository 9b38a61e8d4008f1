"""Unified observability plane: tracing spans + metrics registry.

Port of ``repro.obs`` (pure Python, copied so that the port imports no JAX).
The environment switch is ``REPRO_TORCH_TRACE``, so that the two packages
never dump one session file.

One module-level :data:`tracer` and :data:`registry` are the process-wide
defaults every layer emits into — plan-cache lookups, plan calls and
batches, dispatches, and the serving plane's submit→flush→split all open
:func:`span`\\ s here, and
their counters live in :data:`registry` (see :mod:`repro_torch.obs.trace` and
:mod:`repro_torch.obs.metrics` for the mechanics).

Tracing defaults **off** — a disabled ``span()`` is a shared no-op after
one attribute check, so instrumentation costs effectively nothing on hot
paths. Turn it on with::

    import repro_torch.obs as obs
    obs.configure(enabled=True)          # optionally ring_capacity=...
    ... run sweeps / serve traffic ...
    obs.tracer.export_perfetto("trace.json")   # open in ui.perfetto.dev
    print(obs.registry.render_prometheus())    # Prometheus text format

or from the environment, with no code changes::

    REPRO_TORCH_TRACE=1 python my_run.py                # tracing on
    REPRO_TORCH_TRACE=/tmp/session.json python my_run.py  # on + dump at exit

A path-valued ``REPRO_TORCH_TRACE`` registers an ``atexit`` hook that writes the
whole session (spans + metrics snapshot) as JSON, which
``python -m repro_torch.obs --summary --perfetto out.json --prom session.json``
can inspect offline.
"""
from __future__ import annotations

import os
from typing import Optional

from repro_torch.obs.metrics import (
    Counter,
    Gauge,
    Histogram,
    MetricsRegistry,
)
from repro_torch.obs.trace import DEFAULT_RING_CAPACITY, Span, SpanEvent, Tracer

__all__ = [
    "Counter",
    "Gauge",
    "Histogram",
    "MetricsRegistry",
    "Span",
    "SpanEvent",
    "Tracer",
    "configure",
    "dump_session",
    "enabled",
    "event",
    "registry",
    "span",
    "tracer",
]

tracer = Tracer(enabled=False, ring_capacity=DEFAULT_RING_CAPACITY)
registry = MetricsRegistry()

# Bound methods of the default tracer: `obs.span("x")` is the idiom the
# whole stack uses, and keeping it a bound-method alias (not a wrapper
# function) keeps the disabled path at one attribute check + one call.
span = tracer.span
event = tracer.event


def enabled() -> bool:
    return tracer.enabled


def configure(enabled: Optional[bool] = None,
              ring_capacity: Optional[int] = None) -> None:
    """Configure the default tracer (see :meth:`Tracer.configure`)."""
    tracer.configure(enabled=enabled, ring_capacity=ring_capacity)


def dump_session(path: str) -> None:
    """Write spans + a metrics snapshot as one JSON session file, the
    format ``python -m repro_torch.obs`` inspects."""
    tracer.dump(path, metrics=registry.snapshot())


def _apply_env(value: Optional[str]) -> Optional[str]:
    """REPRO_TORCH_TRACE semantics: unset/"0"/"off"/"false"/"" leave tracing off;
    "1"/"on"/"true" turn it on; any other value is a path — tracing on plus
    an atexit session dump there. Returns the dump path (or None)."""
    if value is None:
        return None
    v = value.strip()
    if v.lower() in ("", "0", "off", "false", "no"):
        return None
    tracer.configure(enabled=True)
    if v.lower() in ("1", "on", "true", "yes"):
        return None
    return v


def _install_env_hook() -> None:
    path = _apply_env(os.environ.get("REPRO_TORCH_TRACE"))
    if path is None:
        return
    import atexit

    def _dump_at_exit(p: str = path) -> None:
        try:
            dump_session(p)
        except OSError:
            pass

    atexit.register(_dump_at_exit)


_install_env_hook()


def load_session(path: str) -> dict:
    """Read a session file written by :func:`dump_session` (or the
    ``REPRO_TORCH_TRACE=<path>`` atexit hook)."""
    import json

    with open(path) as f:
        data = json.load(f)
    if data.get("format") != "repro-obs-session":
        raise ValueError(
            f"{path} is not a repro obs session dump "
            f"(format={data.get('format')!r})"
        )
    return data
