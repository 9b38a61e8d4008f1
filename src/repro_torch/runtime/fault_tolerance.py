"""Fault-tolerance runtime: heartbeats, straggler detection, the retry
policy and failure injection.

Port of ``repro.runtime.fault_tolerance`` (no JAX there either; copied so
that the port imports nothing of the reference). Its users here: the
snapshot segment loop of ``repro_torch.tucker.planning`` (one retried
segment a transient failure) and ``repro_torch.serve.TuckerService`` (one
retried flush). Every retried attempt bumps ``repro_retries_total`` in
``repro_torch.obs.registry``.
"""
from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Callable, Deque, Dict, List, Optional

from repro_torch.obs import event as _obs_event
from repro_torch.obs import registry as _obs_registry

_RETRIES = _obs_registry.counter(
    "repro_retries_total", "retried attempts under run_with_retries"
)


@dataclasses.dataclass
class FtConfig:
    checkpoint_every: int = 50
    straggler_window: int = 20  # steps of timing history
    straggler_factor: float = 2.0  # step > factor * median -> straggler
    max_retries: int = 3
    retry_backoff_s: float = 0.05
    heartbeat_timeout_s: float = 60.0


class StragglerDetector:
    """Watermark detector over per-step host timings: a step slower than
    ``factor`` x the median of the last ``straggler_window`` steps is
    flagged (once at least five steps are known)."""

    def __init__(self, cfg: FtConfig):
        self.cfg = cfg
        self.history: Deque[float] = deque(maxlen=cfg.straggler_window)
        self.flags: List[int] = []

    def observe(self, step: int, dt: float) -> bool:
        h = sorted(self.history)
        if h:
            # the true median: on an even window the upper middle element
            # would bias the watermark high and under-flag stragglers
            mid = len(h) // 2
            median = h[mid] if len(h) % 2 else 0.5 * (h[mid - 1] + h[mid])
        else:
            median = dt
        is_straggler = len(self.history) >= 5 and dt > self.cfg.straggler_factor * median
        self.history.append(dt)
        if is_straggler:
            self.flags.append(step)
        return is_straggler


class Heartbeater:
    """Host liveness registry (coordinator side)."""

    def __init__(self, cfg: FtConfig, now: Callable[[], float] = time.monotonic):
        self.cfg = cfg
        self.now = now
        self.last_seen: Dict[str, float] = {}

    def beat(self, host: str) -> None:
        self.last_seen[host] = self.now()

    def dead_hosts(self) -> List[str]:
        t = self.now()
        return [h for h, last in self.last_seen.items()
                if t - last > self.cfg.heartbeat_timeout_s]


class FailureInjector:
    """Deterministic failure injection for tests: raise ``exc`` the first
    time each step in ``fail_at`` is reached (one-shot per step)."""

    def __init__(self, fail_at: Optional[List[int]] = None, exc: type = RuntimeError):
        self.fail_at = set(fail_at or [])
        self.exc = exc
        self.fired: set = set()

    def maybe_fail(self, step: int) -> None:
        if step in self.fail_at and step not in self.fired:
            self.fired.add(step)
            raise self.exc(f"injected failure at step {step}")


def run_with_retries(fn: Callable, cfg: FtConfig, on_retry: Optional[Callable] = None):
    """``fn()`` with up to ``cfg.max_retries`` retries of a ``RuntimeError``
    (the transient class), sleeping ``retry_backoff_s * 2**attempt`` between
    attempts.

    ``on_retry(attempt, exc)`` fires only when another attempt will run. The
    terminal failure re-raises at once, with no backoff before it, each
    earlier attempt's exception chained as ``__context__``.
    """
    last: Optional[RuntimeError] = None
    for attempt in range(cfg.max_retries + 1):
        try:
            return fn()
        except RuntimeError as e:  # the transient class
            if last is not None and e.__context__ is None:
                e.__context__ = last  # chain the attempts: no traceback is lost
            if attempt >= cfg.max_retries:
                raise
            last = e
            _RETRIES.inc()
            _obs_event("retry.attempt", attempt=attempt, error=type(e).__name__)
            if on_retry:
                on_retry(attempt, e)
            time.sleep(cfg.retry_backoff_s * (2 ** attempt))
    raise AssertionError("unreachable")  # pragma: no cover
