"""Launch counts of the port's kernels: process-wide, and per thread.

Each wrapper counts one launch where it launches its kernel, and nowhere
else: in ``wrapper.launches`` (process-wide; ``chip_smoke.py`` resets and
reads it) and in the calling thread's tally by kernel name. A plan reads
the tally around one call, so ``TuckerResult.launches`` stays exact while
other threads launch too (a service's concurrent flushes).
"""
from __future__ import annotations

import threading
from typing import Callable, Dict

_LOCK = threading.Lock()
_TLS = threading.local()


def count(wrapper: Callable) -> None:
    """One launch of ``wrapper``'s kernel, on this thread."""
    with _LOCK:
        wrapper.launches += 1
    tally = getattr(_TLS, "tally", None)
    if tally is None:
        tally = _TLS.tally = {}
    name = wrapper.__name__
    tally[name] = tally.get(name, 0) + 1


def tally() -> Dict[str, int]:
    """A copy of this thread's launches so far, by kernel name."""
    return dict(getattr(_TLS, "tally", {}))


def since(before: Dict[str, int]) -> Dict[str, int]:
    """This thread's launches by kernel name since ``before`` (a
    :func:`tally`), the kernels it did not launch left out."""
    now = tally()
    return {k: v - before.get(k, 0) for k, v in now.items() if v != before.get(k, 0)}
