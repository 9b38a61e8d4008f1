"""Contract checks made while the sweeps run: no host sync, the precision
contract, the collective count. The twin of ``repro.analysis.hlo_lints``.

The reference reads these contracts off the optimized HLO of one compiled
program. Eager PyTorch has no such program, so each check here is dynamic:
it watches :func:`repro_torch.core.hooi.sparse_sweep` (and the batched
flush's :func:`~repro_torch.core.hooi.batched_sweep`) while a plan runs,
sweep by sweep.

  ==============  =====================================================
  check           what one sweep must show
  ==============  =====================================================
  transfer        no host sync inside the sweep. On the card the sweep
                  runs under ``torch.cuda.set_sync_debug_mode("error")``,
                  so the CUDA runtime itself raises at the first sync; a
                  sweep that raises is run again under ``"warn"`` to list
                  every site. On any device a ``TorchFunctionMode`` flags
                  ``.item()``, ``.cpu()``, ``.tolist()``, ``.numpy()`` and
                  ``__bool__`` / ``__int__`` / ``__float__`` /
                  ``__index__`` of a tensor (this part is what the CPU
                  tests exercise). The one read allowed — the ``tol``
                  flag between sweeps in ``run_segment``, and the fit
                  history after the last — lies outside the sweep
                  (a deviation on purpose: ROADMAP.md queue 3).
  precision       under ``fp32`` no bf16 / f16 tensor appears in the
                  sweep; under ``bf16_fp32acc`` Y_(n), the factors and G
                  stay in the working dtype (f32, f64 for f64 values)
                  and bf16 appears only inside the engine's kernel calls
                  (their operands).
  collective      a sharded sweep makes exactly N all-reduces (one per
                  mode) moving ``core.distributed.psum_bytes_per_sweep``
                  bytes, and no other collective; an unsharded one none.
  ==============  =====================================================

``donation`` has no dynamic twin: eager PyTorch donates no buffer.

The hooks replace module attributes of ``repro_torch.core.hooi`` and
``torch.distributed`` for the duration of one :func:`watch_sweeps` call
(one at a time in the process: a module lock). They watch only the thread
that called it: a sweep or collective on any other thread runs unwatched
and lands in no record. The card's sync debug mode is process-wide, so on
the card :func:`sweep_lint` refuses to run while a ``TuckerService`` on the
card is live in the process (its flushes would raise), and no other thread
may sweep on the card meanwhile.
"""
from __future__ import annotations

import contextlib
import dataclasses
import os
import sys
import threading
import warnings
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist
from torch.overrides import TorchFunctionMode

from repro_torch.analysis.findings import Finding

_T = torch.Tensor
HOST_READS = {
    _T.item: "item()", _T.cpu: "cpu()", _T.tolist: "tolist()", _T.numpy: "numpy()",
    _T.__bool__: "__bool__", _T.__int__: "__int__", _T.__float__: "__float__",
    _T.__index__: "__index__",
}
LOW_PRECISION = (torch.bfloat16, torch.float16)
COLLECTIVES = (
    "all_reduce", "broadcast", "all_gather", "all_gather_into_tensor", "reduce_scatter",
    "reduce_scatter_tensor", "all_to_all", "all_to_all_single", "reduce", "gather",
    "scatter", "send", "recv", "isend", "irecv", "barrier", "all_gather_object",
    "broadcast_object_list",
)
SYNC_MESSAGE = "synchronizing CUDA operation"

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))  # .../repro_torch
_SELF = os.path.dirname(os.path.abspath(__file__))  # .../repro_torch/analysis


def _site_of(filename: str, lineno: int, func: str = "") -> Optional[str]:
    path = os.path.abspath(filename)
    if not path.startswith(_PKG + os.sep) or path.startswith(_SELF + os.sep):
        return None
    rel = os.path.relpath(path, os.path.dirname(_PKG)).replace(os.sep, "/")
    return f"{rel}:{lineno}" + (f" ({func})" if func else "")


def _caller_site(depth: int = 2) -> str:
    """The innermost frame of the port (not of this package) on the stack."""
    f = sys._getframe(depth)
    while f is not None:
        site = _site_of(f.f_code.co_filename, f.f_lineno, f.f_code.co_name)
        if site is not None:
            return site
        f = f.f_back
    return "outside repro_torch"


def _traceback_site(tb) -> str:
    site = "outside repro_torch"
    while tb is not None:
        s = _site_of(tb.tb_frame.f_code.co_filename, tb.tb_lineno, tb.tb_frame.f_code.co_name)
        if s is not None:
            site = s
        tb = tb.tb_next
    return site


def _tensors(out: Any):
    if isinstance(out, torch.Tensor):
        yield out
    elif isinstance(out, (tuple, list)):
        for o in out:
            yield from _tensors(o)


@dataclasses.dataclass
class SweepRecord:
    """What one monitored sweep did."""

    host_reads: Dict[str, int] = dataclasses.field(default_factory=dict)  # "op @ site" -> n
    syncs: Dict[str, int] = dataclasses.field(default_factory=dict)  # site -> n (the card)
    low_outside: Dict[str, int] = dataclasses.field(default_factory=dict)  # "dtype op @ site"
    low_inside: int = 0  # bf16/f16 tensors made inside the engine's kernel calls
    unfolding_dtypes: List[torch.dtype] = dataclasses.field(default_factory=list)
    core_dtypes: List[torch.dtype] = dataclasses.field(default_factory=list)
    factor_dtypes: List[torch.dtype] = dataclasses.field(default_factory=list)
    collectives: List[Tuple[str, int]] = dataclasses.field(default_factory=list)


class _Monitor(TorchFunctionMode):
    """Records host reads and low-precision tensors of every torch call."""

    def __init__(self, rec: SweepRecord, state: "_LintState") -> None:
        super().__init__()
        self.rec, self.state = rec, state

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if not self.state.watches():  # another thread's op: not this sweep's
            return func(*args, **kwargs)
        name = HOST_READS.get(func)
        if name is not None:
            key = f"{name} @ {_caller_site()}"
            self.rec.host_reads[key] = self.rec.host_reads.get(key, 0) + 1
        if self.state.sync_mode is None:
            out = func(*args, **kwargs)
        else:  # a sync warning raised by this op belongs to its caller's line
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                out = func(*args, **kwargs)
            for w in caught:
                if SYNC_MESSAGE in str(w.message):
                    site = _caller_site()
                    self.rec.syncs[site] = self.rec.syncs.get(site, 0) + 1
                else:  # not ours: pass it on
                    warnings.warn_explicit(w.message, w.category, w.filename, w.lineno)
        for t in _tensors(out):
            if t.dtype in LOW_PRECISION:
                if self.state.in_kernel:
                    self.rec.low_inside += 1
                else:
                    op = getattr(func, "__name__", str(func))
                    key = f"{t.dtype} from {op} @ {_caller_site()}"
                    self.rec.low_outside[key] = self.rec.low_outside.get(key, 0) + 1
        return out


class _EngineProbe:
    """The sweep's engine, with its kernel calls marked and their outputs'
    dtypes recorded: ``mode_unfolding`` (Y_(n)), ``core_update`` and
    ``core_unfolding`` (G)."""

    def __init__(self, engine: Any, state: "_LintState") -> None:
        self._engine, self._state = engine, state

    def __getattr__(self, name: str) -> Any:
        return getattr(self._engine, name)

    def _call(self, kind: str, fn: Callable, *args) -> torch.Tensor:
        self._state.in_kernel += 1
        try:
            out = fn(*args)
        finally:
            self._state.in_kernel -= 1
        rec = self._state.rec
        (rec.unfolding_dtypes if kind == "y" else rec.core_dtypes).append(out.dtype)
        return out

    def mode_unfolding(self, coo, factors, mode):
        return self._call("y", self._engine.mode_unfolding, coo, factors, mode)

    def core_update(self, coo, factors, y_n):
        return self._call("g", self._engine.core_update, coo, factors, y_n)

    def core_unfolding(self, y_n, u_last):
        return self._call("g", self._engine.core_unfolding, y_n, u_last)


class _LintState:
    """The watch of one :func:`watch_sweeps` call. Only the thread that
    made it is watched, and the sweep in progress (``rec``) and the kernel
    depth (``in_kernel``) are kept per thread: no other thread reads or
    clears them."""

    def __init__(self, device: torch.device, sync_mode: Optional[str]) -> None:
        self.device, self.sync_mode = device, sync_mode
        self.records: List[SweepRecord] = []
        self.thread = threading.get_ident()
        self._local = threading.local()

    def watches(self) -> bool:
        return threading.get_ident() == self.thread

    @property
    def rec(self) -> Optional[SweepRecord]:
        return getattr(self._local, "rec", None)

    @rec.setter
    def rec(self, rec: Optional[SweepRecord]) -> None:
        self._local.rec = rec

    @property
    def in_kernel(self) -> int:
        return getattr(self._local, "in_kernel", 0)

    @in_kernel.setter
    def in_kernel(self, n: int) -> None:
        self._local.in_kernel = n

    @contextlib.contextmanager
    def sweep(self):
        rec = self.rec = SweepRecord()
        self.records.append(rec)
        prev = None
        if self.sync_mode is not None:
            prev = torch.cuda.get_sync_debug_mode()
            torch.cuda.set_sync_debug_mode(self.sync_mode)
        try:
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                with _Monitor(rec, self):
                    yield rec
            for w in caught:
                if SYNC_MESSAGE in str(w.message):
                    site = _site_of(w.filename, w.lineno) or f"{w.filename}:{w.lineno}"
                    rec.syncs[site] = rec.syncs.get(site, 0) + 1
                else:  # not ours: pass it on
                    warnings.warn_explicit(w.message, w.category, w.filename, w.lineno)
        finally:
            if self.sync_mode is not None:
                torch.cuda.set_sync_debug_mode(prev)
            self.rec = None


@contextlib.contextmanager
def _hooked(state: _LintState):
    """``core.hooi``'s two sweep functions run under ``state``'s watch on
    the watching thread (unwatched on any other), and every
    ``torch.distributed`` collective called from the watched sweep is
    counted with its bytes."""
    from repro_torch.core import hooi as _hooi

    orig_sweep, orig_batched = _hooi.sparse_sweep, _hooi.batched_sweep

    def sparse_sweep(coo, factors, ranks, method, engine):
        if not state.watches():
            return orig_sweep(coo, factors, ranks, method, engine)
        with state.sweep() as rec:
            fs, g = orig_sweep(coo, factors, ranks, method, _EngineProbe(engine, state))
        rec.factor_dtypes.extend(f.dtype for f in fs)
        return fs, g

    def batched_sweep(stacked, fs, active, ranks, method, engine, *, shape):
        if not state.watches():
            return orig_batched(stacked, fs, active, ranks, method, engine, shape=shape)
        with state.sweep() as rec:
            fs, g = orig_batched(stacked, fs, active, ranks, method,
                                 _EngineProbe(engine, state), shape=shape)
        rec.factor_dtypes.extend(f.dtype for f in fs)
        return fs, g

    def counting(name, fn):
        def call(*args, **kwargs):
            rec = state.rec if state.watches() else None
            if rec is not None:
                nbytes = sum(t.numel() * t.element_size()
                             for t in _tensors(args[0] if args else kwargs.get("tensor")))
                rec.collectives.append((name, int(nbytes)))
            return fn(*args, **kwargs)
        return call

    orig_coll = {n: getattr(dist, n) for n in COLLECTIVES if hasattr(dist, n)}
    _hooi.sparse_sweep, _hooi.batched_sweep = sparse_sweep, batched_sweep
    for n, fn in orig_coll.items():
        setattr(dist, n, counting(n, fn))
    try:
        yield
    finally:
        _hooi.sparse_sweep, _hooi.batched_sweep = orig_sweep, orig_batched
        for n, fn in orig_coll.items():
            setattr(dist, n, fn)


_WATCH_LOCK = threading.Lock()
_WATCHING: Optional[int] = None  # the thread inside watch_sweeps


def watch_sweeps(run: Callable[[], Any], device, *,
                 sync_mode: Optional[str] = None) -> Tuple[List[SweepRecord], Any]:
    """Run ``run()`` with every sweep it makes on this thread watched;
    returns the sweeps' records and ``run()``'s result. ``sync_mode`` (the
    card only) is the CUDA sync debug mode each sweep runs under. One call
    at a time in the process: another thread's call waits, a nested call
    raises."""
    global _WATCHING
    if _WATCHING == threading.get_ident():
        raise RuntimeError("watch_sweeps() is already watching this thread: a lint "
                           "cannot run inside another")
    with _WATCH_LOCK:
        _WATCHING = threading.get_ident()
        try:
            state = _LintState(torch.device(device), sync_mode)
            with _hooked(state):
                out = run()
        finally:
            _WATCHING = None
    return state.records, out


def _refuse_beside_a_live_service() -> None:
    from repro_torch.serve.tucker_service import live_services

    n = live_services("cuda")
    if n:
        raise RuntimeError(
            f"{n} TuckerService(s) on the card live in this process: the lint's CUDA sync "
            "debug mode is process-wide and would make their flushes raise; close them, "
            "or lint in another process")


def _merge(records: Sequence[SweepRecord], field: str) -> Dict[str, int]:
    total: Dict[str, int] = {}
    for r in records:
        for k, v in getattr(r, field).items():
            total[k] = total.get(k, 0) + v
    return total


def transfer_lint(records: Sequence[SweepRecord], *, where: str = "sweep",
                  strict_error: Optional[str] = None) -> List[Finding]:
    """No host sync inside a sweep: the function mode's host reads, the
    card's sync sites, and ``strict_error`` (the site at which the card's
    ``"error"`` mode raised, when it did)."""
    findings: List[Finding] = []
    n = len(records)
    for key, count in sorted(_merge(records, "host_reads").items()):
        findings.append(Finding(
            "transfer", "error", where,
            f"host read {key} inside the sweep ({count} call(s) over {n} sweep(s)) — it "
            "waits for the device; the one read allowed (the tol flag) lies between "
            "sweeps"))
    syncs = _merge(records, "syncs")
    for site, count in sorted(syncs.items()):
        findings.append(Finding(
            "transfer", "error", where,
            f"host sync at {site} inside the sweep ({count} over {n} sweep(s); "
            "torch.cuda sync debug mode)"))
    if strict_error is not None and not any(s in strict_error for s in syncs):
        findings.append(Finding(
            "transfer", "error", where,
            f"host sync at {strict_error} inside the sweep (sync debug mode 'error' raised)"))
    return findings


def precision_lint(records: Sequence[SweepRecord], *, precision: str,
                   working_dtype: torch.dtype, where: str = "sweep") -> List[Finding]:
    """Under ``fp32`` no bf16 / f16 tensor at all; under ``bf16_fp32acc``
    only inside the engine's kernel calls; under both, Y_(n), G and the
    factors in the working dtype."""
    findings: List[Finding] = []
    outside = _merge(records, "low_outside")
    inside = sum(r.low_inside for r in records)
    if precision == "fp32":
        for key, count in sorted(outside.items()):
            findings.append(Finding(
                "precision", "error", where,
                f"{key} ({count}x) in an fp32 sweep — fp32 programs hold no bf16"))
        if inside:
            findings.append(Finding(
                "precision", "error", where,
                f"{inside} bf16/f16 tensor(s) made inside the engine's kernel calls of an "
                "fp32 sweep — fp32 programs hold no bf16"))
    else:
        for key, count in sorted(outside.items()):
            findings.append(Finding(
                "precision", "error", where,
                f"{key} ({count}x) outside the kernel calls — under bf16_fp32acc bf16 is "
                "only a kernel operand"))
    for what, field in (("Y_(n)", "unfolding_dtypes"), ("G", "core_dtypes"),
                        ("a factor", "factor_dtypes")):
        bad = sorted({str(d) for r in records for d in getattr(r, field)
                      if d != working_dtype})
        if bad:
            findings.append(Finding(
                "precision", "error", where,
                f"{what} came out as {', '.join(bad)}, not the working {working_dtype} — "
                "accumulators and outputs stay in the working dtype"))
    return findings


def collective_lint(records: Sequence[SweepRecord], *, sharded: bool, shape: Sequence[int],
                    ranks: Sequence[int], working_dtype: torch.dtype,
                    where: str = "sweep") -> List[Finding]:
    """A sharded sweep: N all-reduces and their bytes equal to
    ``psum_bytes_per_sweep``, no other collective; unsharded: none."""
    from repro_torch.core.distributed import psum_bytes_per_sweep

    findings: List[Finding] = []
    want_n = len(shape) if sharded else 0
    want_bytes = psum_bytes_per_sweep(shape, ranks, dtype=working_dtype) if sharded else 0
    for i, r in enumerate(records):
        red = [b for name, b in r.collectives if name == "all_reduce"]
        other = sorted({name for name, _ in r.collectives if name != "all_reduce"})
        if len(red) != want_n or sum(red) != want_bytes:
            findings.append(Finding(
                "collective", "error", where,
                f"sweep {i}: {len(red)} all-reduce(s) of {sum(red)} bytes, want {want_n} of "
                f"{want_bytes} (psum_bytes_per_sweep)" if sharded else
                f"sweep {i}: {len(red)} all-reduce(s) in an unsharded sweep — it makes no "
                "collective"))
        if other:
            findings.append(Finding(
                "collective", "error", where,
                f"sweep {i}: collective(s) {other} inside the sweep — a sweep makes only "
                "its per-mode all-reduces"))
    return findings


def sweep_lint(run: Callable[[], Any], *, device, precision: str,
               working_dtype: torch.dtype, shape: Sequence[int], ranks: Sequence[int],
               sharded: bool, where: str = "sweep") -> List[Finding]:
    """Run ``run()`` (a warm plan call) with its sweeps watched and return
    the transfer, precision and collective findings. On the card each sweep
    runs under sync debug mode ``"error"``; if one raises, ``run()`` goes
    again under ``"warn"`` to list every sync site. A run that made no
    sweep is a finding too: nothing was checked. On the card it raises
    while a ``TuckerService`` on the card is live in the process: the sync
    mode is process-wide."""
    dev = torch.device(device)
    strict_error = None
    if dev.type == "cuda":
        _refuse_beside_a_live_service()
        try:
            records, _ = watch_sweeps(run, dev, sync_mode="error")
        except RuntimeError as e:
            if SYNC_MESSAGE not in str(e):
                raise
            strict_error = _traceback_site(e.__traceback__)
            records, _ = watch_sweeps(run, dev, sync_mode="warn")
    else:
        records, _ = watch_sweeps(run, dev)
    findings: List[Finding] = []
    if not records:
        findings.append(Finding("transfer", "error", where,
                                "the run made no sweep: no contract was checked"))
    findings += transfer_lint(records, where=where, strict_error=strict_error)
    findings += precision_lint(records, precision=precision, working_dtype=working_dtype,
                               where=where)
    findings += collective_lint(records, sharded=sharded, shape=shape, ranks=ranks,
                                working_dtype=working_dtype, where=where)
    return findings
