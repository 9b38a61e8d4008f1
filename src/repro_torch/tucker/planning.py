"""The plan/execute front-end: ``plan(spec) -> TuckerPlan``.

Port of ``repro.tucker.planning`` for one device: the sparse path (paper
Alg. 2) on the multi-sweep ``scan`` pipeline or the per-sweep ``python``
one, dense HOOI (Alg. 1) and EM completion over it. A plan is bound to one
device, ``"cuda"`` unless the caller asks for the CPU; without a CUDA
device the default raises instead of running on the CPU. A sparse plan
owns its sweep engine, whose schedules are built once per tensor: hand the
plan a tensor already on its device (``coo.to(device)``) to reuse them
across calls. The dense and completion paths run torch products (the
reference leaves them to XLA): no kernel of the port's and no schedule.
"""
from __future__ import annotations

import threading
from collections import OrderedDict
from typing import Any, List, Optional, Sequence

import numpy as np
import torch

from repro_torch.base import resolve_device, unported
from repro_torch.core import hooi as _hooi
from repro_torch.core.coo import SparseCOO, fold_dense, unfold_dense
from repro_torch.core.engine import SweepEngine, make_engine
from repro_torch.core.qrp import factor_update
from repro_torch.core.reconstruct import compression_ratio, reconstruct_dense
from repro_torch.core.ttm import ttm_chain
from repro_torch.kernels import kron_kernel
from repro_torch.kernels.ttm_kernel import ttm
from repro_torch.tucker.result import TuckerResult
from repro_torch.tucker.spec import TuckerSpec, spec_for

__all__ = ["TuckerPlan", "clear_plan_cache", "decompose", "plan"]


def _kernel_launches() -> int:
    return (kron_kernel.fused_kron_scatter.launches + kron_kernel.kron_contrib.launches
            + kron_kernel.scatter_rows.launches + kron_kernel.fused_kron_scatter_ttm.launches
            + ttm.launches)


class TuckerPlan:
    """A reusable executable for one :class:`TuckerSpec` on one device.

    Calls on one plan serialize: the engine's schedule caches are bound to
    one tensor at a time. A prebuilt ``engine`` (``make_engine``) replaces
    the one the spec would build, with its own precision and core layout;
    it must run on the plan's device. Dense and completion plans have no
    engine.
    """

    def __init__(self, spec: TuckerSpec, device="cuda",
                 engine: Optional[SweepEngine] = None) -> None:
        self.spec = spec
        self.device = resolve_device(device)
        if self.device.type == "cuda" and spec.dtype == "float64":
            raise unported("float64 on the card", "queue 1, item 8: float64 on the card")
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
        self._lock = threading.Lock()

    def __repr__(self) -> str:  # pragma: no cover - cosmetic
        name = self.engine.name if self.engine is not None else "torch"
        return (f"TuckerPlan(shape={self.spec.shape}, ranks={self.spec.ranks}, "
                f"algorithm={self.spec.algorithm}, engine={name}, device={self.device})")

    def __call__(self, x: Any, generator: Optional[torch.Generator] = None,
                 factors_init: Any = None, device=None) -> TuckerResult:
        """Decompose ``x`` (moved to the plan's device if it is elsewhere): a
        ``SparseCOO`` for the sparse and completion algorithms, a dense array
        (numpy or torch) for the dense one.

        ``device`` defaults to the plan's device and must match it.
        ``factors_init`` (arrays, numpy or torch) warm-starts the sweeps (the
        first EM round of a completion); otherwise
        :func:`~repro_torch.core.hooi.init_factors` draws them from
        ``generator`` (a CPU generator seeded with 0 by default).
        """
        if device is not None and resolve_device(device) != self.device:
            raise ValueError(f"this plan runs on {self.device}, not {device}")
        with self._lock:
            if self.spec.algorithm == "dense":
                return self._run_dense(x, generator, factors_init)
            coo = self._check_sparse_input(x)
            if self.spec.algorithm == "complete":
                return self._run_complete(coo, generator, factors_init)
            factors = self._init_factors(generator, factors_init)
            xnorm2 = torch.square(coo.norm())
            if self.spec.pipeline == "scan":
                return self._run_sparse_scan(coo, factors, xnorm2)
            return self._run_sparse_python(coo, factors, xnorm2)

    def batch(self, *args, **kwargs):
        raise unported("TuckerPlan.batch", "queue 1, item 11: batched dispatch")

    def _check_sparse_input(self, coo: Any) -> SparseCOO:
        if not isinstance(coo, SparseCOO):
            raise TypeError(f"expected a repro_torch SparseCOO, got {type(coo).__name__}")
        if tuple(coo.shape) != self.spec.shape:
            raise ValueError(
                f"input shape {tuple(coo.shape)} does not match the planned "
                f"spec shape {self.spec.shape}"
            )
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
        return TuckerResult.from_history(
            core, factors, hist, engine=eng.name if eng is not None else "torch",
            spec=self.spec,
            compression_ratio=compression_ratio(self.spec.shape, self.spec.ranks),
            precision=eng.precision if eng is not None else "fp32", **counts,
        )

    def _run_sparse_scan(self, coo: SparseCOO, factors, xnorm2) -> TuckerResult:
        spec, eng = self.spec, self.engine
        builds0, launches0 = eng.schedule_builds, _kernel_launches()
        fs, core, hist = _hooi.run_sweeps(
            coo, factors, xnorm2, spec.tol, eng,
            ranks=spec.ranks, method=spec.method, n_iter=spec.n_iter,
        )
        n_done = int(np.sum(hist != _hooi._SKIPPED))
        return self._result(core, fs, hist[:n_done], dispatches=1,
                            launches=_kernel_launches() - launches0,
                            schedule_builds=eng.schedule_builds - builds0)

    def _run_sparse_python(self, coo: SparseCOO, factors, xnorm2) -> TuckerResult:
        """The per-sweep loop (the reference's benchmark baseline): the
        sweeps of the scan pipeline, with the fit read back after each one
        and the ``tol`` rule decided on the host."""
        spec, eng = self.spec, self.engine
        builds0, launches0 = eng.schedule_builds, _kernel_launches()
        core_dtype = torch.promote_types(coo.values.dtype, torch.float32)
        hist: List[float] = []
        core = None
        for _ in range(spec.n_iter):
            factors, g = _hooi.sparse_sweep(coo, factors, spec.ranks, spec.method, eng)
            core = g.to(core_dtype)
            err = _hooi.projection_error(xnorm2, core).to(torch.float32)
            hist.append(float(err))  # the host read, one a sweep
            if spec.tol and len(hist) > 1 and abs(hist[-2] - hist[-1]) < spec.tol:
                break
        return self._result(core, factors, np.asarray(hist), dispatches=len(hist),
                            launches=_kernel_launches() - launches0,
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


_PLAN_CACHE_CAPACITY = 8
_PLAN_CACHE: "OrderedDict[tuple, TuckerPlan]" = OrderedDict()
_PLAN_CACHE_LOCK = threading.Lock()


def plan(spec: TuckerSpec, *, device="cuda",
         engine: Optional[SweepEngine] = None) -> TuckerPlan:
    """The :class:`TuckerPlan` for ``spec`` on ``device`` (``"cuda"`` by
    default), from a small LRU cache keyed by (spec, device), so repeated
    calls share one engine and its schedules.

    Passing a prebuilt ``engine`` (``make_engine(..., fuse_core=True)``, say)
    bypasses the cache and wraps that engine directly; its device must be
    ``device``.
    """
    dev = resolve_device(device)
    if engine is not None:
        return TuckerPlan(spec, device=dev, engine=engine)
    key = (spec, str(dev))
    with _PLAN_CACHE_LOCK:
        p = _PLAN_CACHE.get(key)
        if p is None:
            p = _PLAN_CACHE[key] = TuckerPlan(spec, device=dev)
            while len(_PLAN_CACHE) > _PLAN_CACHE_CAPACITY:
                _PLAN_CACHE.popitem(last=False)
        _PLAN_CACHE.move_to_end(key)
        return p


def clear_plan_cache() -> None:
    """Drop every cached plan (and with them their schedules)."""
    with _PLAN_CACHE_LOCK:
        _PLAN_CACHE.clear()


def decompose(x: Any, ranks: Sequence[int], *, generator=None,
              factors_init: Any = None, device="cuda", **spec_kwargs) -> TuckerResult:
    """One-shot convenience: infer the spec from ``x`` (sparse for a
    ``SparseCOO``, dense for a numpy array or a tensor), plan (cached), run.

    ``spec_kwargs`` are :class:`TuckerSpec` fields (method, engine,
    pipeline, n_iter, tol, dtype, precision, algorithm, n_rounds).
    """
    spec = spec_for(x, ranks, **spec_kwargs)
    return plan(spec, device=device)(x, generator=generator, factors_init=factors_init)
