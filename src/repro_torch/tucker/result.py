"""TuckerResult — the result type of the plan/execute API, and the
serving plane's per-request timing.

Port of ``repro.tucker.result`` (the fields of the single-device paths).
"""
from __future__ import annotations

import dataclasses
from typing import TYPE_CHECKING, List, Optional

import numpy as np
import torch

if TYPE_CHECKING:
    from repro_torch.tucker.spec import TuckerSpec


@dataclasses.dataclass(frozen=True)
class RequestTiming:
    """Where one served request's wall-clock went (attached to
    :class:`TuckerResult` by ``repro_torch.serve.TuckerService``; ``None`` on
    direct plan/decompose calls).

    ``execute_ms`` is the wall-clock of the whole batched dispatch the
    request rode in, shared by all ``batch_size`` members: the per-request
    amortized cost is ``execute_ms / batch_size``.

    Attributes:
      queue_ms: submit -> dequeue (micro-batching wait).
      execute_ms: dequeue -> results ready (the batched dispatch).
      total_ms: submit -> results ready.
      batch_size: number of requests in the flush that served this one.
      nnz: this request's real stored nonzeros.
      nnz_padded: the nonzero slots this request streamed. The port's
        batched sweeps stack the members and pad nothing, so this is
        ``nnz``.
      flush_reason: why the batch flushed: 'full', 'timeout' or 'drain'.
    """

    queue_ms: float
    execute_ms: float
    total_ms: float
    batch_size: int
    nnz: int
    nnz_padded: int
    flush_reason: str

    @property
    def padding_fraction(self) -> float:
        """Fraction of this request's streamed nnz slots that were padding."""
        return 1.0 - self.nnz / max(1, self.nnz_padded)


@dataclasses.dataclass
class TuckerResult:
    """A finished decomposition.

    Attributes:
      core: (R_1, ..., R_N) core tensor, on the plan's device.
      factors: U_n (I_n, R_n) with orthonormal columns, on the plan's device.
      rel_error: ||X - Xhat||_F / ||X||_F after the last sweep (NaN when no
        sweep ran).
      fit_history: per-sweep relative error (host numpy, the sweeps that ran).
      engine: the engine that ran: 'cuda' (the CUDA kernels) or 'torch'
        (their plain versions, on the CPU; and the dense and completion
        algorithms, torch products on either device).
      spec: the :class:`~repro_torch.tucker.spec.TuckerSpec` this run executed.
      compression_ratio: dense storage / Tucker storage, factors included.
      dispatches: top-level dispatches this call made, as the reference
        counts them: 1 for one multi-sweep ``run_sweeps`` call, one a sweep
        on the per-sweep pipeline, 0 on the dense and completion paths; a
        batched dispatch counts 1 on its first member's result and 0 on the
        others.
      launches: CUDA kernel launches of the port's kernels this call made
        (0 on the CPU), counted on the calling thread, so other threads'
        launches never leak in. A batch counts its whole program on its
        first result and 0 on the others, as ``dispatches`` does.
      schedule_builds: schedule constructions this call triggered (0 when
        the engine's caches were warm for this tensor).
      precision: the precision the sweeps ran at, the engine's ('fp32' or
        'bf16_fp32acc'; a prebuilt engine may differ from ``spec.precision``).
      timing: per-request queue/batch/execute wall-clock when the result was
        produced by ``repro_torch.serve.TuckerService`` (``None`` otherwise).
      snapshots_written: snapshots this call wrote (snapshot specs only; the
        step-0 snapshot of a fresh job included).
      resumed_from_sweep: the sweep count the job restarted from when this
        call resumed a snapshot; ``None`` on a fresh run.
      retries: segments that failed with a transient error and were run
        again by ``run_with_retries`` during this call.
      tuned_blocks: the autotuned launch parameters
        (:class:`repro_torch.kernels.autotune.BlockConfig`) the plan applied
        before this call, or ``None`` when no autotuning ran.
      trace_summary: per-stage milliseconds of this call, span name -> total
        ms over the call's span subtree (``repro_torch.obs``); ``None``
        unless tracing was on when the call ran. A batch attaches the whole
        batch's summary to every member's result.
    """

    core: torch.Tensor
    factors: List[torch.Tensor]
    rel_error: float
    fit_history: np.ndarray
    engine: str
    spec: Optional["TuckerSpec"] = None
    compression_ratio: Optional[float] = None
    dispatches: int = 0
    launches: int = 0
    schedule_builds: int = 0
    precision: str = "fp32"
    timing: Optional[RequestTiming] = None
    snapshots_written: int = 0
    resumed_from_sweep: Optional[int] = None
    retries: int = 0
    tuned_blocks: Optional[tuple] = None
    trace_summary: Optional[dict] = None

    @classmethod
    def from_history(cls, core, factors, hist, engine: str, **extra) -> "TuckerResult":
        """Build a result from a (possibly empty) fit history."""
        hist = np.asarray(hist).reshape(-1)
        rel = float(hist[-1]) if hist.size else float("nan")
        return cls(core, list(factors), rel, hist, engine, **extra)

    @property
    def n_sweeps(self) -> int:
        """ALS sweeps that actually ran (after any ``tol`` early exit)."""
        return int(np.asarray(self.fit_history).size)
