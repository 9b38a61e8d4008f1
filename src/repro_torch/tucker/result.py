"""TuckerResult — the result type of the plan/execute API.

Port of ``repro.tucker.result.TuckerResult`` (the fields of the
single-device paths).
"""
from __future__ import annotations

import dataclasses
from typing import TYPE_CHECKING, List, Optional

import numpy as np
import torch

if TYPE_CHECKING:
    from repro_torch.tucker.spec import TuckerSpec


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
        on the per-sweep pipeline, 0 on the dense and completion paths.
      launches: CUDA kernel launches of the port's kernels this call made
        (0 on the CPU).
      schedule_builds: schedule constructions this call triggered (0 when
        the engine's caches were warm for this tensor).
      precision: the precision the sweeps ran at, the engine's ('fp32' or
        'bf16_fp32acc'; a prebuilt engine may differ from ``spec.precision``).
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
