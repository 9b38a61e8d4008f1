"""Reconstruction utilities for Tucker results (Eq. 7)."""
from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from repro_torch.core.kron import kron_rows
from repro_torch.core.ttm import ttm_chain


def reconstruct_dense(core: torch.Tensor, factors: Sequence[torch.Tensor]) -> torch.Tensor:
    """Xhat = G x_1 U_1 x_2 U_2 ... x_N U_N (Eq. 7)."""
    return ttm_chain(core, list(factors), transpose=False)


def reconstruct_at(core: torch.Tensor, factors: Sequence[torch.Tensor],
                   indices: torch.Tensor) -> torch.Tensor:
    """Xhat at the (nnz, N) coordinates ``indices`` only, O(nnz prod R)
    without densifying: xhat_i = <G, kron_t U_t(i_t, :)>."""
    n = core.dim()
    rows = [factors[t][indices[:, t].long()] for t in range(n - 1, -1, -1)]
    k = kron_rows(rows)  # (nnz, prod R), mode 1 fastest (Kolda order)
    # the core flattened in the same order: Fortran over ascending modes
    g_flat = core.permute(list(range(n - 1, -1, -1))).reshape(-1)
    return k @ g_flat


def relative_error_dense(x: torch.Tensor, core: torch.Tensor,
                         factors: Sequence[torch.Tensor]) -> torch.Tensor:
    """||X - Xhat||_F / ||X||_F with Xhat densified, in float32."""
    xhat = reconstruct_dense(core, factors)
    x32 = x.to(torch.float32)
    return torch.linalg.vector_norm(x32 - xhat) / torch.linalg.vector_norm(x32)


def relative_error_projection(xnorm2: torch.Tensor, core: torch.Tensor) -> torch.Tensor:
    """||X - Xhat|| / ||X|| through the orthonormal-projection identity."""
    return torch.sqrt(torch.clamp(xnorm2 - torch.sum(torch.square(core)), min=0.0) / xnorm2)


def compression_ratio(shape: Sequence[int], ranks: Sequence[int],
                      include_factors: bool = True) -> float:
    """Dense storage / Tucker storage; ``include_factors=False`` counts the
    core only (the paper's angiogram convention)."""
    dense = float(np.prod(shape))
    tucker = float(np.prod(ranks))
    if include_factors:
        tucker += float(sum(i * r for i, r in zip(shape, ranks)))
    return dense / tucker
