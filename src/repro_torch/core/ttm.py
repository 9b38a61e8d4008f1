"""Tensor-times-matrix (TTM) — Definition 4 / paper module 1 (Section III-B).

Port of ``repro.core.ttm``: the dense mathematical layer, used as the
oracle of the tests. The sweep's own core update runs on
``repro_torch.kernels.ttm_kernel``.
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch


def ttm(x: torch.Tensor, u: torch.Tensor, mode: int) -> torch.Tensor:
    """Dense mode-``mode`` product X x_mode U with U of shape (J, I_mode)."""
    if u.shape[1] != x.shape[mode]:
        raise ValueError(
            f"U {tuple(u.shape)} does not contract with mode {mode} of {tuple(x.shape)}"
        )
    out = torch.einsum("...i,ji->...j", torch.movedim(x, mode, -1), u)
    return torch.movedim(out, -1, mode)


def ttm_unfolded(y_mat: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """The paper's TTM on unfolded operands, ``G = Y @ U^T`` (Eq. 12)."""
    return torch.einsum("it,kt->ik", y_mat, u)


def ttm_chain(
    x: torch.Tensor,
    factors: Sequence[torch.Tensor],
    skip: Optional[int] = None,
    transpose: bool = True,
) -> torch.Tensor:
    """Dense chain X x_1 U_1^T ... x_N U_N^T (optionally skipping a mode);
    ``transpose=False`` applies the factors directly (reconstruction)."""
    out = x
    for n, u in enumerate(factors):
        if skip is not None and n == skip:
            continue
        out = ttm(out, u.T if transpose else u, n)
    return out
