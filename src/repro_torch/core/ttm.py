"""Tensor-times-matrix (TTM) — Definition 4 / paper module 1 (Section III-B).

Port of ``repro.core.ttm``: the dense mathematical layer, used as the
oracle of the tests. The sweep's own core update runs on
``repro_torch.kernels.ttm_kernel``.
"""
from __future__ import annotations

import math
from typing import Optional, Sequence

import torch

from repro_torch.core.coo import fold_dense, unfold_dense


def ttm(x: torch.Tensor, u: torch.Tensor, mode: int) -> torch.Tensor:
    """Dense mode-``mode`` product X x_mode U with U of shape (J, I_mode).

    X is read in place as (A, I_mode, B), A and B the sizes of the modes
    before and after ``mode``: one product U @ X[a] per leading index (one
    matrix product for the first and the last mode), so a contiguous X is
    never copied (at 800^3 a copy would be 2 GB a mode)."""
    if u.shape[1] != x.shape[mode]:
        raise ValueError(
            f"U {tuple(u.shape)} does not contract with mode {mode} of {tuple(x.shape)}"
        )
    shape = tuple(x.shape)
    a, b = math.prod(shape[:mode]), math.prod(shape[mode + 1:])
    if b == 1:
        out = x.reshape(a, shape[mode]) @ u.T
    else:
        out = torch.matmul(u, x.reshape(a, shape[mode], b))
    return out.reshape(shape[:mode] + (u.shape[0],) + shape[mode + 1:])


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


def mode_unfold_matmul(x: torch.Tensor, u: torch.Tensor, mode: int) -> torch.Tensor:
    """Eq. 5 written out: fold(U @ unfold(X, n)), the reference for :func:`ttm`."""
    new_shape = list(x.shape)
    new_shape[mode] = u.shape[0]
    return fold_dense(u @ unfold_dense(x, mode), mode, new_shape)
