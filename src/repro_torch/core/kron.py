"""Kronecker-product accumulation — the paper's module 2 (Section III-C).

Alg. 2 line 5 / Eq. (13): for every nonzero x at (i_1..i_N),

    Y_(n)(i_n, :) += x * [ kron_{t != n} U_t(i_t, :) ]

over the nonzeros only. Port of ``repro.core.kron``. :func:`sparse_ttm_chain`
is the plain twin of the unfolding the CUDA kernel computes: original
nonzero order, one ``index_add_``. The paper's reuse trick (Sec. III-C, "a
Kronecker product can be re-used for all non-zero elements that share the
same indices"): :func:`sparse_ttm_chain_reuse` computes each distinct
Kronecker row once (:func:`precompute_kron_reuse`), gathers it for every
nonzero and scatter-adds, the same result.

Column ordering: the Kronecker product runs over the non-mode factors in
*descending* mode order, so the first non-mode dimension varies fastest —
the Kolda ordering of :func:`repro_torch.core.coo.unfold_dense`.
"""
from __future__ import annotations

from typing import List, Sequence

import numpy as np
import torch

from repro_torch.core.coo import SparseCOO
from repro_torch.sparse.layout import KronReusePlan, build_kron_reuse


def kron_rows(rows: Sequence[torch.Tensor]) -> torch.Tensor:
    """Row-wise Kronecker product of ``(nnz, R_t)`` matrices; the *last*
    operand varies fastest (paper Alg. 4: ``c[R_b*i + j] = a[i] * b[j]``)."""
    out = rows[0]
    for r in rows[1:]:
        out = (out[:, :, None] * r[:, None, :]).reshape(out.shape[0], -1)
    return out


def gathered_factor_rows(
    coo: SparseCOO, factors: Sequence[torch.Tensor], skip_mode: int
) -> List[torch.Tensor]:
    """``U_t(i_t, :)`` for every nonzero, for t != skip_mode, in descending
    mode order."""
    return [
        factors[t].index_select(0, coo.indices[:, t])
        for t in range(coo.ndim - 1, -1, -1)
        if t != skip_mode
    ]


def zero_unfolding(shape: Sequence[int], factors: Sequence[torch.Tensor],
                   skip_mode: int) -> torch.Tensor:
    """The Y_(n) of a tensor with no nonzeros: exactly zero, f32."""
    k_cols = int(np.prod([f.shape[1] for t, f in enumerate(factors) if t != skip_mode]))
    return torch.zeros((shape[skip_mode], k_cols), dtype=torch.float32,
                       device=factors[0].device)


def sparse_ttm_chain(
    coo: SparseCOO,
    factors: Sequence[torch.Tensor],
    skip_mode: int,
    precision: str = "fp32",
) -> torch.Tensor:
    """Sparse power-iteration TTM chain (Alg. 2 lines 4-5): the mode-
    ``skip_mode`` unfolding of X contracted with every other U_t^T, touching
    only the nonzeros. Returns Y_(n), (I_n, prod_{t != n} R_t), f32 or
    wider.

    ``precision="bf16_fp32acc"`` forms the Kronecker rows in bfloat16 and
    scales and sums them in f32, like the kernels' mixed mode.
    """
    if coo.nnz == 0:
        return zero_unfolding(coo.shape, factors, skip_mode)
    rows = gathered_factor_rows(coo, factors, skip_mode)
    if precision == "bf16_fp32acc":
        k = kron_rows([r.to(torch.bfloat16) for r in rows])
        dt = torch.promote_types(coo.values.dtype, torch.float32)
    else:
        k = kron_rows(rows)
        dt = torch.promote_types(
            torch.promote_types(coo.values.dtype, k.dtype), torch.float32
        )
    contrib = k.to(dt) * coo.values.to(dt)[:, None]
    out = torch.zeros((coo.shape[skip_mode], k.shape[1]), dtype=dt,
                      device=coo.device)
    return out.index_add_(0, coo.indices[:, skip_mode], contrib)


def precompute_kron_reuse(coo: SparseCOO, skip_mode: int) -> KronReusePlan:
    """The dedup of the non-mode coordinate tuples, so that each distinct
    Kronecker row is computed once (Sec. III-C): an alias of
    :func:`repro_torch.sparse.layout.build_kron_reuse`, as in the
    reference."""
    return build_kron_reuse(coo, skip_mode)


def _reuse_chain(
    indices: torch.Tensor,
    values: torch.Tensor,
    factors: Sequence[torch.Tensor],
    skip_mode: int,
    unique_indices: torch.Tensor,
    inverse: torch.Tensor,
    modes: Sequence[int],
    shape: Sequence[int],
) -> torch.Tensor:
    """The reuse chain both entry points share: each unique Kronecker row
    once, gathered for every nonzero, scaled and ``index_add_``-ed into
    Y_(n), in the dtype the reference promotes to (values and factors, at
    least f32)."""
    if indices.shape[0] == 0:
        return zero_unfolding(tuple(shape), factors, skip_mode)
    rows = [factors[t].index_select(0, unique_indices[:, c]) for c, t in enumerate(modes)]
    k = kron_rows(rows).index_select(0, inverse)  # (n_unique, K), then (nnz, K)
    dt = torch.promote_types(torch.promote_types(values.dtype, k.dtype), torch.float32)
    contrib = k.to(dt) * values.to(dt)[:, None]
    out = torch.zeros((shape[skip_mode], k.shape[1]), dtype=dt, device=values.device)
    return out.index_add_(0, indices[:, skip_mode], contrib)


def sparse_ttm_chain_reuse(
    coo: SparseCOO,
    factors: Sequence[torch.Tensor],
    skip_mode: int,
    plan: KronReusePlan,
) -> torch.Tensor:
    """:func:`sparse_ttm_chain` with each unique Kronecker row computed
    once (``plan``, :func:`precompute_kron_reuse`) and gathered for every
    nonzero: the same result, fewer multiplies where nonzeros share their
    non-mode coordinates."""
    return _reuse_chain(coo.indices, coo.values, factors, skip_mode, plan.unique_indices,
                        plan.inverse, plan.modes, coo.shape)


def sparse_ttm_chain_reuse_device(
    indices: torch.Tensor,
    values: torch.Tensor,
    factors: Sequence[torch.Tensor],
    skip_mode: int,
    sched,
    *,
    shape: Sequence[int],
) -> torch.Tensor:
    """:func:`sparse_ttm_chain_reuse` with the dedup already on the sweep's
    device (``sched.kron_unique`` / ``kron_inverse`` / ``kron_modes`` of a
    :class:`~repro_torch.sparse.layout.DeviceSchedule` from
    ``DeviceSchedule.from_kron_plan``), as the sweep loop calls it."""
    return _reuse_chain(indices, values, factors, skip_mode, sched.kron_unique,
                        sched.kron_inverse, sched.kron_modes, shape)


def kron_flops(coo: SparseCOO, ranks: Sequence[int], skip_mode: int) -> int:
    """Multiplies of the sparse chain, nnz x (Kron row build + scale): the
    paper's O(nnz prod R)."""
    ks = [r for t, r in enumerate(ranks) if t != skip_mode]
    build, acc = 0, ks[0]
    for r in ks[1:]:
        acc *= r
        build += acc
    return coo.nnz * (build + 2 * int(np.prod(ks)))
