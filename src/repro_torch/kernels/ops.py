"""Host-side wrappers around the port's kernels.

Port of ``repro.kernels.ops``: on the sparse HOOI path the schedule-order
gather of factor rows, the mode unfolding of a tensor of any order and the
fused core update; on the LM path ``flash_attention`` and ``ssd_chunk``, each
differentiable through its backward kernel (``flash_attention_bwd``,
``ssd_chunk_bwd``) when grad is on.
Which device runs what is decided by the kernel wrappers alone, from the
device of the tensors.
"""
from __future__ import annotations

from typing import Sequence

import torch

from repro_torch.core.coo import SparseCOO
from repro_torch.core.kron import zero_unfolding
from repro_torch.kernels import kron_kernel
from repro_torch.kernels.flash_attention import flash_attention, flash_attention_bwd
from repro_torch.kernels.kron_kernel import ScatterPlan, build_scatter_plan
from repro_torch.kernels.ssd_scan import ssd_chunk, ssd_chunk_bwd
from repro_torch.kernels.ttm_kernel import ttm
from repro_torch.sparse.layout import DeviceSchedule, SortedCOO, operand_modes

__all__ = ["ttm", "kron_contrib", "sparse_ttm_chain_kernel", "sparse_ttm_chain_device",
           "sparse_ttm_core_device", "flash_attention", "ssd_chunk", "flash_attention_bwd",
           "ssd_chunk_bwd"]


def kron_contrib(a: torch.Tensor, b: torch.Tensor, v: torch.Tensor, *,
                 precision: str = "fp32") -> torch.Tensor:
    """Paper Kronecker module (Alg. 4) over a batch of nonzeros."""
    return kron_kernel.kron_contrib(a, b, v, precision=precision)


def sparse_ttm_chain_kernel(
    coo: SparseCOO,
    factors: Sequence[torch.Tensor],
    skip_mode: int,
    plan=None,
    *,
    fused: bool = True,
) -> torch.Tensor:
    """Alg. 2 line 5 on the kernels, for one COO: Y_(skip_mode), f32 (f64
    for f64 factors at ``fp32``).

    The routes are those of :func:`sparse_ttm_chain_device`: kernel 1 for
    2- and 3-way tensors, the fused chain kernel for orders 4 to 6, and with
    ``fused=False`` (or above order 6) ``kron_contrib`` chained and summed
    with ``scatter_rows``.
    ``plan`` is the mode's schedule: a :class:`ScatterPlan`, a
    :class:`SortedCOO` or a :class:`DeviceSchedule`, built once per (tensor,
    mode) and reused across sweeps; a missing one is built here. The
    kernels run on the tensor's device, their plain versions on the CPU.
    """
    if plan is None:
        plan = build_scatter_plan(coo.indices[:, skip_mode], coo.shape[skip_mode])
    if isinstance(plan, (ScatterPlan, SortedCOO)):
        plan = DeviceSchedule.from_layout(plan, coo, coo.device, mode=skip_mode)
    return sparse_ttm_chain_device(coo.indices, coo.values, factors, skip_mode, plan,
                                   shape=tuple(coo.shape), fused=fused)


def _gathered_block_rows(indices, values, factors, skip_mode, sched, n):
    """The non-mode factor rows of every schedule slot, in descending mode
    order (padding slots gather row 0 with value 0), from the schedule's
    cached slot coordinates (``sched.idx``, which are ``indices[order]``)
    and values. Only the unfused (``fused=False``) unfoldings and those
    above the chain kernel's order read these (nnz_padded, R) operands; the
    fused unfoldings and core update gather the rows inside their kernels."""
    _gathered_block_rows.calls += 1
    modes = operand_modes(n, skip_mode)
    rows = [factors[t].index_select(0, sched.idx[:, c]) for c, t in enumerate(modes)]
    if len(rows) == 1:  # order-2 tensor: the "Kron row" is a single factor row
        rows.append(torch.ones((rows[0].shape[0], 1), dtype=rows[0].dtype,
                               device=rows[0].device))
    return rows, sched.vals


_gathered_block_rows.calls = 0  # gathers of (nnz_padded, R) operand rows since the last reset


def sparse_ttm_chain_device(
    indices: torch.Tensor,
    values: torch.Tensor,
    factors: Sequence[torch.Tensor],
    skip_mode: int,
    sched,
    *,
    shape: Sequence[int],
    fused: bool = True,
    precision: str = "fp32",
) -> torch.Tensor:
    """Y_(skip_mode) on the device schedule ``sched`` of that mode.

    Routes, chosen by order alone unless ``fused=False``:

    * 2- and 3-way tensors (the paper's case): the fused Kron-scatter kernel
      (kernel 1), which reads the factor rows through the schedule's cached
      slot coordinates;
    * orders 4 to ``MAX_CHAIN_OPERANDS + 1`` (6): the fused chain kernel
      (``fused_kron_chain_scatter``), which does the same with every
      non-mode factor and splits long rows over warps;
    * ``fused=False``, at any order, and orders above 6 (the chain kernel's
      compiled-in cap): the reference's unfused chain, ``kron_contrib`` link
      by link (``precision`` applies to the first link only, as in the
      reference) on gathered (nnz, R) rows, then ``scatter_rows``.
    """
    n = len(shape)
    n_rows = int(shape[skip_mode])
    if indices.shape[0] == 0:
        return zero_unfolding(tuple(shape), factors, skip_mode)
    if n <= 3 and fused:  # the kernel reads the factor rows through the schedule
        modes = operand_modes(n, skip_mode)
        return kron_kernel.fused_kron_scatter(
            factors[modes[0]], factors[modes[1]] if n == 3 else None, sched, n_rows,
            precision=precision,
        )
    if fused and n - 1 <= kron_kernel.MAX_CHAIN_OPERANDS:
        return kron_kernel.fused_kron_chain_scatter(
            [factors[t] for t in operand_modes(n, skip_mode)], sched, n_rows,
            precision=precision)
    rows, vals = _gathered_block_rows(indices, values, factors, skip_mode, sched, n)
    contrib = kron_contrib(rows[0], rows[1], vals, precision=precision)
    for extra in rows[2:]:  # later links in the first link's result dtype
        contrib = kron_contrib(contrib, extra.to(contrib.dtype),
                               torch.ones_like(vals, dtype=contrib.dtype))
    return kron_kernel.scatter_rows(contrib, sched, n_rows)


def sparse_ttm_core_device(
    indices: torch.Tensor,
    values: torch.Tensor,
    factors: Sequence[torch.Tensor],
    skip_mode: int,
    sched,
    *,
    shape: Sequence[int],
    precision: str = "fp32",
) -> torch.Tensor:
    """Fused core update (Eq. 12): G_(n) = U_n^T Y_(n), (R_n, prod_{t != n}
    R_t) in ``kron_kernel.result_dtype`` (f32, f64 for f64 factors at
    ``fp32``), without materialising Y_(n) for 2- and 3-way tensors: the
    megakernel re-streams the nonzeros, reads their factor rows through the
    schedule and contracts each finished row. Higher orders take the split
    path, the unfolding (the fused chain kernel up to order 6) and then the
    TTM kernel, as the reference does."""
    u = factors[skip_mode]
    if indices.shape[0] == 0:
        y0 = zero_unfolding(tuple(shape), factors, skip_mode)
        return torch.zeros((u.shape[1], y0.shape[1]),
                           dtype=kron_kernel.result_dtype(u.dtype, precision), device=u.device)
    n = len(shape)
    if n <= 3:  # the megakernel reads the factor rows through the schedule
        modes = operand_modes(n, skip_mode)
        return kron_kernel.fused_kron_scatter_ttm(
            factors[modes[0]], factors[modes[1]] if n == 3 else None, u, sched,
            int(shape[skip_mode]), precision=precision,
        )
    y = sparse_ttm_chain_device(indices, values, factors, skip_mode, sched,
                                shape=shape, precision=precision)
    return ttm(y.T, u.T, precision=precision).T
