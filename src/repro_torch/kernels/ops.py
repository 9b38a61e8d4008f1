"""Host-side wrappers around the sweep's kernels.

Port of the parts of ``repro.kernels.ops`` on the sparse HOOI path: the
schedule-order gather of factor rows and the mode unfolding of a 2- or
3-way tensor. Which device runs what is decided by the kernel wrappers
alone, from the device of the tensors.
"""
from __future__ import annotations

from typing import Sequence

import torch

from repro_torch.core.kron import zero_unfolding
from repro_torch.kernels import kron_kernel
from repro_torch.kernels.ttm_kernel import ttm

__all__ = ["ttm", "sparse_ttm_chain_device"]


def _gathered_block_rows(indices, values, factors, skip_mode, sched, n):
    """The non-mode factor rows of every schedule slot, in descending mode
    order (padding slots gather row 0 with value 0)."""
    idx = indices.index_select(0, sched.order)
    vals = values.index_select(0, sched.order) * sched.valid
    modes = [t for t in range(n - 1, -1, -1) if t != skip_mode]
    rows = [factors[t].index_select(0, idx[:, t]) for t in modes]
    if len(rows) == 1:  # order-2 tensor: the "Kron row" is a single factor row
        rows.append(torch.ones((rows[0].shape[0], 1), dtype=rows[0].dtype,
                               device=rows[0].device))
    return rows, vals


def sparse_ttm_chain_device(
    indices: torch.Tensor,
    values: torch.Tensor,
    factors: Sequence[torch.Tensor],
    skip_mode: int,
    sched,
    *,
    shape: Sequence[int],
    precision: str = "fp32",
) -> torch.Tensor:
    """Y_(skip_mode) of a 2- or 3-way tensor through the fused Kron-scatter
    kernel, on the device schedule ``sched`` of that mode."""
    n = len(shape)
    if n > 3:
        raise NotImplementedError(
            "order >= 4 needs the kron_contrib and scatter_rows kernels, not "
            "ported yet (ROADMAP.md queue 2, items 3-4)"
        )
    if indices.shape[0] == 0:
        return zero_unfolding(tuple(shape), factors, skip_mode)
    rows, vals = _gathered_block_rows(indices, values, factors, skip_mode, sched, n)
    return kron_kernel.fused_kron_scatter(
        rows[0], rows[1], vals, sched, int(shape[skip_mode]), precision=precision
    )
