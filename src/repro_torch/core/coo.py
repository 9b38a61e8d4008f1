"""COO sparse tensor — the paper's storage format (Section III-A, Table I).

Only nonzero entries are stored: an ``(nnz, N)`` int32 index tensor and an
``(nnz,)`` value tensor, on one device. The dense logical shape is plain
metadata. Port of ``repro.core.coo``.
"""
from __future__ import annotations

import dataclasses
from typing import Sequence, Tuple

import numpy as np
import torch


def _tensor(x, device) -> torch.Tensor:
    """A torch tensor of ``x`` on ``device``; array-likes are copied (a
    read-only numpy view, e.g. of a JAX array, cannot back a tensor)."""
    if isinstance(x, torch.Tensor):
        return x if device is None else x.to(device)
    return torch.tensor(np.asarray(x), device=device)


@dataclasses.dataclass(frozen=True)
class SparseCOO:
    """A sparse tensor in coordinate format.

    Attributes:
      indices: int32 tensor of shape (nnz, N). Row t holds the N-dim
        coordinate of nonzero t. Padding rows are allowed provided the
        matching value is exactly 0 (they then contribute nothing).
      values: float tensor of shape (nnz,), on the same device.
      shape: dense shape (I_1, ..., I_N).
    """

    indices: torch.Tensor
    values: torch.Tensor
    shape: Tuple[int, ...]

    @property
    def ndim(self) -> int:
        return len(self.shape)

    @property
    def nnz(self) -> int:
        return int(self.indices.shape[0])

    @property
    def dtype(self) -> torch.dtype:
        return self.values.dtype

    @property
    def device(self) -> torch.device:
        return self.values.device

    def density(self) -> float:
        return self.nnz / float(np.prod(self.shape))

    @classmethod
    def from_dense(cls, dense) -> "SparseCOO":
        """The nonzeros of a dense array, in row-major order. A numpy array
        gives a COO on the CPU; a tensor keeps its device."""
        if isinstance(dense, torch.Tensor):
            idx = torch.nonzero(dense).to(torch.int32)
            return cls(idx, dense[tuple(idx.long().T)], tuple(dense.shape))
        dense = np.asarray(dense)
        idx = np.argwhere(dense != 0).astype(np.int32)
        return cls(torch.from_numpy(idx), torch.from_numpy(np.ascontiguousarray(
            dense[tuple(idx.T)])), tuple(int(s) for s in dense.shape))

    @classmethod
    def from_parts(cls, indices, values, shape, device=None) -> "SparseCOO":
        """Build from array-likes (numpy or torch); ``device=None`` keeps a
        torch input's device and puts numpy input on the CPU."""
        indices = _tensor(indices, device).to(torch.int32)
        values = _tensor(values, device)
        if indices.ndim != 2 or indices.shape[1] != len(shape):
            raise ValueError(
                f"indices shape {tuple(indices.shape)} incompatible with "
                f"tensor shape {tuple(shape)}"
            )
        if values.shape[0] != indices.shape[0]:
            raise ValueError("values and indices disagree on nnz")
        if indices.device != values.device:
            raise ValueError(
                f"indices on {indices.device} but values on {values.device}"
            )
        return cls(indices, values, tuple(int(s) for s in shape))

    def to(self, device) -> "SparseCOO":
        """The same tensor on ``device`` (self when already there)."""
        device = torch.device(device)
        if self.indices.device == device and self.values.device == device:
            return self
        return SparseCOO(self.indices.to(device), self.values.to(device), self.shape)

    def to_dense(self) -> torch.Tensor:
        out = torch.zeros(self.shape, dtype=self.values.dtype, device=self.device)
        return out.index_put_(tuple(self.indices.long().T), self.values, accumulate=True)

    def norm(self) -> torch.Tensor:
        """Frobenius norm (Definition 2), in float32 like the reference."""
        return torch.sqrt(torch.sum(torch.square(self.values.to(torch.float32))))

    def scale(self, s) -> "SparseCOO":
        return SparseCOO(self.indices, self.values * s, self.shape)

    def sort_by_mode(self, mode: int) -> "SparseCOO":
        """The nonzeros stably sorted by their coordinate along ``mode``."""
        order = torch.sort(self.indices[:, mode], stable=True).indices
        return SparseCOO(self.indices[order], self.values[order], self.shape)

    def pad_to(self, target_nnz: int) -> "SparseCOO":
        """Pad with explicit zeros (index 0, value 0) up to ``target_nnz``."""
        cur = self.nnz
        if target_nnz < cur:
            raise ValueError(f"cannot pad {cur} nonzeros down to {target_nnz}")
        if target_nnz == cur:
            return self
        pad = target_nnz - cur
        pad_idx = torch.zeros((pad, self.ndim), dtype=self.indices.dtype,
                              device=self.device)
        pad_val = torch.zeros((pad,), dtype=self.values.dtype, device=self.device)
        return SparseCOO(
            torch.cat([self.indices, pad_idx], dim=0),
            torch.cat([self.values, pad_val], dim=0),
            self.shape,
        )

    def linearized_index(self, mode: int) -> np.ndarray:
        """Column of each nonzero in the mode-``mode`` unfolding (Eq. 2,
        Kolda order), as host int64 (20000^2 overflows int32)."""
        idx = self.indices.cpu().numpy()
        col = np.zeros((idx.shape[0],), dtype=np.int64)
        stride = 1
        for k in range(self.ndim):
            if k == mode:
                continue
            col = col + idx[:, k].astype(np.int64) * stride
            stride *= self.shape[k]
        return col


def unfold_dense(x: torch.Tensor, mode: int) -> torch.Tensor:
    """Mode-n matricization (Definition 3, Kolda ordering: columns ordered
    with earlier non-mode axes varying fastest)."""
    n = x.ndim
    order = [mode] + [k for k in range(n) if k != mode]
    xt = x.permute(order)
    rest = [x.shape[k] for k in range(n) if k != mode]
    # Fortran ravel of the trailing axes == reverse them, then C ravel.
    xt = xt.permute([0] + list(range(n - 1, 0, -1)))
    return xt.reshape(x.shape[mode], int(np.prod(rest)) if rest else 1)


def fold_dense(mat: torch.Tensor, mode: int, shape: Sequence[int]) -> torch.Tensor:
    """Inverse of :func:`unfold_dense`."""
    shape = tuple(int(s) for s in shape)
    n = len(shape)
    rest = [shape[k] for k in range(n) if k != mode]
    xt = mat.reshape([shape[mode]] + rest[::-1])
    xt = xt.permute([0] + list(range(n - 1, 0, -1)))
    inv = np.argsort([mode] + [k for k in range(n) if k != mode]).tolist()
    return xt.permute(inv)
