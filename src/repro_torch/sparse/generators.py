"""Synthetic sparse tensor generators (paper Section IV-B).

Port of ``repro.sparse.generators``: the same numpy draws in the same order,
so one seed gives the same coordinates and values in both packages. The
tensors come back on the CPU; the plan moves them to its device.
"""
from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np

from repro_torch.core.coo import SparseCOO


def _sample_unique_coords(
    rng: np.random.Generator, shape: Sequence[int], nnz: int
) -> np.ndarray:
    """Sample ``nnz`` distinct coordinates uniformly over the dense index
    space by rejection, without densifying. A Python set loop: meant for the
    paper's sizes, not for tens of millions of nonzeros."""
    total = int(np.prod([int(s) for s in shape], dtype=np.float64))
    seen: set = set()
    out = np.empty((nnz,), dtype=np.int64)
    filled = 0
    while filled < nnz:
        batch = rng.integers(0, total, size=max(2 * (nnz - filled), 16), dtype=np.int64)
        for b in batch:
            if b not in seen:
                seen.add(b)
                out[filled] = b
                filled += 1
                if filled == nnz:
                    break
    coords = np.empty((nnz, len(shape)), dtype=np.int32)
    lin = out
    for k in range(len(shape) - 1, -1, -1):
        coords[:, k] = lin % shape[k]
        lin = lin // shape[k]
    return coords


def random_sparse_tensor(
    shape: Sequence[int],
    sparsity: float,
    seed: int = 0,
    value_dist: str = "normal",
    dtype=np.float32,
) -> SparseCOO:
    """Uniformly random sparse tensor with density ``sparsity`` (nnz/size)."""
    rng = np.random.default_rng(seed)
    total = float(np.prod([float(s) for s in shape]))
    nnz = max(1, int(round(total * sparsity)))
    coords = _sample_unique_coords(rng, shape, nnz)
    if value_dist == "normal":
        vals = rng.standard_normal(nnz).astype(dtype)
    elif value_dist == "uniform":
        vals = rng.uniform(0.1, 10.0, size=nnz).astype(dtype)
    elif value_dist == "binary":
        vals = np.ones((nnz,), dtype=dtype)
    elif value_dist == "counts":
        vals = rng.poisson(3.0, size=nnz).astype(dtype) + 1.0
    else:
        raise ValueError(value_dist)
    return SparseCOO.from_parts(coords, vals, tuple(int(s) for s in shape))


LOW_RANK_CHUNK = 1 << 14  # nonzeros evaluated at once by low_rank_sparse_tensor


def low_rank_sparse_tensor(
    shape: Sequence[int],
    ranks: Sequence[int],
    sparsity: float,
    seed: int = 0,
    noise: float = 0.0,
    dtype=np.float32,
) -> Tuple[SparseCOO, dict]:
    """Sparse observation of an exactly low-multilinear-rank tensor.

    Returns (coo, truth) where truth holds the generating core/factors
    (numpy)."""
    rng = np.random.default_rng(seed)
    factors = [np.linalg.qr(rng.standard_normal((int(s), int(r))))[0]
               for s, r in zip(shape, ranks)]
    core = rng.standard_normal([int(r) for r in ranks])
    total = float(np.prod([float(s) for s in shape]))
    nnz = max(1, int(round(total * sparsity)))
    coords = _sample_unique_coords(rng, shape, nnz)
    # x_i = sum_r G[r] * prod_t U_t[i_t, r_t], contracted mode by mode, on
    # chunks of nonzeros: each value is summed as in one piece (the same
    # bits), without the (nnz, prod R) copy of the core (55 GB at 1.7 M
    # nonzeros and ranks 16^3).
    vals = np.empty((nnz,), dtype=np.float64)
    for s in range(0, nnz, LOW_RANK_CHUNK):
        c = coords[s:s + LOW_RANK_CHUNK]
        tmp = core.reshape(1, *core.shape).repeat(c.shape[0], axis=0)
        for t in range(len(shape)):
            tmp = np.einsum("nr...,nr->n...", tmp, factors[t][c[:, t]])
        vals[s:s + c.shape[0]] = tmp
    vals = vals.astype(dtype)
    if noise > 0:
        vals = vals + noise * rng.standard_normal(nnz).astype(dtype)
    coo = SparseCOO.from_parts(coords, vals, tuple(int(s) for s in shape))
    return coo, {"core": core, "factors": factors}
