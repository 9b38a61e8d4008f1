"""Cross-pod gradient compression via the paper's QRP (module 3).

Port of ``repro.optim.compression``: PowerSGD-style compression with the
paper's QR with column pivoting as its factorization core. Before the
all-reduce over the *slow* group (the reference's "pod" axis), each
gradient matrix G (m x n) is compressed to rank r:

    Q = qrp_gram(G, r)          (paper module 3, Gram / pivoted-Cholesky form)
    P = G^T Q                   (n x r)
    mean of Q and P over the slow group instead of the mean of G
    G_hat = Q P^T
    error feedback: e <- G - G_hat  (added to the next step's G)

The bytes a rank hands to the reduce drop from m n to r (m + n) elements.

The reference averages with ``jax.lax.pmean`` over a named mesh axis inside
``shard_map``. Here the average is :func:`all_reduce_mean`: one
``dist.all_reduce(SUM)`` over the ``torch.distributed`` group ``group``,
divided by its size, as the sharded sweep sums its partial unfoldings
(``core/engine.py``). So :class:`CompressionConfig` has no ``slow_axis``
field: the ``group`` argument selects the reduce. ``axis_present=False``, or a world of one rank (no
process group, or a group of one), is the identity. Error feedback and the
collapse of leading dimensions ((L, d, f) -> (L d, f)) follow the reference
line for line; trees are dicts of tensors, walked in the reference's order
(``optim/adamw.py``'s ``map_tree`` and ``leaves``).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional, Tuple

import torch
import torch.distributed as dist

from repro_torch.core.distributed import world_size
from repro_torch.core.qrp import qrp_gram
from repro_torch.optim.adamw import leaves, map_tree, rebuild


@dataclasses.dataclass(frozen=True)
class CompressionConfig:
    rank: int = 64
    min_elements: int = 1 << 16  # only compress matrices bigger than this


def compress_matrix(g: torch.Tensor, rank: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """G (m, n) -> (Q (m, r), P (n, r)) with G_hat = Q @ P^T, r = min(rank, m, n),
    in f32."""
    m, n = g.shape
    r = min(rank, m, n)
    g32 = g.to(torch.float32)
    q, _ = qrp_gram(g32, r)  # paper module 3 (Gram variant)
    p = g32.T @ q
    return q, p


def decompress_matrix(q: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    return q @ p.T


def all_reduce_mean(t: torch.Tensor, group: Any = None) -> torch.Tensor:
    """The mean of ``t`` over the ranks of ``group`` (the default group when
    one is initialised): a new tensor, ``t`` itself in a world of one."""
    world = world_size(group)
    if world == 1:
        return t
    out = t.clone()
    dist.all_reduce(out, op=dist.ReduceOp.SUM, group=group)
    return out / world


def _compressible(leaf: torch.Tensor) -> bool:
    return leaf.dim() >= 2


def _as_matrix(leaf: torch.Tensor) -> torch.Tensor:
    # collapse leading dims: (L, d, f) -> (L*d, f)
    return leaf.reshape(-1, leaf.shape[-1])


def compress_grads_for_slow_axis(
    grads: Any,
    cfg: CompressionConfig,
    error: Optional[Any] = None,
    axis_present: bool = True,
    group: Any = None,
) -> Tuple[Any, Any]:
    """Compress, average over the slow group and decompress each large
    gradient matrix, with error feedback. Every rank of ``group`` calls it
    with its own gradients, the leaves in the same order;
    ``axis_present=False`` degrades to the identity reduce, as a world of
    one does.

    Returns (reduced_grads, new_error), trees of ``grads``' structure.
    """

    def one(g, e):
        g = g + e
        if not _compressible(g) or g.numel() < cfg.min_elements:
            out = all_reduce_mean(g, group) if axis_present else g
            return out, torch.zeros_like(g)
        shape = g.shape
        gm = _as_matrix(g).to(torch.float32)
        q, p = compress_matrix(gm, cfg.rank)
        if axis_present:
            q = all_reduce_mean(q, group)
            p = all_reduce_mean(p, group)
        ghat = decompress_matrix(q, p)
        err = (gm - ghat).reshape(shape).to(g.dtype)
        return ghat.reshape(shape).to(g.dtype), err

    if error is None:
        error = map_tree(torch.zeros_like, grads)
    pairs = [one(g, e) for g, e in zip(leaves(grads), leaves(error))]
    return rebuild(grads, [r for r, _ in pairs]), rebuild(grads, [e for _, e in pairs])


def compression_ratio_matrix(m: int, n: int, r: int) -> float:
    return (m * n) / (r * (m + n))
