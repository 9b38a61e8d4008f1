"""Common NN layers, port of ``repro.models.layers``.

``pack_bf16``/``unpack_bf16`` have no counterpart and are left out: they
are a storage trick of the reference's compiled scans (bf16 kept as
``uint16`` bit patterns across scan boundaries, so that the host backend
does not widen it to f32). Eager PyTorch keeps bf16 as it is on both
devices, so the caches hold ``torch.bfloat16`` tensors where the reference
holds ``uint16`` bit patterns (``convert.bf16_from_bits`` reads them).
"""
from __future__ import annotations

from typing import Callable

import torch
import torch.nn.functional as F


def rmsnorm(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """RMS norm over the last axis, in f32 inside; the output has x's dtype."""
    x32 = x.to(torch.float32)
    var = torch.mean(torch.square(x32), dim=-1, keepdim=True)
    out = x32 * torch.rsqrt(var + eps)
    return (out * w.to(torch.float32)).to(x.dtype)


def rmsnorm_cut(x: torch.Tensor, w: torch.Tensor, eps: float, width: int,
                total: Callable[[torch.Tensor], torch.Tensor]) -> torch.Tensor:
    """:func:`rmsnorm` of a tensor whose last axis, of ``width``, is cut in
    blocks across ranks: ``x`` and ``w`` are this rank's blocks, and
    ``total`` sums each rank's (..., 1) f32 sum of squares over the ranks
    (``ServeLayout.model_sum``, an all-reduce whose backward all-reduces
    the squares' gradient: each rank's block feeds every rank's norm). The
    output is this rank's block of the whole's. The reference's twin is
    the gated norm of ``repro.models.mamba2`` over a ``"tp"``-sharded
    ``d_inner``, which GSPMD sums the same way."""
    x32 = x.to(torch.float32)
    var = total(torch.sum(torch.square(x32), dim=-1, keepdim=True)) / width
    out = x32 * torch.rsqrt(var + eps)
    return (out * w.to(torch.float32)).to(x.dtype)


def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32, device=device) / head_dim
    return 1.0 / (theta ** exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x: (..., seq, heads, head_dim); positions: (..., seq)."""
    hd = x.shape[-1]
    freqs = rope_freqs(hd, theta, device=x.device)  # (hd/2,)
    angles = positions[..., :, None].to(torch.float32) * freqs  # (..., s, hd/2)
    cos = torch.cos(angles)[..., :, None, :]  # (..., s, 1, hd/2)
    sin = torch.sin(angles)[..., :, None, :]
    x32 = x.to(torch.float32)
    x1, x2 = x32[..., : hd // 2], x32[..., hd // 2:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def swiglu(x: torch.Tensor, wi: torch.Tensor, wg: torch.Tensor, wo: torch.Tensor) -> torch.Tensor:
    h = F.silu(x @ wg) * (x @ wi)
    return h @ wo


def softmax_cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                          vocab_size: int) -> torch.Tensor:
    """Mean cross-entropy over the tokens, in f32. ``logits`` (..., Vp) may
    be vocab-padded: the padded ids are masked out by a 1-D additive
    ``-1e30`` bias before the ``logsumexp``. The reference takes the label
    logit as the sum of the logits times a materialised one-hot; every
    term of that sum but the label's is an exact zero, so ``gather`` gives
    the same value (and the same gradient, the one-hot) without the
    (..., Vp) f32 one-hot."""
    vp = logits.shape[-1]
    logits32 = logits.to(torch.float32)
    live = torch.arange(vp, device=logits.device) < vocab_size
    pad_bias = torch.where(live, 0.0, -1e30)
    logits32 = logits32 + pad_bias
    lse = torch.logsumexp(logits32, dim=-1)
    label_logit = torch.gather(logits32, -1, labels[..., None].to(torch.int64))[..., 0]
    return torch.mean(lse - label_logit)


INIT_CHUNK = 1 << 28  # elements drawn in f32 at a time (1 GiB)


def init_normal(generator: torch.Generator, shape, scale: float, dtype,
                device=None) -> torch.Tensor:
    """``scale`` x N(0, 1) drawn in f32 from ``generator``, then cast to
    ``dtype``: the reference's ``init_normal`` with a torch generator in
    place of a JAX key (on the generator's device unless ``device`` says).
    The draw goes by blocks of rows of at most ``INIT_CHUNK`` elements, so
    the f32 draw of a large leaf (grok's (L, 16, 6,144, 16,384) expert
    stacks) never sits beside the whole cast; a leaf of one block is one
    draw of its shape."""
    dev = device if device is not None else generator.device
    out = torch.empty(tuple(shape), dtype=dtype, device=dev)
    rows = out.view(-1, out.shape[-1])
    step = max(1, INIT_CHUNK // rows.shape[1])
    for i in range(0, rows.shape[0], step):
        part = rows[i:i + step]
        w = torch.randn(part.shape, generator=generator, dtype=torch.float32, device=dev)
        part.copy_(w.mul_(scale))
    return out
