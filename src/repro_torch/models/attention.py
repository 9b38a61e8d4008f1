"""GQA attention: the prefill path through the attention kernel, and the
cached single-token decode path. Port of ``repro.models.attention``.

Layouts:  q (b, s, H, hd);  k, v (b, t, KV, hd);  H = KV * G.
Causal convention: the diagonal is aligned to the *end* of the kv axis
(query i attends to kv j iff  j <= i + t - s), serving prefill (s == t)
and single-token decode (s == 1) with one rule.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from repro_torch.kernels import ops

NEG_INF = -1e30


def gqa_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  causal: bool = True, scale: Optional[float] = None) -> torch.Tensor:
    """Causal GQA attention (prefill path), (b, s, H, hd) in q's dtype.

    The reference computes this function blockwise in plain jnp (its Pallas
    kernel is the TPU twin); here it is ``ops.flash_attention`` on
    (b, H, s, hd) views of the projections, which the kernel reads through
    their strides: no copy in or out.
    """
    out = ops.flash_attention(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                              causal=causal, scale=scale)
    return out.transpose(1, 2)


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor,
                     pos: int, scale: Optional[float] = None, *,
                     layout=None) -> torch.Tensor:
    """Single-token attention against a pre-allocated cache, plain torch ops
    as in the reference (no kernel there either). q (b, 1, H, hd); caches
    (b, S, KV, hd); ``pos`` is the number of live cache entries before q,
    which sits at ``pos``.

    With a ``layout`` (:class:`~repro_torch.models.sharding.ServeLayout`)
    that cuts the model axes, the caches are this rank's block of the
    serving budget's positions (``kvseq``): each rank takes its block's
    partial max, sum and weighted values in f32, and every rank combines
    all the ranks' partials in block order (one all-gather), as the
    reference's docstring has GSPMD do over a seq-sharded cache."""
    b, _, h, hd = q.shape
    _, smax, kvh, _ = k_cache.shape
    g = h // kvh
    scale_ = scale if scale is not None else 1.0 / math.sqrt(hd)
    qg = q.reshape(b, kvh, g, hd).to(torch.float32)
    logits = torch.einsum("bkgd,btkd->bkgt", qg, k_cache.to(torch.float32)) * scale_
    cut = layout is not None and layout.n > 1
    start = layout.block(smax * layout.n)[0] if cut else 0
    live_bias = torch.where(torch.arange(start, start + smax, device=q.device) <= pos, 0.0,
                            NEG_INF)
    logits = logits + live_bias
    if not cut:
        p = torch.softmax(logits, dim=-1)
        out = torch.einsum("bkgt,btkd->bkgd", p, v_cache.to(torch.float32))
        return out.reshape(b, 1, h, hd).to(q.dtype)
    m = logits.amax(dim=-1, keepdim=True)  # (b, kv, g, 1); -1e30 on a block with none live
    e = torch.exp(logits - m)
    part = torch.cat([m, e.sum(dim=-1, keepdim=True),
                      torch.einsum("bkgt,btkd->bkgd", e, v_cache.to(torch.float32))], dim=-1)
    parts = layout.mesh.all_gather(part[None], 0, layout.model)  # (n, b, kv, g, 2 + hd)
    weight = torch.exp(parts[..., :1] - parts[..., :1].amax(dim=0))  # a dead block's: 0
    total = (weight * parts[..., 1:]).sum(dim=0)
    out = total[..., 1:] / total[..., :1]
    return out.reshape(b, 1, h, hd).to(q.dtype)
