"""Decoder blocks of every family. Port of ``repro.models.transformer``:
:func:`dense_block` (``dense``, ``moe``, ``audio``, ``vlm``),
:func:`ssm_block` (``ssm``) and :func:`hybrid_superblock` (``hybrid``),
over the shared :func:`attention_sublayer`.

Block functions are mode-polymorphic:
  mode="train"   full sequence, no cache (differentiable: the gradient
                 passes through the backward kernels of kernels 6 and 7)
  mode="prefill" full sequence, returns the layer's KV/SSM cache
  mode="decode"  single token against a pre-allocated cache

One card needs no sharding annotations: the reference's ``constrain``
calls have no counterpart.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import moe as moe_lib
from repro_torch.models.attention import decode_attention, gqa_attention
from repro_torch.models.layers import apply_rope, rmsnorm, swiglu
from repro_torch.models.mamba2 import SsmState, ssd_decode_step, ssd_mixer


def attention_sublayer(
    cfg: ModelConfig,
    p: Dict[str, torch.Tensor],
    x: torch.Tensor,
    positions: torch.Tensor,
    mode: str,
    cache: Optional[Dict[str, torch.Tensor]] = None,
    pos: Optional[int] = None,
) -> Tuple[torch.Tensor, Optional[Dict[str, torch.Tensor]]]:
    """Pre-norm GQA attention with RoPE. Train returns no cache; prefill
    returns the bf16 K/V of the sequence as the cache; decode writes this
    token's K/V into ``cache`` at
    ``pos`` in place (the reference returns an updated copy) and returns it."""
    b, s, _ = x.shape
    h_, kv = cfg.n_heads, cfg.n_kv_heads
    hd = cfg.resolved_head_dim
    h = rmsnorm(x, p["ln1"], cfg.norm_eps)
    q = h @ p["wq"]
    k = h @ p["wk"]
    v = h @ p["wv"]
    if cfg.qkv_bias:
        q = q + p["bq"]
        k = k + p["bk"]
        v = v + p["bv"]
    q = apply_rope(q.reshape(b, s, h_, hd), positions, cfg.rope_theta)
    k = apply_rope(k.reshape(b, s, kv, hd), positions, cfg.rope_theta)
    v = v.reshape(b, s, kv, hd)

    new_cache = None
    if mode == "decode":
        if cache is None or pos is None:
            raise ValueError("decode needs the layer's cache and the position")
        cache["k"][:, pos:pos + s] = k.to(torch.bfloat16)
        cache["v"][:, pos:pos + s] = v.to(torch.bfloat16)
        attn = decode_attention(q, cache["k"], cache["v"], pos)
        new_cache = cache
    else:
        attn = gqa_attention(q, k, v, causal=True)
        if mode == "prefill":
            new_cache = {"k": k.to(torch.bfloat16), "v": v.to(torch.bfloat16)}
    out = attn.reshape(b, s, h_ * hd) @ p["wo"]
    return out, new_cache


def dense_block(
    cfg: ModelConfig,
    p: Dict[str, torch.Tensor],
    x: torch.Tensor,
    positions: torch.Tensor,
    mode: str,
    cache: Optional[Dict[str, torch.Tensor]] = None,
    pos: Optional[int] = None,
):
    """Pre-norm attention then a SwiGLU MLP (``moe``: the MoE block), each
    added to the residual. Returns (x, the layer's attention cache or None,
    the f32 aux loss: the MoE block's, else 0)."""
    attn_out, new_cache = attention_sublayer(cfg, p, x, positions, mode, cache, pos)
    x = x + attn_out
    h = rmsnorm(x, p["ln2"], cfg.norm_eps)
    if cfg.family == "moe":
        mlp_out, aux = moe_lib.moe_block(cfg, h, p["router"], p["moe_wi"], p["moe_wg"],
                                         p["moe_wo"])
    else:
        mlp_out = swiglu(h, p["wi"], p["wg"], p["wo_mlp"])
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
    return x + mlp_out, new_cache, aux


def ssm_block(cfg: ModelConfig, p, x, mode: str, state: Optional[SsmState] = None):
    h = rmsnorm(x, p["ln"], cfg.norm_eps)
    if mode == "decode":
        y, new_state = ssd_decode_step(cfg, p, h, state)
    else:
        y, new_state = ssd_mixer(cfg, p, h, return_state=(mode == "prefill"))
    return x + y, new_state


def hybrid_superblock(
    cfg: ModelConfig,
    p_sb: Dict[str, torch.Tensor],  # mamba params, leading dim = hybrid_period
    shared: Dict[str, torch.Tensor],  # shared attention+MLP block params
    x: torch.Tensor,
    positions: torch.Tensor,
    mode: str,
    ssm_states: Optional[SsmState] = None,  # leading period dim (decode) or None
    attn_cache: Optional[Dict[str, torch.Tensor]] = None,
    pos: Optional[int] = None,
):
    """``hybrid_period`` mamba layers then one *shared* attention block.
    Returns (x, the new SSM states stacked over the period or None, the
    attention cache or None). The layers' parameters are taken with one
    ``unbind(0)`` per leaf: under autograd its backward writes the leaf's
    gradient once, where indexing each layer would write a zero-filled
    copy of the whole leaf per layer."""
    new_states = []
    per_layer = {name: t.unbind(0) for name, t in p_sb.items()}
    for j in range(cfg.hybrid_period):
        pj = {name: ts[j] for name, ts in per_layer.items()}
        st = SsmState(*(t[j] for t in ssm_states)) if ssm_states is not None else None
        x, st_new = ssm_block(cfg, pj, x, mode, st)
        if st_new is not None:
            new_states.append(st_new)
    attn_out, new_attn_cache = attention_sublayer(cfg, shared, x, positions, mode, attn_cache,
                                                  pos)
    x = x + attn_out
    h = rmsnorm(x, shared["ln2"], cfg.norm_eps)
    x = x + swiglu(h, shared["wi"], shared["wg"], shared["wo_mlp"])
    stacked = SsmState(*(torch.stack(t) for t in zip(*new_states))) if new_states else None
    return x, stacked, new_attn_cache
