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
calls have no counterpart. On a mesh of ranks (serving, and training
with a model axis; ``layout``, a
:class:`~repro_torch.models.sharding.ServeLayout`) every block of every
family takes this rank's blocks of the weights and moves its activations
with the mesh's collectives, as sequence- and tensor-parallel layers
(Megatron's); the Mamba-2 layers of ``ssm_block`` and
``hybrid_superblock`` are tensor-parallel over their heads
(``models.mamba2``), and the hybrid's shared block is the attention
sublayer and SwiGLU below. The residual ``("batch", "seq", "none")`` is
cut by position over the model axes in a prefill and replicated over them
in a decode step; each sublayer gathers its normed input at every position, multiplies it by
its column blocks (``wq``, ``wk``, ``wv``, the biases, ``wi``, ``wg``) and
sums the row blocks' partial products (``wo``, ``wo_mlp``) back into the
residual's layout (a reduce-scatter over the positions, or an all-reduce
where they are not cut); under autograd each collective's backward is its
adjoint (``launch.mesh``). ``attn_partitioning="cp"`` has each rank attend
with every head for its block of queries against the keys up to the
block's end (an all-to-all turns the query columns into query rows and the
output back); ``"hp"`` has it attend with its own heads over every
position. K and V are gathered whole before their heads are formed: a
column block of ``wk`` need not hold whole heads (``kv * hd`` may divide
where ``kv`` does not).
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import moe as moe_lib
from repro_torch.models.attention import decode_attention, gqa_attention
from repro_torch.models.layers import apply_rope, rmsnorm, swiglu
from repro_torch.models.mamba2 import SsmState, ssd_decode_step, ssd_mixer
from repro_torch.models.sharding import ServeLayout


def attention_sublayer(
    cfg: ModelConfig,
    p: Dict[str, torch.Tensor],
    x: torch.Tensor,
    positions: torch.Tensor,
    mode: str,
    cache: Optional[Dict[str, torch.Tensor]] = None,
    pos: Optional[int] = None,
    *,
    layout: Optional[ServeLayout] = None,
) -> Tuple[torch.Tensor, Optional[Dict[str, torch.Tensor]]]:
    """Pre-norm GQA attention with RoPE. Train returns no cache; prefill
    returns the bf16 K/V of the sequence as the cache; decode writes this
    token's K/V into ``cache`` at
    ``pos`` in place (the reference returns an updated copy) and returns it.
    With a ``layout``: :func:`_attention_on_mesh`."""
    if layout is not None:
        return _attention_on_mesh(cfg, layout, p, x, positions, mode, cache, pos)
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


def _attention_on_mesh(cfg: ModelConfig, lay: ServeLayout, p, x, positions, mode: str,
                       cache, pos):
    """:func:`attention_sublayer` on a mesh (see the module's docstring):
    ``x`` is the residual's block (b_rows, positions, d), ``positions``
    every position of the call (a decode step: its one), ``p`` this rank's
    column and row blocks. A prefill returns this rank's positions of the
    bf16 K/V as the cache; a train call runs the prefill's arithmetic under
    autograd and returns no cache; a decode step writes its token's K/V
    into this rank's block of the budget (``cache``, the ``kvseq`` block),
    where the position falls there, and attends over the cut cache
    (:func:`decode_attention` with the layout)."""
    h_, kv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    qn, kvn = h_ * hd, kv * hd
    h = lay.all_positions(rmsnorm(x, p["ln1"], cfg.norm_eps))  # (b, s, d)
    b, s, _ = h.shape
    q, k, v = h @ p["wq"], h @ p["wk"], h @ p["wv"]
    if cfg.qkv_bias:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    # whole K/V heads before any reshape: a column block may cut a head in two
    k = apply_rope(lay.whole_cols(k, kvn).reshape(b, s, kv, hd), positions, cfg.rope_theta)
    v = lay.whole_cols(v, kvn).reshape(b, s, kv, hd)
    if mode == "decode":
        q = apply_rope(lay.whole_cols(q, qn).reshape(b, s, h_, hd), positions, cfg.rope_theta)
        length = cache["k"].shape[1]
        start = lay.block(length * lay.n)[0]
        if start <= pos < start + length:
            cache["k"][:, pos - start:pos - start + s] = k.to(torch.bfloat16)
            cache["v"][:, pos - start:pos - start + s] = v.to(torch.bfloat16)
        attn = decode_attention(q, cache["k"], cache["v"], pos, layout=lay)
        return lay.row_product(attn.reshape(b, s, qn), p["wo"], qn), cache
    p0, p1 = lay.positions()
    new_cache = None if mode == "train" else {"k": k[:, p0:p1].to(torch.bfloat16),
                                              "v": v[:, p0:p1].to(torch.bfloat16)}
    if cfg.attn_partitioning == "hp" and lay.cut(h_):
        # this rank's heads over every position; its columns of wq are whole heads
        h0, h1 = lay.block(h_)
        g = h_ // kv
        ql = apply_rope(q.reshape(b, s, h1 - h0, hd), positions, cfg.rope_theta)
        if h0 % g == 0 and (h1 - h0) % g == 0:  # whole groups: a slice of the kv heads
            kl, vl = k[:, :, h0 // g:h1 // g], v[:, :, h0 // g:h1 // g]
        else:  # each query head's kv head beside it
            idx = torch.arange(h0, h1, device=k.device) // g
            kl, vl = k.index_select(2, idx), v.index_select(2, idx)
        attn = gqa_attention(ql, kl, vl, causal=True).reshape(b, s, qn // lay.n)
        return lay.reduce_partial(attn @ p["wo"]), new_cache
    if cfg.attn_partitioning == "hp" or not (lay.seq and lay.cut(qn)):
        # every head at every position (the heads, the positions or wq do not cut)
        qa = apply_rope(lay.whole_cols(q, qn).reshape(b, s, h_, hd), positions, cfg.rope_theta)
        attn = gqa_attention(qa, k, v, causal=True)
        return lay.row_product(attn.reshape(b, s, qn), p["wo"], qn), new_cache
    # "cp": every head for this rank's block of queries, against the keys up
    # to the block's end (the kernel's end-aligned causal rule is the block's);
    # all-to-alls turn q's columns into rows, and the output back for wo's rows
    qb = lay.mesh.all_to_all(q, 1, 2, lay.model).reshape(b, p1 - p0, h_, hd)
    qb = apply_rope(qb, positions[p0:p1], cfg.rope_theta)
    attn = gqa_attention(qb, k[:, :p1], v[:, :p1], causal=True).reshape(b, p1 - p0, qn)
    return lay.reduce_partial(lay.mesh.all_to_all(attn, 2, 1, lay.model) @ p["wo"]), new_cache


def _swiglu_on_mesh(cfg: ModelConfig, lay: ServeLayout, p, h: torch.Tensor) -> torch.Tensor:
    """The SwiGLU MLP of the normed residual ``h`` on a mesh: ``wi``, ``wg``
    column blocks on every position, ``wo_mlp``'s row block, the partial
    products summed into the residual's layout; whole weights (``d_ff``
    does not divide) run on this rank's positions alone."""
    if not lay.cut(cfg.d_ff):
        return swiglu(h, p["wi"], p["wg"], p["wo_mlp"])
    return lay.reduce_partial(swiglu(lay.all_positions(h), p["wi"], p["wg"], p["wo_mlp"]))


def dense_block(
    cfg: ModelConfig,
    p: Dict[str, torch.Tensor],
    x: torch.Tensor,
    positions: torch.Tensor,
    mode: str,
    cache: Optional[Dict[str, torch.Tensor]] = None,
    pos: Optional[int] = None,
    *,
    layout: Optional[ServeLayout] = None,
):
    """Pre-norm attention then a SwiGLU MLP (``moe``: the MoE block), each
    added to the residual. Returns (x, the layer's attention cache or None,
    the f32 aux loss: the MoE block's, else 0). With a ``layout`` each
    sublayer runs on the mesh (see the module's docstring)."""
    attn_out, new_cache = attention_sublayer(cfg, p, x, positions, mode, cache, pos,
                                             layout=layout)
    x = x + attn_out
    h = rmsnorm(x, p["ln2"], cfg.norm_eps)
    if cfg.family == "moe":
        mlp_out, aux = moe_lib.moe_block(cfg, h, p["router"], p["moe_wi"], p["moe_wg"],
                                         p["moe_wo"], layout=layout)
    elif layout is not None:
        mlp_out = _swiglu_on_mesh(cfg, layout, p, h)
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
    else:
        mlp_out = swiglu(h, p["wi"], p["wg"], p["wo_mlp"])
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
    return x + mlp_out, new_cache, aux


def ssm_block(cfg: ModelConfig, p, x, mode: str, state: Optional[SsmState] = None, *,
              layout: Optional[ServeLayout] = None):
    """Pre-norm Mamba-2 mixer added to the residual; returns (x, the new
    state or None). With a ``layout`` the mixer runs on the mesh."""
    h = rmsnorm(x, p["ln"], cfg.norm_eps)
    if mode == "decode":
        y, new_state = ssd_decode_step(cfg, p, h, state, layout=layout)
    else:
        y, new_state = ssd_mixer(cfg, p, h, return_state=(mode == "prefill"), layout=layout)
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
    *,
    layout: Optional[ServeLayout] = None,
):
    """``hybrid_period`` mamba layers then one *shared* attention block.
    Returns (x, the new SSM states stacked over the period or None, the
    attention cache or None). The layers' parameters are taken with one
    ``unbind(0)`` per leaf: under autograd its backward writes the leaf's
    gradient once, where indexing each layer would write a zero-filled
    copy of the whole leaf per layer. With a ``layout`` the Mamba layers,
    the shared attention and its MLP run on the mesh."""
    new_states = []
    per_layer = {name: t.unbind(0) for name, t in p_sb.items()}
    for j in range(cfg.hybrid_period):
        pj = {name: ts[j] for name, ts in per_layer.items()}
        st = SsmState(*(t[j] for t in ssm_states)) if ssm_states is not None else None
        x, st_new = ssm_block(cfg, pj, x, mode, st, layout=layout)
        if st_new is not None:
            new_states.append(st_new)
    attn_out, new_attn_cache = attention_sublayer(cfg, shared, x, positions, mode, attn_cache,
                                                  pos, layout=layout)
    x = x + attn_out
    h = rmsnorm(x, shared["ln2"], cfg.norm_eps)
    if layout is not None:
        x = x + _swiglu_on_mesh(cfg, layout, shared, h)
    else:
        x = x + swiglu(h, shared["wi"], shared["wg"], shared["wo_mlp"])
    stacked = SsmState(*(torch.stack(t) for t in zip(*new_states))) if new_states else None
    return x, stacked, new_attn_cache
