"""Analytic per-cell FLOP and HBM-byte models: the port's own copy of
``repro.models.flops`` (the reference module imports no JAX, but importing
it runs ``repro/__init__.py``, which does), over the port's
:class:`ModelConfig` and :class:`ShapeConfig`.

The counts mirror the reference's implementation, which the port computes
op for op: the capacity-factor MoE dispatch (E x cap slots through the
experts), attention over the full s x t (no causal skip), and the full-remat
recompute in training. Pure arithmetic: no peak rate of any device lives
here.

Conventions: everything is GLOBAL (whole step, all devices); divide by chip
count for per-device. bf16 activations/weights, f32 optimizer state.
"""
from __future__ import annotations

import dataclasses

from repro_torch.configs.base import ModelConfig, ShapeConfig


@dataclasses.dataclass(frozen=True)
class CellCost:
    flops: float  # total executed matmul flops (incl. remat recompute)
    model_flops: float  # useful flops: 6*N_active*D train, 2*N_active*D serve
    hbm_bytes: float  # param + activation + optimizer traffic
    notes: str = ""


def _attn_flops_fwd(cfg: ModelConfig, b: int, s: int, t: int) -> float:
    """QK^T + PV for chunked masked attention: full s x t (no causal skip —
    the jnp path masks instead of skipping; the Pallas kernel halves this)."""
    hd = cfg.resolved_head_dim
    return 2.0 * 2.0 * b * cfg.n_heads * s * t * hd


def _block_matmul_params(cfg: ModelConfig) -> float:
    """Per-layer matmul params (excludes embeddings/head)."""
    d, ff, hd = cfg.d_model, cfg.d_ff, cfg.resolved_head_dim
    if cfg.family in ("dense", "audio", "vlm"):
        return d * (cfg.n_heads + 2 * cfg.n_kv_heads) * hd + cfg.n_heads * hd * d \
            + 3 * d * ff
    if cfg.family == "moe":
        attn = d * (cfg.n_heads + 2 * cfg.n_kv_heads) * hd + cfg.n_heads * hd * d
        # experts process cap*E slots ~ tokens*topk*capacity_factor
        moe = 3 * d * ff * cfg.top_k * cfg.capacity_factor + d * cfg.n_experts
        return attn + moe
    if cfg.family in ("ssm", "hybrid"):
        din, gn, nh = cfg.d_inner, cfg.ssm_ngroups * cfg.ssm_state, cfg.ssm_nheads
        return d * (2 * din + 2 * gn + nh) + din * d
    raise ValueError(cfg.family)


def _ssd_mixer_flops_fwd(cfg: ModelConfig, b: int, s: int) -> float:
    """SSD chunk matmuls per layer: CB^T (L x L), (CB)X, chunk states, and
    inter-chunk y: per position ~ 2*h*(L*n + L*P + n*P * 2)."""
    l = min(cfg.ssm_chunk, s)
    h, n, p = cfg.ssm_nheads, cfg.ssm_state, cfg.ssm_headdim
    per_pos = 2.0 * h * (l * n + l * p + 2 * n * p)
    return b * s * per_pos


def _layer_fwd_flops(cfg: ModelConfig, b: int, s: int, t: int) -> float:
    f = 2.0 * b * s * _block_matmul_params(cfg)
    if cfg.family in ("dense", "moe", "audio", "vlm"):
        f += _attn_flops_fwd(cfg, b, s, t)
    elif cfg.family == "ssm":
        f += _ssd_mixer_flops_fwd(cfg, b, s)
    return f


def _hybrid_fwd_flops(cfg: ModelConfig, b: int, s: int, t: int) -> float:
    # per mamba layer
    din, gn, nh = cfg.d_inner, cfg.ssm_ngroups * cfg.ssm_state, cfg.ssm_nheads
    d = cfg.d_model
    mamba = 2.0 * b * s * (d * (2 * din + 2 * gn + nh) + din * d) \
        + _ssd_mixer_flops_fwd(cfg, b, s)
    n_sb = cfg.n_layers // cfg.hybrid_period
    hd = cfg.resolved_head_dim
    shared = 2.0 * b * s * (
        d * (cfg.n_heads + 2 * cfg.n_kv_heads) * hd + cfg.n_heads * hd * d
        + 3 * d * cfg.d_ff
    ) + _attn_flops_fwd(cfg, b, s, t)
    return cfg.n_layers * mamba + n_sb * shared


def _head_embed_flops_fwd(cfg: ModelConfig, tokens: float) -> float:
    return 2.0 * tokens * cfg.d_model * cfg.padded_vocab  # lm head matmul


def cell_cost(cfg: ModelConfig, shape: ShapeConfig) -> CellCost:
    b, s = shape.global_batch, shape.seq_len
    if shape.kind == "train":
        t = s
        if cfg.family == "hybrid":
            stack_fwd = _hybrid_fwd_flops(cfg, b, s, t)
        else:
            stack_fwd = cfg.n_layers * _layer_fwd_flops(cfg, b, s, t)
        head_fwd = _head_embed_flops_fwd(cfg, b * s)
        # full remat: fwd + recompute-fwd + bwd(2x fwd) = 4x for the stack;
        # head/loss is outside the checkpointed scan: 3x.
        flops = 4.0 * stack_fwd + 3.0 * head_fwd
        model_flops = 6.0 * cfg.active_param_count() * shape.tokens
        # bytes: params bf16 read 3x (fwd, recompute, bwd) + grads f32 rs +
        # opt state f32 read+write + activation stash write+read (bf16 x,
        # per layer) + logits/CE traffic.
        n = cfg.param_count()
        act = 2.0 * b * s * cfg.d_model * cfg.n_layers * 2  # stash w+r bf16
        hbm = 3.0 * 2.0 * n + 2.0 * 4.0 * 3.0 * n + act \
            + 2.0 * 4.0 * b * s * cfg.padded_vocab / 8.0  # chunked CE (f32/8)
        return CellCost(flops, model_flops, hbm, "train: 4x stack (full remat)")
    if shape.kind == "prefill":
        t = s
        if cfg.family == "hybrid":
            flops = _hybrid_fwd_flops(cfg, b, s, t)
        else:
            flops = cfg.n_layers * _layer_fwd_flops(cfg, b, s, t)
        flops += _head_embed_flops_fwd(cfg, b * 1)  # last-token head only
        model_flops = 2.0 * cfg.active_param_count() * shape.tokens
        n = cfg.param_count()
        kv_bytes = _cache_bytes(cfg, b, s)
        hbm = 2.0 * n + kv_bytes + 2.0 * b * s * cfg.d_model * cfg.n_layers
        return CellCost(flops, model_flops, hbm, "prefill: 1x fwd, cache write")
    # decode: one token against a seq_len cache
    if cfg.family == "hybrid":
        flops = _hybrid_fwd_flops(cfg, b, 1, s)
    elif cfg.family == "ssm":
        # recurrent step: projections + state update (h: heads x P x N)
        flops = cfg.n_layers * (
            2.0 * b * _block_matmul_params(cfg)
            + 2.0 * b * cfg.ssm_nheads * cfg.ssm_headdim * cfg.ssm_state * 2
        )
    else:
        flops = cfg.n_layers * _layer_fwd_flops(cfg, b, 1, s)
    flops += _head_embed_flops_fwd(cfg, b)
    model_flops = 2.0 * cfg.active_param_count() * b
    n = cfg.param_count()
    hbm = 2.0 * n + _cache_bytes(cfg, b, s)  # read weights + read cache
    return CellCost(flops, model_flops, hbm, "decode: weight+cache bound")


def _cache_bytes(cfg: ModelConfig, b: int, s: int) -> float:
    hd = cfg.resolved_head_dim
    if cfg.family in ("dense", "moe", "audio", "vlm"):
        return 2.0 * 2.0 * cfg.n_layers * b * s * cfg.n_kv_heads * hd
    if cfg.family == "ssm":
        return 4.0 * cfg.n_layers * b * cfg.ssm_nheads * cfg.ssm_headdim * cfg.ssm_state
    if cfg.family == "hybrid":
        n_sb = cfg.n_layers // cfg.hybrid_period
        attn = 2.0 * 2.0 * n_sb * b * s * cfg.n_kv_heads * hd
        ssm = 4.0 * cfg.n_layers * b * cfg.ssm_nheads * cfg.ssm_headdim * cfg.ssm_state
        return attn + ssm
    raise ValueError(cfg.family)
