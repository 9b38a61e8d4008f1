"""The LM: parameter schema and init, the layer stack, the LM head and the
prefill and decode steps. Port of ``repro.models.model`` for every family:
``dense``, ``moe``, ``ssm``, ``audio``, ``vlm`` and ``hybrid``.

The schema is one dict of :class:`ParamDef` leaves, laid out as the
reference's parameter pytree (the same keys and shapes) for every family,
so that ``convert.lm_params_from_numpy`` can take the reference's
parameters as they are and :func:`param_count_actual` counts what the
reference counts without allocating anything. Training (``mode="train"``,
the loss, the optimizer) and the data pipeline are not ported yet and
raise.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, Optional, Tuple

import torch

from repro_torch.base import resolve_device, unported
from repro_torch.configs.base import ModelConfig
from repro_torch.models import transformer as tfm
from repro_torch.models.layers import init_normal, rmsnorm
from repro_torch.models.mamba2 import SsmState

TRAINING_ITEM = "queue 1, item 19: training, with backward kernels"
PORTED_FAMILIES = ("dense", "moe", "ssm", "hybrid", "audio", "vlm")
ATTENTION_FAMILIES = ("dense", "moe", "audio", "vlm")  # a stack of dense_block


def check_ported(cfg: ModelConfig) -> None:
    """Raise ``ValueError`` unless ``cfg``'s family is one the port serves."""
    if cfg.family not in PORTED_FAMILIES:
        raise ValueError(f"unknown family {cfg.family!r} ({cfg.name})")


@dataclasses.dataclass(frozen=True)
class ParamDef:
    shape: Tuple[int, ...]
    init: str = "normal"  # normal | zeros | ones | a_log | dt_bias


def _attn_defs(cfg: ModelConfig, lead: Tuple[int, ...] = ()) -> Dict[str, ParamDef]:
    h, kv, hd, d = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim, cfg.d_model
    defs = {
        "ln1": ParamDef(lead + (d,), "ones"),
        "wq": ParamDef(lead + (d, h * hd)),
        "wk": ParamDef(lead + (d, kv * hd)),
        "wv": ParamDef(lead + (d, kv * hd)),
        "wo": ParamDef(lead + (h * hd, d)),
    }
    if cfg.qkv_bias:
        defs["bq"] = ParamDef(lead + (h * hd,), "zeros")
        defs["bk"] = ParamDef(lead + (kv * hd,), "zeros")
        defs["bv"] = ParamDef(lead + (kv * hd,), "zeros")
    return defs


def _mlp_defs(cfg: ModelConfig, lead: Tuple[int, ...] = ()) -> Dict[str, ParamDef]:
    d, ff = cfg.d_model, cfg.d_ff
    return {
        "ln2": ParamDef(lead + (d,), "ones"),
        "wi": ParamDef(lead + (d, ff)),
        "wg": ParamDef(lead + (d, ff)),
        "wo_mlp": ParamDef(lead + (ff, d)),
    }


def _moe_defs(cfg: ModelConfig, lead: Tuple[int, ...]) -> Dict[str, ParamDef]:
    """The ``moe`` family's MLP leaves: the router and the expert stacks,
    each expert's d_ff split over ``expert_shards``."""
    d, ff = cfg.d_model, cfg.d_ff
    e_eff = cfg.n_experts_eff
    ff_s = ff // cfg.expert_shards
    return {
        "ln2": ParamDef(lead + (d,), "ones"),
        "router": ParamDef(lead + (d, cfg.n_experts)),
        "moe_wi": ParamDef(lead + (e_eff, d, ff_s)),
        "moe_wg": ParamDef(lead + (e_eff, d, ff_s)),
        "moe_wo": ParamDef(lead + (e_eff, ff_s, d)),
    }


def _ssm_defs(cfg: ModelConfig, lead: Tuple[int, ...]) -> Dict[str, ParamDef]:
    d, din = cfg.d_model, cfg.d_inner
    gn = cfg.ssm_ngroups * cfg.ssm_state
    nh, k = cfg.ssm_nheads, cfg.ssm_conv
    return {
        "ln": ParamDef(lead + (d,), "ones"),
        "wz": ParamDef(lead + (d, din)),
        "wx": ParamDef(lead + (d, din)),
        "wb": ParamDef(lead + (d, gn)),
        "wc": ParamDef(lead + (d, gn)),
        "wdt": ParamDef(lead + (d, nh)),
        "dt_bias": ParamDef(lead + (nh,), "dt_bias"),
        "a_log": ParamDef(lead + (nh,), "a_log"),
        "d_skip": ParamDef(lead + (nh,), "ones"),
        "conv_x": ParamDef(lead + (din, k)),
        "conv_b": ParamDef(lead + (gn, k)),
        "conv_c": ParamDef(lead + (gn, k)),
        "norm_w": ParamDef(lead + (din,), "ones"),
        "wo": ParamDef(lead + (din, d)),
    }


def param_defs(cfg: ModelConfig) -> Dict[str, Any]:
    """The parameter schema of every family, as the reference's: the layers
    stacked along a leading axis (``hybrid``: the Mamba layers stacked
    (superblock, period), then one shared attention + MLP block)."""
    d, vp, n_layers = cfg.d_model, cfg.padded_vocab, cfg.n_layers
    defs: Dict[str, Any] = {
        "embed": {"table": ParamDef((vp, d))},
        "lm_head": {"w": ParamDef((d, vp))},
        "final_norm": ParamDef((d,), "ones"),
    }
    lead = (n_layers,)
    if cfg.family == "moe":
        defs["layers"] = {**_attn_defs(cfg, lead), **_moe_defs(cfg, lead)}
    elif cfg.family in ATTENTION_FAMILIES:
        defs["layers"] = {**_attn_defs(cfg, lead), **_mlp_defs(cfg, lead)}
    elif cfg.family == "ssm":
        defs["layers"] = _ssm_defs(cfg, lead)
    elif cfg.family == "hybrid":
        n_sb = n_layers // cfg.hybrid_period
        defs["layers"] = _ssm_defs(cfg, (n_sb, cfg.hybrid_period))
        defs["shared"] = {**_attn_defs(cfg), **_mlp_defs(cfg)}
    else:
        raise ValueError(f"unknown family {cfg.family!r} ({cfg.name})")
    return defs


def map_defs(fn: Callable[[ParamDef], Any], defs) -> Any:
    if isinstance(defs, ParamDef):
        return fn(defs)
    return {k: map_defs(fn, v) for k, v in defs.items()}


def leaf_dtype(cfg: ModelConfig, d: ParamDef) -> torch.dtype:
    if d.init in ("ones", "a_log", "dt_bias"):
        return torch.float32  # norms and SSM scalars stay f32
    return getattr(torch, cfg.dtype)


def param_shapes(cfg: ModelConfig):
    """The parameter tree as ``meta`` tensors, each of its leaf's shape and
    dtype: the twin of the reference's ``ShapeDtypeStruct`` tree, nothing
    allocated."""
    return map_defs(lambda d: torch.empty(d.shape, dtype=leaf_dtype(cfg, d), device="meta"),
                    param_defs(cfg))


def param_count_actual(cfg: ModelConfig) -> int:
    """Parameters in the schema, counted from the shapes alone."""
    total = 0

    def add(d: ParamDef) -> None:
        nonlocal total
        total += math.prod(d.shape)

    map_defs(add, param_defs(cfg))
    return int(total)


def init_params(cfg: ModelConfig, generator: torch.Generator, device="cuda"):
    """Random parameters on ``device`` (``"cuda"`` unless the caller asks for
    the CPU), with the reference's distributions: weights N(0, 1/fan_in) in
    f32 then cast to the model dtype, norms and the skip 1, biases 0,
    ``a_log = log(linspace(1, 16, heads))``, ``dt_bias = -4.6``. Normal
    leaves draw from ``generator`` (which lives on ``device``) in schema
    order."""
    dev = resolve_device(device)

    def init_one(d: ParamDef) -> torch.Tensor:
        dt = leaf_dtype(cfg, d)
        if d.init == "zeros":
            return torch.zeros(d.shape, dtype=dt, device=dev)
        if d.init == "ones":
            return torch.ones(d.shape, dtype=dt, device=dev)
        if d.init == "a_log":
            base = torch.log(torch.linspace(1.0, 16.0, d.shape[-1], dtype=torch.float32,
                                            device=dev))
            return base.expand(d.shape).to(dt).clone()
        if d.init == "dt_bias":
            return torch.full(d.shape, -4.6, dtype=dt, device=dev)
        fan_in = d.shape[-2] if len(d.shape) >= 2 else d.shape[-1]
        return init_normal(generator, d.shape, 1.0 / math.sqrt(max(fan_in, 1)), dt, dev)

    return map_defs(init_one, param_defs(cfg))


# ---------------------------------------------------------------------------
# Forward passes
# ---------------------------------------------------------------------------


def _lm_head(cfg: ModelConfig, params, x: torch.Tensor) -> torch.Tensor:
    h = rmsnorm(x, params["final_norm"], cfg.norm_eps)
    return h @ params["lm_head"]["w"]  # (b, s, Vp)


def _embed(cfg: ModelConfig, params, tokens: Optional[torch.Tensor],
           embeds: Optional[torch.Tensor]) -> torch.Tensor:
    """The token embeddings, or the caller's ``embeds`` (b, s, d) in the
    model's dtype: the audio and vision front ends hand their frame or
    patch embeddings over directly (the reference's ``_embed``)."""
    if embeds is not None:
        return embeds.to(getattr(torch, cfg.dtype))
    if tokens is None:
        raise ValueError("run_stack needs tokens or embeds")
    return params["embed"]["table"][tokens]


def run_stack(cfg: ModelConfig, params, tokens: Optional[torch.Tensor] = None,
              embeds: Optional[torch.Tensor] = None, mode: str = "prefill", cache=None,
              pos: Optional[int] = None):
    """Embedding (or ``embeds``) and every block; returns (hidden, cache,
    aux_loss): the f32 sum of the ``moe`` blocks' load-balance losses, 0
    for the other families.

    ``mode="prefill"`` returns the new cache, the reference's layout: for
    ``dense``, ``moe``, ``audio`` and ``vlm`` ``{"k", "v"}`` stacked (L, b, s, kv,
    hd) in bf16; for ``ssm`` an :class:`SsmState` of tensors stacked over
    the L layers; for ``hybrid`` ``{"ssm": SsmState`` stacked (superblock,
    period, ...), ``"attn": {"k", "v"}`` stacked (superblock, b, s, kv,
    hd)``}``. ``mode="decode"`` takes such a cache grown to the serving
    length, writes this token's entries into it in place, and returns it.
    The layers run as a Python loop. The LM head is the caller's.
    """
    check_ported(cfg)
    if mode == "train":
        raise unported("training (mode='train')", TRAINING_ITEM)
    if mode not in ("prefill", "decode"):
        raise ValueError(f"mode must be 'prefill' or 'decode', got {mode!r}")
    decode = mode == "decode"
    if decode and (cache is None or pos is None):
        raise ValueError("decode needs the cache and the position")
    x = _embed(cfg, params, tokens, embeds)
    if decode:
        positions = torch.full((1,), pos, dtype=torch.int32, device=x.device)
    else:
        positions = torch.arange(x.shape[1], dtype=torch.int32, device=x.device)
    layers = params["layers"]
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    if cfg.family in ATTENTION_FAMILIES:
        ks, vs = [], []
        for i in range(cfg.n_layers):
            p_l = {name: t[i] for name, t in layers.items()}
            cache_l = {n: cache[n][i] for n in ("k", "v")} if decode else None
            x, new_cache, aux_l = tfm.dense_block(cfg, p_l, x, positions, mode, cache_l, pos)
            aux = aux + aux_l
            if not decode:
                ks.append(new_cache["k"])
                vs.append(new_cache["v"])
        if not decode:
            cache = {"k": torch.stack(ks), "v": torch.stack(vs)}
    elif cfg.family == "ssm":
        states = []
        for i in range(cfg.n_layers):
            p_l = {name: t[i] for name, t in layers.items()}
            st = SsmState(*(t[i] for t in cache)) if decode else None
            x, new_state = tfm.ssm_block(cfg, p_l, x, mode, st)
            if decode:
                for slot, new in zip(st, new_state):
                    slot.copy_(new)
            else:
                states.append(new_state)
        if not decode:
            cache = SsmState(*(torch.stack(t) for t in zip(*states)))
    else:  # hybrid
        shared = params["shared"]
        n_sb = cfg.n_layers // cfg.hybrid_period
        states, ks, vs = [], [], []
        for i in range(n_sb):
            p_sb = {name: t[i] for name, t in layers.items()}
            ssm_in = SsmState(*(t[i] for t in cache["ssm"])) if decode else None
            attn_in = {n: cache["attn"][n][i] for n in ("k", "v")} if decode else None
            x, new_states, new_attn = tfm.hybrid_superblock(
                cfg, p_sb, shared, x, positions, mode, ssm_in, attn_in, pos)
            if decode:
                for slot, new in zip(ssm_in, new_states):
                    slot.copy_(new)
            else:
                states.append(new_states)
                ks.append(new_attn["k"])
                vs.append(new_attn["v"])
        if not decode:
            cache = {"ssm": SsmState(*(torch.stack(t) for t in zip(*states))),
                     "attn": {"k": torch.stack(ks), "v": torch.stack(vs)}}
    return x, cache, aux


@torch.no_grad()
def forward(cfg: ModelConfig, params, tokens: Optional[torch.Tensor] = None,
            embeds: Optional[torch.Tensor] = None, mode: str = "prefill", cache=None,
            pos: Optional[int] = None):
    """Full-logits forward. Returns (logits, cache, aux)."""
    x, new_cache, aux = run_stack(cfg, params, tokens, embeds, mode, cache, pos)
    return _lm_head(cfg, params, x), new_cache, aux


def make_prefill_step(cfg: ModelConfig):
    """``prefill_step(params, {"tokens": (b, s)} or {"embeds": (b, s, d)})
    -> (last-token logits (b, Vp), cache)``."""
    check_ported(cfg)

    @torch.no_grad()
    def prefill_step(params, batch):
        x, cache, _ = run_stack(cfg, params, batch.get("tokens"), batch.get("embeds"),
                                "prefill")
        return _lm_head(cfg, params, x[:, -1:, :])[:, 0, :], cache

    return prefill_step


def make_serve_step(cfg: ModelConfig):
    """``serve_step(params, cache, {"token": (b, 1) or "embed": (b, 1, d),
    "pos": int}) -> (logits (b, Vp), cache)``; the cache is updated in
    place."""
    check_ported(cfg)

    @torch.no_grad()
    def serve_step(params, cache, batch):
        x, cache, _ = run_stack(cfg, params, batch.get("token"), batch.get("embed"), "decode",
                                cache, int(batch["pos"]))
        return _lm_head(cfg, params, x)[:, -1, :], cache

    return serve_step
