"""The LM: parameter schema and init, the layer stack, the LM head and the
prefill and decode steps. Port of ``repro.models.model`` for the ``hybrid``
family (Zamba2).

The schema is one dict of :class:`ParamDef` leaves, laid out as the
reference's parameter pytree (the same keys and shapes), so that
``convert.lm_params_from_numpy`` can take the reference's parameters as
they are. Other families, training (``mode="train"``, the loss, the
optimizer) and the data pipeline are not ported yet and raise.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, Optional, Tuple

import torch

from repro_torch.base import resolve_device, unported
from repro_torch.configs.base import ModelConfig
from repro_torch.models import transformer as tfm
from repro_torch.models.layers import rmsnorm
from repro_torch.models.mamba2 import SsmState

FAMILY_ITEM = "queue 1, item 18: the other LM families"
TRAINING_ITEM = "queue 1, item 19: training, with backward kernels"


def check_ported(cfg: ModelConfig) -> None:
    """Raise ``NotImplementedError`` unless ``cfg``'s family is ported."""
    if cfg.family != "hybrid":
        raise unported(f"family {cfg.family!r} ({cfg.name})", FAMILY_ITEM)


@dataclasses.dataclass(frozen=True)
class ParamDef:
    shape: Tuple[int, ...]
    init: str = "normal"  # normal | zeros | ones | a_log | dt_bias


def _attn_defs(cfg: ModelConfig) -> Dict[str, ParamDef]:
    h, kv, hd, d = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim, cfg.d_model
    defs = {
        "ln1": ParamDef((d,), "ones"),
        "wq": ParamDef((d, h * hd)),
        "wk": ParamDef((d, kv * hd)),
        "wv": ParamDef((d, kv * hd)),
        "wo": ParamDef((h * hd, d)),
    }
    if cfg.qkv_bias:
        defs["bq"] = ParamDef((h * hd,), "zeros")
        defs["bk"] = ParamDef((kv * hd,), "zeros")
        defs["bv"] = ParamDef((kv * hd,), "zeros")
    return defs


def _mlp_defs(cfg: ModelConfig) -> Dict[str, ParamDef]:
    d, ff = cfg.d_model, cfg.d_ff
    return {
        "ln2": ParamDef((d,), "ones"),
        "wi": ParamDef((d, ff)),
        "wg": ParamDef((d, ff)),
        "wo_mlp": ParamDef((ff, d)),
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
    """The parameter schema: the Mamba layers stacked (superblock, period),
    then one shared attention + MLP block."""
    check_ported(cfg)
    d, vp = cfg.d_model, cfg.padded_vocab
    n_sb = cfg.n_layers // cfg.hybrid_period
    return {
        "embed": {"table": ParamDef((vp, d))},
        "lm_head": {"w": ParamDef((d, vp))},
        "final_norm": ParamDef((d,), "ones"),
        "layers": _ssm_defs(cfg, (n_sb, cfg.hybrid_period)),
        "shared": {**_attn_defs(cfg), **_mlp_defs(cfg)},
    }


def map_defs(fn: Callable[[ParamDef], Any], defs) -> Any:
    if isinstance(defs, ParamDef):
        return fn(defs)
    return {k: map_defs(fn, v) for k, v in defs.items()}


def leaf_dtype(cfg: ModelConfig, d: ParamDef) -> torch.dtype:
    if d.init in ("ones", "a_log", "dt_bias"):
        return torch.float32  # norms and SSM scalars stay f32
    return getattr(torch, cfg.dtype)


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
        w = torch.randn(d.shape, generator=generator, dtype=torch.float32, device=dev)
        return w.mul_(1.0 / math.sqrt(max(fan_in, 1))).to(dt)

    return map_defs(init_one, param_defs(cfg))


# ---------------------------------------------------------------------------
# Forward passes
# ---------------------------------------------------------------------------


def _lm_head(cfg: ModelConfig, params, x: torch.Tensor) -> torch.Tensor:
    h = rmsnorm(x, params["final_norm"], cfg.norm_eps)
    return h @ params["lm_head"]["w"]  # (b, s, Vp)


def run_stack(cfg: ModelConfig, params, tokens: torch.Tensor, mode: str = "prefill",
              cache=None, pos: Optional[int] = None):
    """Embedding and every block; returns (hidden, cache, aux_loss).

    ``mode="prefill"`` returns the new cache: ``{"ssm": SsmState`` of
    tensors stacked (superblock, period, ...), ``"attn": {"k", "v"}`` of
    shape (superblock, b, s, kv, hd) in bf16``}``. ``mode="decode"`` takes
    such a cache grown to the serving length, writes this token's entries
    into it in place, and returns it. The LM head is the caller's.
    """
    check_ported(cfg)
    if mode == "train":
        raise unported("training (mode='train')", TRAINING_ITEM)
    if mode not in ("prefill", "decode"):
        raise ValueError(f"mode must be 'prefill' or 'decode', got {mode!r}")
    decode = mode == "decode"
    if decode and (cache is None or pos is None):
        raise ValueError("decode needs the cache and the position")
    x = params["embed"]["table"][tokens]
    if decode:
        positions = torch.full((1,), pos, dtype=torch.int32, device=x.device)
    else:
        positions = torch.arange(x.shape[1], dtype=torch.int32, device=x.device)
    layers, shared = params["layers"], params["shared"]
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
    return x, cache, torch.zeros((), dtype=torch.float32, device=x.device)


@torch.no_grad()
def forward(cfg: ModelConfig, params, tokens: torch.Tensor, mode: str = "prefill",
            cache=None, pos: Optional[int] = None):
    """Full-logits forward. Returns (logits, cache, aux)."""
    x, new_cache, aux = run_stack(cfg, params, tokens, mode, cache, pos)
    return _lm_head(cfg, params, x), new_cache, aux


def make_prefill_step(cfg: ModelConfig):
    """``prefill_step(params, {"tokens": (b, s)}) -> (last-token logits
    (b, Vp), cache)``."""
    check_ported(cfg)

    @torch.no_grad()
    def prefill_step(params, batch):
        x, cache, _ = run_stack(cfg, params, batch["tokens"], "prefill")
        return _lm_head(cfg, params, x[:, -1:, :])[:, 0, :], cache

    return prefill_step


def make_serve_step(cfg: ModelConfig):
    """``serve_step(params, cache, {"token": (b, 1), "pos": int}) ->
    (logits (b, Vp), cache)``; the cache is updated in place."""
    check_ported(cfg)

    @torch.no_grad()
    def serve_step(params, cache, batch):
        x, cache, _ = run_stack(cfg, params, batch["token"], "decode", cache, int(batch["pos"]))
        return _lm_head(cfg, params, x)[:, -1, :], cache

    return serve_step
