"""The LM: parameter schema and init, the layer stack, the LM head, the
training loss and the prefill and decode steps. Port of
``repro.models.model`` for every family: ``dense``, ``moe``, ``ssm``,
``audio``, ``vlm`` and ``hybrid``.

The schema is one dict of :class:`ParamDef` leaves, laid out as the
reference's parameter pytree (the same keys and shapes) for every family,
so that ``convert.lm_params_from_numpy`` can take the reference's
parameters as they are and :func:`param_count_actual` counts what the
reference counts without allocating anything. ``mode="train"`` is
differentiable (the gradient of kernels 6 and 7 is their backward kernels),
with each layer body (each hybrid superblock) rematerialised as
``cfg.remat`` says; :func:`make_loss_fn` is the loss that
``repro_torch.train`` minimises.

Serving and training run on a mesh of ranks too (``mesh=``, ``rules=`` of
:func:`run_stack`, :func:`make_prefill_step`, :func:`make_serve_step`,
:func:`make_loss_fn`; a train step takes this rank's rows and runs the
same mesh layers under autograd, see :func:`make_loss_fn`):
every rank is given the whole batch and holds its blocks of the parameters
under :func:`param_pspecs`; it computes its rows and, over the model axes,
its positions (a prefill) or its block of the cache (a decode step), with
the ``"fsdp"`` / ``"expert_fsdp"`` blocks gathered over the data axes
inside each layer, and every rank ends with the whole logits. Every
family runs on any mesh: the attention families' blocks as sequence-,
tensor- and expert-parallel layers, the ``ssm`` and ``hybrid`` families'
Mamba-2 layers tensor-parallel over their heads (``models.mamba2``). The
decode cache's blocks are :func:`cache_pspecs`'.
"""
from __future__ import annotations

import dataclasses
import functools
import math
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch
import torch.utils.checkpoint as torch_checkpoint

from repro_torch.base import resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.models import transformer as tfm
from repro_torch.models.layers import init_normal, rmsnorm, softmax_cross_entropy
from repro_torch.models.mamba2 import SsmState
from repro_torch.models.sharding import (DEFAULT_RULES, RULES_TRAIN, NamedSharding, ServeLayout,
                                         ShardingRules, _resolve_axes, axes_tuple, spec_for)
from repro_torch.optim.adamw import map_tree

MODES = ("train", "prefill", "decode")
PORTED_FAMILIES = ("dense", "moe", "ssm", "hybrid", "audio", "vlm")
ATTENTION_FAMILIES = ("dense", "moe", "audio", "vlm")  # a stack of dense_block


def check_ported(cfg: ModelConfig) -> None:
    """Raise ``ValueError`` unless ``cfg``'s family is one the port serves."""
    if cfg.family not in PORTED_FAMILIES:
        raise ValueError(f"unknown family {cfg.family!r} ({cfg.name})")


def on_mesh(mesh) -> bool:
    """Whether ``mesh`` has more than one rank (a mesh of one is no mesh:
    its runs are the unsharded runs, bit for bit)."""
    return mesh is not None and mesh.size > 1


def check_serving_mesh(cfg: ModelConfig, mesh, rules: ShardingRules) -> None:
    """Raise ``ValueError`` where ``cfg`` cannot be served on ``mesh`` under
    ``rules``: a rules table whose model-parallel names do not share their
    axes (``ServeLayout.build``)."""
    check_ported(cfg)
    if on_mesh(mesh):
        ServeLayout.build(mesh, rules, 1, 1)


@dataclasses.dataclass(frozen=True)
class ParamDef:
    shape: Tuple[int, ...]
    logical: Tuple[str, ...]  # each dim's logical name (``models.sharding``'s rules)
    init: str = "normal"  # normal | zeros | ones | a_log | dt_bias
    dtype: Optional[str] = None  # overrides the model dtype (e.g. norms in f32)


def _attn_defs(cfg: ModelConfig, lead: Tuple[int, ...] = (),
               lead_log: Tuple[str, ...] = ()) -> Dict[str, ParamDef]:
    h, kv, hd, d = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim, cfg.d_model
    defs = {
        "ln1": ParamDef(lead + (d,), lead_log + ("none",), "ones"),
        "wq": ParamDef(lead + (d, h * hd), lead_log + ("fsdp", "tp")),
        "wk": ParamDef(lead + (d, kv * hd), lead_log + ("fsdp", "tp")),
        "wv": ParamDef(lead + (d, kv * hd), lead_log + ("fsdp", "tp")),
        "wo": ParamDef(lead + (h * hd, d), lead_log + ("tp", "fsdp")),
    }
    if cfg.qkv_bias:
        defs["bq"] = ParamDef(lead + (h * hd,), lead_log + ("tp",), "zeros")
        defs["bk"] = ParamDef(lead + (kv * hd,), lead_log + ("tp",), "zeros")
        defs["bv"] = ParamDef(lead + (kv * hd,), lead_log + ("tp",), "zeros")
    return defs


def _mlp_defs(cfg: ModelConfig, lead: Tuple[int, ...] = (),
              lead_log: Tuple[str, ...] = ()) -> Dict[str, ParamDef]:
    d, ff = cfg.d_model, cfg.d_ff
    return {
        "ln2": ParamDef(lead + (d,), lead_log + ("none",), "ones"),
        "wi": ParamDef(lead + (d, ff), lead_log + ("fsdp", "tp")),
        "wg": ParamDef(lead + (d, ff), lead_log + ("fsdp", "tp")),
        "wo_mlp": ParamDef(lead + (ff, d), lead_log + ("tp", "fsdp")),
    }


def _moe_defs(cfg: ModelConfig, lead: Tuple[int, ...],
              lead_log: Tuple[str, ...]) -> Dict[str, ParamDef]:
    """The ``moe`` family's MLP leaves: the router and the expert stacks,
    each expert's d_ff split over ``expert_shards``."""
    d, ff = cfg.d_model, cfg.d_ff
    e_eff = cfg.n_experts_eff
    ff_s = ff // cfg.expert_shards
    return {
        "ln2": ParamDef(lead + (d,), lead_log + ("none",), "ones"),
        "router": ParamDef(lead + (d, cfg.n_experts), lead_log + ("none", "none")),
        "moe_wi": ParamDef(lead + (e_eff, d, ff_s),
                           lead_log + ("experts", "expert_fsdp", "none")),
        "moe_wg": ParamDef(lead + (e_eff, d, ff_s),
                           lead_log + ("experts", "expert_fsdp", "none")),
        "moe_wo": ParamDef(lead + (e_eff, ff_s, d),
                           lead_log + ("experts", "none", "expert_fsdp")),
    }


def _ssm_defs(cfg: ModelConfig, lead: Tuple[int, ...],
              lead_log: Tuple[str, ...]) -> Dict[str, ParamDef]:
    d, din = cfg.d_model, cfg.d_inner
    gn = cfg.ssm_ngroups * cfg.ssm_state
    nh, k = cfg.ssm_nheads, cfg.ssm_conv
    return {
        "ln": ParamDef(lead + (d,), lead_log + ("none",), "ones"),
        "wz": ParamDef(lead + (d, din), lead_log + ("fsdp", "tp")),
        "wx": ParamDef(lead + (d, din), lead_log + ("fsdp", "tp")),
        "wb": ParamDef(lead + (d, gn), lead_log + ("fsdp", "tp")),
        "wc": ParamDef(lead + (d, gn), lead_log + ("fsdp", "tp")),
        "wdt": ParamDef(lead + (d, nh), lead_log + ("fsdp", "tp")),
        "dt_bias": ParamDef(lead + (nh,), lead_log + ("tp",), "dt_bias"),
        "a_log": ParamDef(lead + (nh,), lead_log + ("tp",), "a_log"),
        "d_skip": ParamDef(lead + (nh,), lead_log + ("tp",), "ones"),
        "conv_x": ParamDef(lead + (din, k), lead_log + ("tp", "none")),
        "conv_b": ParamDef(lead + (gn, k), lead_log + ("tp", "none")),
        "conv_c": ParamDef(lead + (gn, k), lead_log + ("tp", "none")),
        "norm_w": ParamDef(lead + (din,), lead_log + ("tp",), "ones"),
        "wo": ParamDef(lead + (din, d), lead_log + ("tp", "fsdp")),
    }


def param_defs(cfg: ModelConfig) -> Dict[str, Any]:
    """The parameter schema of every family, as the reference's: the layers
    stacked along a leading axis (``hybrid``: the Mamba layers stacked
    (superblock, period), then one shared attention + MLP block)."""
    d, vp, n_layers = cfg.d_model, cfg.padded_vocab, cfg.n_layers
    defs: Dict[str, Any] = {
        # the embedding table is sharded on d (not vocab): token gathers stay
        # local and its gradient comes out d-sharded
        "embed": {"table": ParamDef((vp, d), ("none", "tp"))},
        "lm_head": {"w": ParamDef((d, vp), ("fsdp", "vocab"))},
        "final_norm": ParamDef((d,), ("none",), "ones"),
    }
    lead, lead_log = (n_layers,), ("layers",)
    if cfg.family == "moe":
        defs["layers"] = {**_attn_defs(cfg, lead, lead_log), **_moe_defs(cfg, lead, lead_log)}
    elif cfg.family in ATTENTION_FAMILIES:
        defs["layers"] = {**_attn_defs(cfg, lead, lead_log), **_mlp_defs(cfg, lead, lead_log)}
    elif cfg.family == "ssm":
        defs["layers"] = _ssm_defs(cfg, lead, lead_log)
    elif cfg.family == "hybrid":
        n_sb = n_layers // cfg.hybrid_period
        defs["layers"] = _ssm_defs(cfg, (n_sb, cfg.hybrid_period), ("layers", "layers"))
        defs["shared"] = {**_attn_defs(cfg), **_mlp_defs(cfg)}
    else:
        raise ValueError(f"unknown family {cfg.family!r} ({cfg.name})")
    return defs


def map_defs(fn: Callable[[ParamDef], Any], defs) -> Any:
    if isinstance(defs, ParamDef):
        return fn(defs)
    return {k: map_defs(fn, v) for k, v in defs.items()}


def leaf_dtype(cfg: ModelConfig, d: ParamDef) -> torch.dtype:
    if d.dtype is not None:
        return getattr(torch, d.dtype)
    if d.init in ("ones", "a_log", "dt_bias"):
        return torch.float32  # norms and SSM scalars stay f32
    return getattr(torch, cfg.dtype)


def param_shapes(cfg: ModelConfig):
    """The parameter tree as ``meta`` tensors, each of its leaf's shape and
    dtype: the twin of the reference's ``ShapeDtypeStruct`` tree, nothing
    allocated."""
    return map_defs(lambda d: torch.empty(d.shape, dtype=leaf_dtype(cfg, d), device="meta"),
                    param_defs(cfg))


def param_pspecs(cfg: ModelConfig, rules: ShardingRules, mesh):
    """Each leaf's spec on ``mesh``: its logical names through ``rules``,
    a dim that does not divide replicated (``sharding.spec_for``)."""
    return map_defs(lambda d: spec_for(d.logical, rules, mesh, d.shape), param_defs(cfg))


def param_shardings(cfg: ModelConfig, rules: ShardingRules, mesh):
    """:func:`param_pspecs` as :class:`~repro_torch.models.sharding.NamedSharding`
    leaves (what ``CheckpointManager.restore`` takes)."""
    return map_tree(lambda spec: NamedSharding(mesh, spec), param_pspecs(cfg, rules, mesh))


def cache_pspecs(cfg: ModelConfig, rules: ShardingRules, mesh, b: int, s: int):
    """The specs of the decode cache of ``b`` rows and a budget of ``s``
    positions, in the cache's structure (``{"k", "v"}``, an
    :class:`SsmState`, or the hybrid's ``{"ssm", "attn"}``): the
    reference's ``launch.inputs.cache_specs``, a dim that does not divide
    replicated (``sharding.spec_for``). The attention entries are cut by
    rows over the batch axes and by position over ``"kvseq"``; the SSM
    state's conv entries by channel and ``h`` by head over ``"tp"``."""
    hd = cfg.resolved_head_dim

    def attn(lead, lead_log):
        spec = spec_for(lead_log + ("batch", "kvseq", "none", "none"), rules, mesh,
                        lead + (b, s, cfg.n_kv_heads, hd))
        return {"k": spec, "v": spec}

    def ssm(lead, lead_log):
        km1, gn = cfg.ssm_conv - 1, cfg.ssm_ngroups * cfg.ssm_state

        def conv(width):
            return spec_for(lead_log + ("batch", "none", "tp"), rules, mesh,
                            lead + (b, km1, width))

        return SsmState(conv(cfg.d_inner), conv(gn), conv(gn),
                        spec_for(lead_log + ("batch", "tp", "none", "none"), rules, mesh,
                                 lead + (b, cfg.ssm_nheads, cfg.ssm_headdim, cfg.ssm_state)))

    if cfg.family in ATTENTION_FAMILIES:
        return attn((cfg.n_layers,), ("layers",))
    if cfg.family == "ssm":
        return ssm((cfg.n_layers,), ("layers",))
    if cfg.family == "hybrid":
        n_sb = cfg.n_layers // cfg.hybrid_period
        return {"ssm": ssm((n_sb, cfg.hybrid_period), ("layers", "layers")),
                "attn": attn((n_sb,), ("layers",))}
    raise ValueError(f"unknown family {cfg.family!r} ({cfg.name})")


def shard_params(params, specs, mesh):
    """This rank's block of every leaf of the whole tree ``params`` under
    ``specs``, each a tensor of its own (the whole leaf is not kept)."""
    return map_tree(lambda t, spec: mesh.local_block(t, spec).clone(), params, specs)


def param_count_actual(cfg: ModelConfig) -> int:
    """Parameters in the schema, counted from the shapes alone."""
    total = 0

    def add(d: ParamDef) -> None:
        nonlocal total
        total += math.prod(d.shape)

    map_defs(add, param_defs(cfg))
    return int(total)


def init_params(cfg: ModelConfig, generator: torch.Generator, device="cuda", mesh=None,
                specs=None):
    """Random parameters on ``device`` (``"cuda"`` unless the caller asks for
    the CPU), with the reference's distributions: weights N(0, 1/fan_in) in
    f32 then cast to the model dtype, norms and the skip 1, biases 0,
    ``a_log = log(linspace(1, 16, heads))``, ``dt_bias = -4.6``. Normal
    leaves draw from ``generator`` (which lives on ``device``) in schema
    order. With a ``mesh`` and the tree's ``specs`` every leaf is drawn
    whole, as on one rank, and only this rank's block of it is kept: each
    block holds the bits of the world of one."""
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

    if mesh is None:
        return map_defs(init_one, param_defs(cfg))
    return map_tree(lambda d, spec: mesh.local_block(init_one(d), spec).clone(),
                    param_defs(cfg), specs)


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


def _layers(stacked: Dict[str, torch.Tensor], n: int) -> List[Dict[str, torch.Tensor]]:
    """The ``n`` per-layer parameter dicts of a stacked tree, with one
    ``unbind(0)`` per leaf: under autograd its backward writes each leaf's
    gradient once, where indexing layer i (``t[i]``) would write a
    zero-filled copy of the whole stacked leaf per layer."""
    per = {name: t.unbind(0) for name, t in stacked.items()}
    return [{name: ts[i] for name, ts in per.items()} for i in range(n)]


def gather_params(tree, specs, mesh):
    """Every leaf of ``tree`` (this rank's blocks) whole along each dim its
    spec shards, through :meth:`RankMesh.all_gather
    <repro_torch.launch.mesh.RankMesh.all_gather>` (under grad its backward
    reduce-scatters the gradient back to the block, so each rank's block
    gradient sums every rank's use); a replicated leaf passes as it is."""

    def leaf(t, spec):
        for dim, axes in enumerate(spec):
            if mesh.live_axes(axes):
                t = mesh.all_gather(t, dim, axes)
        return t

    return map_tree(leaf, tree, specs)


# "dots": the matmul outputs are saved, everything else is recomputed (the
# reference's dots_with_no_batch_dims_saveable: 2-D products, no bmm)
DOTS_SAVED = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _maybe_remat(cfg: ModelConfig, fn: Callable, *args):
    """``fn(*args)`` under the rematerialisation that ``cfg.remat`` names,
    as the reference wraps each scan body in ``jax.checkpoint``: ``"none"``
    saves every activation; ``"full"`` (the default) saves only the body's
    inputs and recomputes the rest in the backward pass; ``"dots"`` saves
    the matmul outputs (:data:`DOTS_SAVED`) and recomputes the rest. The
    recomputation reruns the whole body (no early stop): on a mesh it
    reruns each layer's collectives, the data-axes gathers and the model
    axes' activation moves, in the same order on every rank, and
    ``train.step.collective_bytes_per_step`` counts them twice. The
    reference's ``"full"`` keeps the values it names ``ssd_scan_state``
    instead of recomputing them; here they are recomputed with the rest
    (the port's scan sends nothing across ranks: its heads are local)."""
    if cfg.remat == "none":
        return fn(*args)
    if cfg.remat == "full":
        with torch_checkpoint.set_checkpoint_early_stop(False):
            return torch_checkpoint.checkpoint(fn, *args, use_reentrant=False)
    if cfg.remat == "dots":
        context = functools.partial(torch_checkpoint.create_selective_checkpoint_contexts,
                                    list(DOTS_SAVED))
        with torch_checkpoint.set_checkpoint_early_stop(False):
            return torch_checkpoint.checkpoint(fn, *args, use_reentrant=False,
                                               context_fn=context)
    raise ValueError(f"remat must be 'none', 'full' or 'dots', got {cfg.remat!r}")


def _train_stack(cfg: ModelConfig, params, x: torch.Tensor, positions: torch.Tensor,
                 gather: Optional[Callable] = None, layout: Optional[ServeLayout] = None):
    """The blocks of ``mode="train"``: each layer body (each hybrid
    superblock body) under :func:`_maybe_remat`. Returns (hidden, aux).

    ``gather(tree, key)`` (a sharded step's) gathers a layer's leaves over
    the data axes from this rank's blocks; ``key`` names the leaves' place
    in the tree (``"layers"``, ``"shared"``). It runs inside the body, so
    under remat "full" the recomputation gathers again and one layer's
    weights are live at a time, as the reference gathers per layer inside
    its scan. ``layout`` (a model axis above 1) runs each block on the
    mesh, as a prefill does, under autograd."""
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    layers = params["layers"]

    def whole(p, key):
        return p if gather is None else gather(p, key)

    if cfg.family in ATTENTION_FAMILIES:
        def body(x_, p_l):
            x_, _, aux_l = tfm.dense_block(cfg, whole(p_l, "layers"), x_, positions, "train",
                                           layout=layout)
            return x_, aux_l

        for p_l in _layers(layers, cfg.n_layers):
            x, aux_l = _maybe_remat(cfg, body, x, p_l)
            aux = aux + aux_l
    elif cfg.family == "ssm":
        def body_ssm(x_, p_l):
            return tfm.ssm_block(cfg, whole(p_l, "layers"), x_, "train", layout=layout)[0]

        for p_l in _layers(layers, cfg.n_layers):
            x = _maybe_remat(cfg, body_ssm, x, p_l)
    else:  # hybrid
        shared = params["shared"]

        def body_hy(x_, p_sb):
            return tfm.hybrid_superblock(cfg, whole(p_sb, "layers"), whole(shared, "shared"),
                                         x_, positions, "train", layout=layout)[0]

        for p_sb in _layers(layers, cfg.n_layers // cfg.hybrid_period):
            x = _maybe_remat(cfg, body_hy, x, p_sb)
    return x, aux


def _serve_blocks(cfg: ModelConfig, params, x: torch.Tensor, positions: torch.Tensor,
                  mode: str, cache, pos: Optional[int], whole: Optional[Callable] = None,
                  layout: Optional[ServeLayout] = None):
    """The blocks of a prefill or a decode step: (hidden, cache, aux).
    ``whole(tree, key)`` (a mesh's) gathers a layer's blocks over the data
    axes; ``layout`` runs each block on the mesh."""
    decode = mode == "decode"
    layers = params["layers"]
    aux = torch.zeros((), dtype=torch.float32, device=x.device)

    def full(p, key):
        return p if whole is None else whole(p, key)

    if cfg.family in ATTENTION_FAMILIES:
        ks, vs = [], []
        for i, p_l in enumerate(_layers(layers, cfg.n_layers)):
            cache_l = {n: cache[n][i] for n in ("k", "v")} if decode else None
            x, new_cache, aux_l = tfm.dense_block(cfg, full(p_l, "layers"), x, positions, mode,
                                                  cache_l, pos, layout=layout)
            aux = aux + aux_l
            if not decode:
                ks.append(new_cache["k"])
                vs.append(new_cache["v"])
        if not decode:
            cache = {"k": torch.stack(ks), "v": torch.stack(vs)}
    elif cfg.family == "ssm":
        states = []
        for i, p_l in enumerate(_layers(layers, cfg.n_layers)):
            st = SsmState(*(t[i] for t in cache)) if decode else None
            x, new_state = tfm.ssm_block(cfg, full(p_l, "layers"), x, mode, st,
                                         layout=layout)
            if decode:
                for slot, new in zip(st, new_state):
                    slot.copy_(new)
            else:
                states.append(new_state)
        if not decode:
            cache = SsmState(*(torch.stack(t) for t in zip(*states)))
    else:  # hybrid
        shared = full(params["shared"], "shared")
        n_sb = cfg.n_layers // cfg.hybrid_period
        states, ks, vs = [], [], []
        for i, p_sb in enumerate(_layers(layers, n_sb)):
            ssm_in = SsmState(*(t[i] for t in cache["ssm"])) if decode else None
            attn_in = {n: cache["attn"][n][i] for n in ("k", "v")} if decode else None
            x, new_states, new_attn = tfm.hybrid_superblock(
                cfg, full(p_sb, "layers"), shared, x, positions, mode, ssm_in, attn_in, pos,
                layout=layout)
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


def run_stack(cfg: ModelConfig, params, tokens: Optional[torch.Tensor] = None,
              embeds: Optional[torch.Tensor] = None, mode: str = "prefill", cache=None,
              pos: Optional[int] = None, *, mesh=None, rules: ShardingRules = DEFAULT_RULES):
    """Embedding (or ``embeds``) and every block; returns (hidden, cache,
    aux_loss): the f32 sum of the ``moe`` blocks' load-balance losses, 0
    for the other families.

    ``mode="train"`` runs the full sequence with no cache (returns None for
    it), differentiably, each layer body rematerialised as ``cfg.remat``
    says (:func:`_maybe_remat`).

    ``mode="prefill"`` returns the new cache, the reference's layout: for
    ``dense``, ``moe``, ``audio`` and ``vlm`` ``{"k", "v"}`` stacked (L, b, s, kv,
    hd) in bf16; for ``ssm`` an :class:`SsmState` of tensors stacked over
    the L layers; for ``hybrid`` ``{"ssm": SsmState`` stacked (superblock,
    period, ...), ``"attn": {"k", "v"}`` stacked (superblock, b, s, kv,
    hd)``}``. ``mode="decode"`` takes such a cache grown to the serving
    length, writes this token's entries into it in place, and returns it.
    The layers run as a Python loop. The LM head is the caller's.

    On a ``mesh`` of more than one rank (a prefill or a decode step; see
    the module's docstring) ``tokens`` / ``embeds`` are the whole batch,
    ``params`` this rank's blocks under ``param_pspecs(cfg, rules, mesh)``
    and ``cache`` this rank's blocks; the hidden state returned is this
    rank's block of the residual (its rows, and its positions where they
    are cut over the model axes).
    """
    check_ported(cfg)
    if mode not in MODES:
        raise ValueError(f"mode must be one of {MODES}, got {mode!r}")
    decode = mode == "decode"
    if decode and (cache is None or pos is None):
        raise ValueError("decode needs the cache and the position")
    if on_mesh(mesh):
        if mode == "train":
            raise ValueError("run_stack on a mesh takes the whole batch (prefill, decode); a "
                             "train step on a mesh takes this rank's rows through "
                             "make_loss_fn(cfg, mesh, rules), which runs the same blocks")
        return _stack_on_mesh(cfg, params, tokens, embeds, mode, cache, pos, mesh, rules)[:3]
    x = _embed(cfg, params, tokens, embeds)
    if decode:
        positions = torch.full((1,), pos, dtype=torch.int32, device=x.device)
    else:
        positions = torch.arange(x.shape[1], dtype=torch.int32, device=x.device)
    if mode == "train":
        x, aux = _train_stack(cfg, params, x, positions)
        return x, None, aux
    return _serve_blocks(cfg, params, x, positions, mode, cache, pos)


def _data_only(spec, model: Tuple[str, ...]):
    """``spec`` without the model axes: what a layer gathers over the data
    axes, leaving its model-parallel blocks cut."""
    out = []
    for axes in spec:
        kept = tuple(a for a in axes_tuple(axes) if a not in model)
        out.append(None if not kept else kept[0] if len(kept) == 1 else kept)
    return tuple(out)


def _stack_on_mesh(cfg: ModelConfig, params, tokens, embeds, mode: str, cache, pos, mesh,
                   rules: ShardingRules):
    """:func:`run_stack` on a mesh: (hidden block, cache blocks, aux, the
    call's :class:`ServeLayout`, the top leaves gathered over the data
    axes)."""
    check_serving_mesh(cfg, mesh, rules)
    src = embeds if embeds is not None else tokens
    if src is None:
        raise ValueError("run_stack needs tokens or embeds")
    b, s = src.shape[0], src.shape[1]
    lay = ServeLayout.build(mesh, rules, b, s)
    specs = map_tree(lambda spec: _data_only(spec, lay.model), param_pspecs(cfg, rules, mesh))
    top = {k: gather_params(params[k], specs[k], mesh) for k in TOP_LEAVES}
    # a layer's leaves lose the stacked "layers" dim (hybrid: its first)
    inner = {"layers": map_tree(lambda spec: spec[1:], specs["layers"]),
             "shared": specs.get("shared")}
    x = _embed_on_mesh(cfg, lay, top, tokens, embeds)
    dev = x.device
    if mode == "decode":
        positions = torch.full((1,), pos, dtype=torch.int32, device=dev)
    else:
        positions = torch.arange(s, dtype=torch.int32, device=dev)
    x, cache, aux = _serve_blocks(
        cfg, params, x, positions, mode, cache, pos,
        whole=lambda p, key: gather_params(p, inner[key], mesh), layout=lay)
    return x, cache, aux, lay, top


def _embed_on_mesh(cfg: ModelConfig, lay: ServeLayout, top, tokens, embeds,
                   own_rows: bool = False) -> torch.Tensor:
    """The residual's block from the whole batch (``own_rows``: from this
    rank's rows, a train step's): ``embeds`` cut to this rank's rows and
    positions, or the tokens looked up in this rank's ``("none", "tp")``
    block of the table (its columns of d, at every position) and turned
    into the residual's layout by an all-to-all (positions cut) or an
    all-gather (not cut)."""
    src = embeds if embeds is not None else tokens
    r0, r1 = (0, src.shape[0]) if own_rows else lay.rows(src.shape[0])
    p0, p1 = lay.positions()
    if embeds is not None:
        return embeds[r0:r1, p0:p1].to(getattr(torch, cfg.dtype))
    table = top["embed"]["table"]
    if not lay.cut(cfg.d_model):
        return table[tokens[r0:r1, p0:p1]]
    cols = table[tokens[r0:r1]]  # (b, s, d / n)
    if lay.seq:
        return lay.mesh.all_to_all(cols, 1, 2, lay.model)
    return lay.mesh.all_gather(cols, 2, lay.model)


def _logits_on_mesh(cfg: ModelConfig, lay: ServeLayout, top, x: torch.Tensor) -> torch.Tensor:
    """The whole logits (b, s_x, Vp) on every rank from this rank's rows
    ``x`` (b_rows, s_x, d): its ``("fsdp", "vocab")`` block of the head
    (vocab-parallel), then the vocabulary's blocks and the rows gathered."""
    logits = lay.whole_cols(_lm_head(cfg, top, x), cfg.padded_vocab)
    return lay.whole_rows(logits)

def forward(cfg: ModelConfig, params, tokens: Optional[torch.Tensor] = None,
            embeds: Optional[torch.Tensor] = None, mode: str = "prefill", cache=None,
            pos: Optional[int] = None):
    """Full-logits forward. Returns (logits, cache, aux). ``mode="train"``
    is differentiable; prefill and decode run under ``torch.no_grad()``."""
    if mode == "train":
        x, new_cache, aux = run_stack(cfg, params, tokens, embeds, mode, cache, pos)
        return _lm_head(cfg, params, x), new_cache, aux
    with torch.no_grad():
        x, new_cache, aux = run_stack(cfg, params, tokens, embeds, mode, cache, pos)
        return _lm_head(cfg, params, x), new_cache, aux


# ---------------------------------------------------------------------------
# Loss (chunked cross-entropy: bounds live logits to seq/LOSS_CHUNKS)
# ---------------------------------------------------------------------------

LOSS_CHUNKS = 8
AUX_WEIGHT = 0.01


def loss_from_hidden(cfg: ModelConfig, params, x: torch.Tensor, labels: torch.Tensor,
                     aux: torch.Tensor) -> torch.Tensor:
    """The mean cross-entropy of the LM head on ``x`` (b, s, d) against
    ``labels`` (b, s), over ``LOSS_CHUNKS`` sequence chunks (one when s does
    not divide), each chunk's (b, s/8, Vp) logits formed alone, plus
    ``AUX_WEIGHT`` x the MoE aux loss."""
    s = x.shape[1]
    chunks = LOSS_CHUNKS if (s % LOSS_CHUNKS == 0 and s >= LOSS_CHUNKS) else 1
    cs = s // chunks
    total = torch.zeros((), dtype=torch.float32, device=x.device)
    for c in range(chunks):
        logits_c = _lm_head(cfg, params, x[:, c * cs:(c + 1) * cs])
        total = total + softmax_cross_entropy(logits_c, labels[:, c * cs:(c + 1) * cs],
                                              cfg.vocab_size)
    return total / chunks + AUX_WEIGHT * aux


TOP_LEAVES = ("embed", "lm_head", "final_norm")  # gathered once a step


def make_loss_fn(cfg: ModelConfig, mesh=None, rules: ShardingRules = RULES_TRAIN):
    """``loss_fn(params, {"tokens" or "embeds", "labels"}) -> the f32 loss``,
    differentiable in the params.

    On a ``mesh`` of more than one rank the params are this rank's blocks
    under :func:`param_pspecs` (``rules``) and the batch this rank's rows
    (cut over the batch axes, the same rows on every model coordinate). A
    call lays itself out as a prefill of its (b, s) does
    (:class:`ServeLayout`, the rows counted over the batch axes): every
    leaf is gathered over the data axes only, ``embed`` and ``final_norm``
    once a step and the layers' leaves inside each layer's body
    (:func:`_train_stack`), and ``lm_head`` is gathered whole, over the
    model axes too; each gradient goes back to its block through the
    gathers' backward. With a model axis above 1 the blocks run on the mesh
    as a prefill's do (tensor-, sequence-, context- and expert-parallel,
    the Mamba-2 layers over their heads), under autograd, the embedding
    through :func:`_embed_on_mesh`, and the loss is the mean over this
    rank's rows and its positions of the residual. Each rank's loss is its
    own mean: ``train.step`` scales it by 1 / ``mesh.size``, so that the
    ranks' scaled losses sum to the global mean (a cut row or position
    counts on one rank; a replicated one 1 / n on each of n)."""
    check_ported(cfg)
    if not on_mesh(mesh):
        def loss_fn(params, batch):
            x = _embed(cfg, params, batch.get("tokens"), batch.get("embeds"))
            positions = torch.arange(x.shape[1], dtype=torch.int32, device=x.device)
            x, aux = _train_stack(cfg, params, x, positions)
            return loss_from_hidden(cfg, params, x, batch["labels"], aux)

        return loss_fn
    specs = param_pspecs(cfg, rules, mesh)
    batch_axes = mesh.live_axes(_resolve_axes(rules.table().get("batch"), mesh))

    def loss_fn(params, batch):
        tokens, embeds = batch.get("tokens"), batch.get("embeds")
        src = embeds if embeds is not None else tokens
        b, s = src.shape[0], src.shape[1]
        lay = ServeLayout.build(mesh, rules, b * mesh.axes_size(batch_axes), s)
        data = map_tree(lambda spec: _data_only(spec, lay.model), specs)
        top = {k: gather_params(params[k], (specs if k == "lm_head" else data)[k], mesh)
               for k in TOP_LEAVES}
        # a layer's leaves lose the stacked "layers" dim (hybrid: its first)
        inner = {"layers": map_tree(lambda spec: spec[1:], data["layers"]),
                 "shared": data.get("shared")}
        tp = lay if lay.n > 1 else None
        if tp is None:
            x = _embed(cfg, top, tokens, embeds)
        else:
            x = _embed_on_mesh(cfg, lay, top, tokens, embeds, own_rows=True)
        positions = torch.arange(s, dtype=torch.int32, device=x.device)
        x, aux = _train_stack(cfg, params, x, positions,
                              lambda p, key: gather_params(p, inner[key], mesh), tp)
        p0, p1 = lay.positions()
        return loss_from_hidden(cfg, top, x, batch["labels"][:, p0:p1], aux)

    return loss_fn


def make_prefill_step(cfg: ModelConfig, mesh=None, rules: ShardingRules = DEFAULT_RULES):
    """``prefill_step(params, {"tokens": (b, s)} or {"embeds": (b, s, d)})
    -> (last-token logits (b, Vp), cache)``. On a ``mesh`` of more than one
    rank (see :func:`run_stack`): the whole batch in, the whole last-token
    logits on every rank, this rank's blocks of the cache (its rows and its
    positions)."""
    check_serving_mesh(cfg, mesh, rules)

    @torch.no_grad()
    def prefill_step(params, batch):
        if not on_mesh(mesh):
            x, cache, _ = run_stack(cfg, params, batch.get("tokens"), batch.get("embeds"),
                                    "prefill")
            return _lm_head(cfg, params, x[:, -1:, :])[:, 0, :], cache
        x, cache, _, lay, top = _stack_on_mesh(cfg, params, batch.get("tokens"),
                                               batch.get("embeds"), "prefill", None, None,
                                               mesh, rules)
        last = x[:, -1:, :]
        if lay.seq:  # the last position is the last block's
            last = lay.mesh.all_gather(last, 1, lay.model)[:, -1:, :]
        return _logits_on_mesh(cfg, lay, top, last)[:, 0, :], cache

    return prefill_step


def make_serve_step(cfg: ModelConfig, mesh=None, rules: ShardingRules = DEFAULT_RULES):
    """``serve_step(params, cache, {"token": (b, 1) or "embed": (b, 1, d),
    "pos": int}) -> (logits (b, Vp), cache)``; the cache is updated in
    place. On a ``mesh`` of more than one rank (see :func:`run_stack`): the
    whole batch in, the whole logits on every rank; ``cache`` is this
    rank's rows and, over the model axes, its block of the budget's
    positions (``Engine._pad_cache`` lays it out)."""
    check_serving_mesh(cfg, mesh, rules)

    @torch.no_grad()
    def serve_step(params, cache, batch):
        pos = int(batch["pos"])
        if not on_mesh(mesh):
            x, cache, _ = run_stack(cfg, params, batch.get("token"), batch.get("embed"),
                                    "decode", cache, pos)
            return _lm_head(cfg, params, x)[:, -1, :], cache
        x, cache, _, lay, top = _stack_on_mesh(cfg, params, batch.get("token"),
                                               batch.get("embed"), "decode", cache, pos, mesh,
                                               rules)
        return _logits_on_mesh(cfg, lay, top, x)[:, -1, :], cache

    return serve_step
