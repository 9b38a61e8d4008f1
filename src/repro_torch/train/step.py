"""Train-step factory: loss -> grads -> AdamW. Port of ``repro.train.step``.

On a mesh of more than one rank (``("data", "model")`` or ``("pod",
"data", "model")``, any axis sizes) the step is ZeRO-3 data parallel over
the data axes and tensor-, sequence- and expert-parallel over the model
axis, as the reference's ``make_train_step(cfg, mesh, RULES_TRAIN)``:

  * each rank holds its block of every parameter (:func:`param_pspecs`
    under ``rules``: ``fsdp`` over the data axes, ``tp`` / ``vocab`` /
    ``experts`` over the model axis), of the master copy and of both
    moments (the ZeRO specs, ``adamw.opt_pspecs``), and takes its rows of
    the batch (the same rows on every model coordinate);
  * the loss (``model.make_loss_fn``) gathers each layer's leaves over the
    data axes inside the layer's body and runs the blocks on the mesh;
    this rank's mean loss enters the backward scaled by 1 / ``mesh.size``,
    so that the ranks' scaled losses sum to the global mean loss (a cut row
    or position counts on one rank, a replicated one 1 / n on each of n
    ranks), and every collective's backward is its adjoint
    (``launch.mesh``);
  * each gradient is then summed over every mesh axis its parameter spec
    does not cut and cut to its ZeRO block: over the data axes that cut
    the leaf the gather's backward did both; an axis the ZeRO spec adds
    reduce-scatters; every other axis (the model axis of a leaf it does not
    cut, the data axes of a leaf they do not cut) all-reduces; every sum in
    the gradient's dtype, as the reference's reduce-scatter runs before its
    f32 upcast;
  * AdamW updates the blocks, and the new compute parameters (the master
    cast to each leaf's dtype) are all-gathered back to their own spec.

A mesh of one rank is the step of ``mesh=None``, bit for bit; on a model
axis of 1 the blocks run unsharded (no layout), as a data-parallel step.
"""
from __future__ import annotations

import math
from typing import Callable, Dict, Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import mamba2
from repro_torch.models import model as model_lib
from repro_torch.models import moe as moe_lib
from repro_torch.models.sharding import (RULES_TRAIN, NamedSharding, ServeLayout, ShardingRules,
                                         _resolve_axes, axes_tuple)
from repro_torch.optim import adamw


def make_train_step(cfg: ModelConfig, opt_cfg: adamw.AdamWConfig = adamw.AdamWConfig(),
                    mesh=None, rules: ShardingRules = RULES_TRAIN) -> Callable:
    """``train_step(params, opt_state, batch) -> (params, opt_state,
    metrics)``: the loss of :func:`repro_torch.models.model.make_loss_fn`,
    its gradient in every parameter (a parameter the loss does not reach,
    such as the embedding table of a model fed ``embeds``, gets zeros, as
    ``jax.grad`` gives), then one :func:`adamw.apply`. ``metrics`` holds
    ``loss``, ``grad_norm`` and ``lr`` as 0-d f32 tensors. ``batch`` holds
    tensors on the params' device.

    On a ``mesh`` of more than one rank (see the module's docstring),
    ``params`` and ``opt_state`` are this rank's blocks and ``batch`` its
    rows; ``loss`` is the mean over the ranks."""
    if mesh is not None and mesh.size > 1:
        return _make_sharded_step(cfg, opt_cfg, mesh, rules)
    loss_fn = model_lib.make_loss_fn(cfg)

    def train_step(params, opt_state: adamw.OptState, batch):
        flat = [p.detach().requires_grad_() for p in adamw.leaves(params)]
        with torch.enable_grad():
            loss = loss_fn(adamw.rebuild(params, flat), batch)
            grads = torch.autograd.grad(loss, flat, allow_unused=True, materialize_grads=True)
        del flat
        params, opt_state, metrics = adamw.apply(opt_cfg, adamw.rebuild(params, list(grads)),
                                                 opt_state)
        metrics["loss"] = loss.detach()
        return params, opt_state, metrics

    return train_step


def grad_moves(pspec, zspec, mesh):
    """A gradient's way from this rank's parameter block under ``pspec`` to
    its ZeRO block under ``zspec``: ``(scatters, sums)``, the ``(dim,
    axes)`` each axis set the ZeRO spec adds is reduce-scattered along, and
    the live axes that cut neither spec, all-reduced together (none of the
    data axes that cut the leaf: its gather's backward summed over them)."""
    scatters = [(dim, z) for dim, (p, z) in enumerate(zip(pspec, zspec))
                if p != z and mesh.live_axes(z)]
    cut = {a for axes in zspec for a in axes_tuple(axes)}
    sums = tuple(a for a in mesh.axis_names if mesh.shape[a] > 1 and a not in cut)
    return scatters, sums


def _make_sharded_step(cfg, opt_cfg, mesh, rules):
    loss_fn = model_lib.make_loss_fn(cfg, mesh, rules)
    pspecs = model_lib.param_pspecs(cfg, rules, mesh)
    zspecs = adamw.opt_pspecs(pspecs, model_lib.param_shapes(cfg), mesh, rules).master
    moves = [grad_moves(ps, zs, mesh) for ps, zs in zip(adamw.leaves(pspecs),
                                                          adamw.leaves(zspecs))]

    def train_step(params, opt_state: adamw.OptState, batch):
        flat = [p.detach().requires_grad_() for p in adamw.leaves(params)]
        with torch.enable_grad():
            loss = loss_fn(adamw.rebuild(params, flat), batch)
            grads = torch.autograd.grad(loss * (1.0 / mesh.size), flat, allow_unused=True,
                                        materialize_grads=True)
        del flat
        zgrads = []
        for g, (scatters, sums) in zip(grads, moves):
            for dim, axes in scatters:
                g = mesh.reduce_scatter(g, dim, axes)
            if sums:
                g = mesh.all_reduce(g, sums)
            zgrads.append(g)
        del grads
        blocks, opt_state, metrics = adamw.apply(opt_cfg, adamw.rebuild(params, zgrads),
                                                 opt_state, mesh, zspecs)
        new = []
        for b, (scatters, _) in zip(adamw.leaves(blocks), moves):
            for dim, axes in reversed(scatters):
                b = mesh.all_gather(b, dim, axes)
            new.append(b)
        metrics["loss"] = mesh.all_reduce(loss.detach()) / mesh.size
        return adamw.rebuild(params, new), opt_state, metrics

    return train_step


def train_state_shapes(cfg: ModelConfig):
    """``(params, OptState)`` as ``(shape, dtype)`` leaves: the schema's, and
    f32 for the master copy and the moments, int32 for the count. Nothing
    is allocated."""
    meta = model_lib.param_shapes(cfg)
    pshapes = adamw.map_tree(lambda t: (tuple(t.shape), t.dtype), meta)
    f32 = adamw.map_tree(lambda t: (tuple(t.shape), torch.float32), meta)
    return pshapes, adamw.OptState(master=f32, mu=f32, nu=f32, count=((), torch.int32))


def train_state_specs(cfg: ModelConfig, mesh, rules: ShardingRules = RULES_TRAIN):
    """``(shapes, shardings)`` of ``(params, OptState)``: the whole shapes
    of :func:`train_state_shapes`, and the
    :class:`~repro_torch.models.sharding.NamedSharding` of every leaf on
    ``mesh`` (the parameters' specs, and the ZeRO specs of the state),
    what ``CheckpointManager.restore(shardings=...)`` takes."""
    pspecs = model_lib.param_pspecs(cfg, rules, mesh)
    ospecs = adamw.opt_pspecs(pspecs, model_lib.param_shapes(cfg), mesh, rules)
    named = lambda tree: adamw.map_tree(lambda spec: NamedSharding(mesh, spec), tree)  # noqa: E731
    oshard = adamw.OptState(master=named(ospecs.master), mu=named(ospecs.mu),
                            nu=named(ospecs.nu), count=NamedSharding(mesh, ()))
    return train_state_shapes(cfg), (named(pspecs), oshard)


KINDS = ("all_gather", "reduce_scatter", "all_reduce", "all_to_all")
# the kind of each collective's backward (its adjoint)
ADJOINT = {"all_gather": "reduce_scatter", "reduce_scatter": "all_gather",
           "all_reduce": "all_reduce", "all_to_all": "all_to_all"}


def _moves() -> Dict[str, int]:
    return dict.fromkeys(KINDS, 0)


def _partial(out: Dict[str, int], lay: ServeLayout, nbytes: int) -> None:
    """``ServeLayout.reduce_partial`` of ``nbytes``."""
    out["reduce_scatter" if lay.seq else "all_reduce"] += nbytes


def _attention_moves(cfg: ModelConfig, lay: ServeLayout, b: int, es: int) -> Dict[str, int]:
    """The forward payloads of ``transformer._attention_on_mesh`` at a
    train call (``b`` rows, ``lay.s`` positions), its branches taken as it
    takes them."""
    out, s, d, n = _moves(), lay.s, cfg.d_model, lay.n
    qn, kvn = cfg.n_heads * cfg.resolved_head_dim, cfg.n_kv_heads * cfg.resolved_head_dim
    if lay.seq:
        out["all_gather"] += b * s * d * es  # the normed input at every position
    if lay.cut(kvn):
        out["all_gather"] += 2 * b * s * kvn * es  # K and V whole
    if cfg.attn_partitioning == "hp" and lay.cut(cfg.n_heads):
        _partial(out, lay, b * s * d * es)
    elif cfg.attn_partitioning == "hp" or not (lay.seq and lay.cut(qn)):
        if lay.cut(qn):
            out["all_gather"] += b * s * qn * es
            _partial(out, lay, b * s * d * es)
    else:  # "cp": q's columns to rows, the output back
        out["all_to_all"] += 2 * b * s * (qn // n) * es
        _partial(out, lay, b * s * d * es)
    return out


def _mlp_moves(cfg: ModelConfig, lay: ServeLayout, b: int, es: int) -> Dict[str, int]:
    """``transformer._swiglu_on_mesh``, or the MoE block's all-to-alls and
    its aux loss's f32 all-reduce."""
    out, s, d = _moves(), lay.s, cfg.d_model
    if cfg.family == "moe":
        s_loc = s // lay.n if lay.seq else s
        if any(a in lay.batch or (lay.seq and a in lay.model) for a in lay.mesh.axis_names):
            out["all_reduce"] += 4
        cap = moe_lib._capacity(b * s_loc, cfg)
        out["all_to_all"] += 2 * cfg.n_experts_eff * cap * d * es
    elif lay.cut(cfg.d_ff):
        if lay.seq:
            out["all_gather"] += b * s * d * es
        _partial(out, lay, b * s * d * es)
    return out


def _mixer_moves(cfg: ModelConfig, lay: ServeLayout, b: int, es: int) -> Dict[str, int]:
    """``mamba2._mixer_on_mesh``: the heads cut (B and C whole after the
    conv, the gated norm's f32 sum of squares, ``wo``'s partial products),
    or every cut leaf of the layer gathered whole."""
    out, s, d = _moves(), lay.s, cfg.d_model
    if lay.seq:
        out["all_gather"] += b * s * d * es
    gn = cfg.ssm_ngroups * cfg.ssm_state
    if lay.cut(cfg.ssm_nheads):
        chunk = min(cfg.ssm_chunk, s)
        s_pad = -(-s // chunk) * chunk
        if lay.cut(gn):
            out["all_gather"] += 2 * b * s_pad * gn * es
        out["all_reduce"] += b * s * 4
        _partial(out, lay, b * s * d * es)
        return out
    defs = model_lib._ssm_defs(cfg, (), ())
    for name, width in mamba2._tp_widths(cfg).items():
        if lay.cut(width):
            leaf = defs[name]
            out["all_gather"] += (math.prod(leaf.shape)
                                  * model_lib.leaf_dtype(cfg, leaf).itemsize)
    if lay.cut(cfg.d_inner):
        _partial(out, lay, b * s * d * es)
    return out


def _add(out: Dict[str, int], moves: Dict[str, int], times: int = 1) -> None:
    for k, v in moves.items():
        out[k] += v * times


def _activation_bytes(cfg: ModelConfig, lay: ServeLayout, b: int) -> Dict[str, int]:
    """The model axes' activation moves of one step: each layer body's
    forward, again in the remat recomputation, and each move's adjoint in
    the backward; the embedding's once each way."""
    es = getattr(torch, cfg.dtype).itemsize
    body = _moves()
    if cfg.family in model_lib.ATTENTION_FAMILIES:
        _add(body, _attention_moves(cfg, lay, b, es), cfg.n_layers)
        _add(body, _mlp_moves(cfg, lay, b, es), cfg.n_layers)
    elif cfg.family == "ssm":
        _add(body, _mixer_moves(cfg, lay, b, es), cfg.n_layers)
    else:  # hybrid: period Mamba layers and the shared block a superblock
        n_sb = cfg.n_layers // cfg.hybrid_period
        _add(body, _mixer_moves(cfg, lay, b, es), cfg.n_layers)
        _add(body, _attention_moves(cfg, lay, b, es), n_sb)
        _add(body, _mlp_moves(cfg, lay, b, es), n_sb)
    top = _moves()
    if cfg.frontend == "none" and lay.cut(cfg.d_model):  # the table's columns to the residual
        if lay.seq:
            top["all_to_all"] += b * lay.s * (cfg.d_model // lay.n) * es
        else:
            top["all_gather"] += b * lay.s * cfg.d_model * es
    out = _moves()
    _add(out, body, 2 if cfg.remat in ("full", "dots") else 1)
    _add(out, top)
    for k in KINDS:
        out[ADJOINT[k]] += body[k] + top[k]
    return out


def _gathers(numel: int, spec, mesh) -> int:
    """The elements all-gathered making a leaf whole along each dim
    ``spec`` cuts, in dim order, from its block of ``numel``."""
    total = 0
    for axes in spec:
        if mesh.live_axes(axes):
            numel *= mesh.axes_size(axes)
            total += numel
    return total


def collective_bytes_per_step(cfg: ModelConfig, mesh, rules: ShardingRules = RULES_TRAIN,
                              batch: Optional[int] = None, seq: Optional[int] = None
                              ) -> Dict[str, int]:
    """The payload one sharded step hands each collective, by kind
    (``RankMesh.counters``' units: the whole tensor an all-gather returns,
    a reduce-scatter takes, an all-reduce reduces or an all-to-all sends),
    counted from the specs and shapes alone.

    Parameters: each layer leaf's gathers over the data axes (one in the
    forward, one more in the remat "full" or "dots" recomputation, the
    hybrid's shared leaves once a superblock) and each gather's
    reduce-scatter in the backward; ``embed`` and ``final_norm`` gathered
    over the data axes and ``lm_head`` whole once a step; each gradient's
    moves to its ZeRO block (:func:`grad_moves`) and the all-gathers back
    after the update; the norm's and the loss's f32 partials all-reduced.
    With a model axis above 1 (``batch``, the global batch, and ``seq``
    needed): every activation move of the blocks on the mesh, forward,
    recomputation and backward (each move's adjoint), and the embedding's
    (:func:`_activation_bytes`)."""
    if mesh.size == 1:
        return _moves()
    pspecs = model_lib.param_pspecs(cfg, rules, mesh)
    shapes = model_lib.param_shapes(cfg)
    zspecs = adamw.opt_pspecs(pspecs, shapes, mesh, rules).master
    n_batch = mesh.axes_size(mesh.live_axes(_resolve_axes(rules.table().get("batch"), mesh)))
    rows = batch // n_batch if batch is not None and batch % n_batch == 0 else batch
    lay = ServeLayout.build(mesh, rules, (rows or 1) * n_batch, seq or 1)  # as the loss lays out
    if lay.n > 1 and (batch is None or seq is None):
        raise ValueError("a model axis above 1 moves activations: pass the global batch and seq")
    gathers = 2 if cfg.remat in ("full", "dots") else 1
    n_sb = cfg.n_layers // cfg.hybrid_period if cfg.family == "hybrid" else 1
    out = _moves()
    out["all_reduce"] = 8  # the norm, the loss
    for key in sorted(pspecs):
        uses = n_sb if key == "shared" else 1  # the shared block: once a superblock
        per = 1 if key in model_lib.TOP_LEAVES else gathers
        for ps, zs, t in zip(adamw.leaves(pspecs[key]), adamw.leaves(zspecs[key]),
                             adamw.leaves(shapes[key])):
            es = t.element_size()
            block = t.numel() // math.prod(mesh.axes_size(mesh.live_axes(a)) for a in ps)
            gather_spec = ps if key == "lm_head" else model_lib._data_only(ps, lay.model)
            g = _gathers(block, gather_spec, mesh) * es
            out["all_gather"] += g * uses * per
            out["reduce_scatter"] += g * uses
            scatters, sums = grad_moves(ps, zs, mesh)
            zblock = block * es
            for _, axes in scatters:
                out["reduce_scatter"] += zblock
                zblock //= mesh.axes_size(mesh.live_axes(axes))
            if sums:
                out["all_reduce"] += zblock
            for _, axes in scatters:
                zblock *= mesh.axes_size(mesh.live_axes(axes))
                out["all_gather"] += zblock
    if lay.n > 1:
        _add(out, _activation_bytes(cfg, lay, rows))
    return out
