"""Train-step factory: loss -> grads -> AdamW. Port of ``repro.train.step``.

On a mesh of more than one rank (the data axes of the reference's host
mesh; the model axis stays 1) the step is ZeRO-3 data parallel:

  * each rank holds its block of every parameter (:func:`param_pspecs`
    under ``rules``), of the master copy and of both moments (the ZeRO
    specs, ``adamw.opt_pspecs``), and takes its rows of the batch;
  * the loss gathers each layer's weights inside the layer's body
    (``model.make_loss_fn``); this rank's mean loss is scaled by
    1 / |batch axes|, so that the sums over the ranks give the gradient of
    the global mean loss;
  * each gradient moves to its ZeRO block: a gathered leaf's is already
    there (the gather's backward reduce-scatters it), a replicated leaf
    with a sharded ZeRO spec is reduce-scattered, a leaf replicated both
    ways is all-reduced; every sum in the gradient's dtype, as the
    reference's reduce-scatter runs before its f32 upcast;
  * AdamW updates the blocks, and the new compute parameters (the master
    cast to each leaf's dtype) are all-gathered back to their own spec.

A mesh of one rank is the step of ``mesh=None``, bit for bit.
"""
from __future__ import annotations

from typing import Callable, Dict

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import model as model_lib
from repro_torch.models.sharding import RULES_TRAIN, NamedSharding, ShardingRules, _resolve_axes
from repro_torch.optim import adamw


def _check_mesh(mesh) -> None:
    live = [a for a in mesh.axis_names if a not in ("pod", "data") and mesh.shape[a] > 1]
    if live:
        raise ValueError(f"the sharded train step runs on the data axes only; the axes {live} "
                         f"of {mesh.shape} are above 1 (a model axis is not ported yet)")


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


def _sharded_dim(spec, mesh):
    """(dim, axes) of the one dim ``spec`` shards over live axes, or None."""
    dims = [(d, axes) for d, axes in enumerate(spec) if mesh.live_axes(axes)]
    if len(dims) > 1:
        raise ValueError(f"spec {spec} shards more than one dim")
    return dims[0] if dims else None


def _make_sharded_step(cfg, opt_cfg, mesh, rules):
    _check_mesh(mesh)
    loss_fn = model_lib.make_loss_fn(cfg, mesh, rules)
    pspecs = model_lib.param_pspecs(cfg, rules, mesh)
    zspecs = adamw.opt_pspecs(pspecs, model_lib.param_shapes(cfg), mesh, rules).master
    flat_p = adamw.leaves(pspecs)
    flat_z = adamw.leaves(zspecs)
    batch_size = mesh.axes_size(_resolve_axes(rules.table()["batch"], mesh))
    # each leaf's move to its ZeRO block: "gathered" (the gather's backward
    # did it), ("scatter", dim, axes), or "all_reduce"
    moves = []
    for ps, zs in zip(flat_p, flat_z):
        if _sharded_dim(ps, mesh) is not None:
            moves.append("gathered")
        elif _sharded_dim(zs, mesh) is not None:
            moves.append(("scatter",) + _sharded_dim(zs, mesh))
        else:
            moves.append("all_reduce")

    def train_step(params, opt_state: adamw.OptState, batch):
        flat = [p.detach().requires_grad_() for p in adamw.leaves(params)]
        with torch.enable_grad():
            loss = loss_fn(adamw.rebuild(params, flat), batch)
            grads = torch.autograd.grad(loss * (1.0 / batch_size), flat, allow_unused=True,
                                        materialize_grads=True)
        del flat
        zgrads = []
        for g, move in zip(grads, moves):
            if move == "all_reduce":
                g = mesh.all_reduce(g)
            elif move != "gathered":
                g = mesh.reduce_scatter(g, move[1], move[2])
            zgrads.append(g)
        del grads
        blocks, opt_state, metrics = adamw.apply(opt_cfg, adamw.rebuild(params, zgrads),
                                                 opt_state, mesh, zspecs)
        new = [mesh.all_gather(b, move[1], move[2]) if isinstance(move, tuple) else b
               for b, move in zip(adamw.leaves(blocks), moves)]
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


def collective_bytes_per_step(cfg: ModelConfig, mesh, rules: ShardingRules = RULES_TRAIN
                              ) -> Dict[str, int]:
    """The payload one sharded step hands each collective, counted from the
    specs alone (``RankMesh.counters``' units: the whole tensor an
    all-gather returns or a reduce-scatter takes). Per layer use: one
    gather of each sharded leaf in the forward, one more in the remat
    "full" recomputation, one reduce-scatter of its gradient; ``embed``,
    ``lm_head`` and ``final_norm`` once a step; each replicated leaf's
    gradient reduce-scattered (a sharded ZeRO spec) or all-reduced, and
    all-gathered back after the update; the norm's and the loss's f32
    partials all-reduced."""
    if mesh.size == 1:
        return {"all_gather": 0, "reduce_scatter": 0, "all_reduce": 0}
    pspecs = model_lib.param_pspecs(cfg, rules, mesh)
    shapes = model_lib.param_shapes(cfg)
    zspecs = adamw.opt_pspecs(pspecs, shapes, mesh, rules).master
    gathers = 2 if cfg.remat == "full" else 1
    n_sb = cfg.n_layers // cfg.hybrid_period if cfg.family == "hybrid" else 1
    out = {"all_gather": 0, "reduce_scatter": 0, "all_reduce": 8}  # the norm, the loss
    for key in sorted(pspecs):
        uses = n_sb if key == "shared" else 1  # the shared block: once a superblock
        per = 1 if key in model_lib.TOP_LEAVES else gathers
        for ps, zs, t in zip(adamw.leaves(pspecs[key]), adamw.leaves(
                zspecs[key]), adamw.leaves(shapes[key])):
            nbytes = t.numel() * t.element_size()
            if _sharded_dim(ps, mesh) is not None:
                out["all_gather"] += nbytes * uses * per
                out["reduce_scatter"] += nbytes * uses
            elif _sharded_dim(zs, mesh) is not None:
                out["reduce_scatter"] += nbytes
                out["all_gather"] += nbytes
            else:
                out["all_reduce"] += nbytes
    return out
