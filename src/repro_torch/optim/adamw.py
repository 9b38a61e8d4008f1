"""Mixed-precision AdamW with ZeRO-sharded optimizer state: bf16 compute
parameters, an f32 master copy and f32 moments. Port of
``repro.optim.adamw``.

On a mesh the master copy and both moments are sharded over the ``fsdp``
axes as well as the parameters' own layout (:func:`zero_spec`,
:func:`opt_pspecs`): each rank holds its block of them, beside its
model-axis block where the parameter's spec cuts one (a ``("data",
"model")`` spec stays as it is), and :func:`init` and :func:`apply` work
on the blocks; the update is elementwise, so it is the same on a block.
:func:`global_norm` sums over the whole gradient across the ranks, a leaf
replicated over an axis counted once.

The arithmetic is the reference's, in f32 and in its order: the cosine
schedule and the bias corrections ``1 - b ** count`` are computed on f32
tensors as ``jnp`` computes them (not in Python floats), the clip scale is
``min(1, clip / (gnorm + 1e-9))``, the decoupled weight decay applies to
leaves with ``ndim >= 2`` only, and the new compute parameters are the
master rounded to each parameter's dtype. Unlike the reference's functional
update, :func:`apply` updates the master copy and the moments in place,
leaf by leaf: at Zamba2-2.7B's size a leaf holds up to 0.7 B elements
(2.8 GB in f32), and a functional update would keep five f32 temporaries
of it at once.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, List, NamedTuple, Tuple

import torch

from repro_torch.models.sharding import ShardingRules, Spec, _resolve_axes, axes_tuple


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10000
    min_lr_frac: float = 0.1


class OptState(NamedTuple):
    master: Any  # f32 master parameters
    mu: Any
    nu: Any
    count: torch.Tensor  # int32, 0-d


def leaves(tree) -> List[Any]:
    """The leaves of a tree of dicts (tensors, or a spec tree's tuples), in
    the reference's order (keys sorted, as ``jax.tree_util`` flattens a
    dict)."""
    if isinstance(tree, dict):
        return [t for k in sorted(tree) for t in leaves(tree[k])]
    return [tree]


def map_tree(fn, tree, *rest):
    """``tree`` with ``fn`` applied to every leaf (and to the leaves of the
    trees of the same structure in ``rest`` beside it)."""
    if isinstance(tree, dict):
        return {k: map_tree(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    return fn(tree, *rest)


def rebuild(tree, flat: List[torch.Tensor]):
    """``tree``'s structure filled with ``flat``, in :func:`leaves` order."""
    it = iter(flat)

    def walk(node):
        if isinstance(node, dict):
            out = {k: walk(node[k]) for k in sorted(node)}
            return {k: out[k] for k in node}
        return next(it)

    return walk(tree)


def schedule(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    """Linear warmup + cosine decay to min_lr_frac, an f32 0-d tensor."""
    step = torch.as_tensor(step).to(torch.float32)
    warm = torch.clamp(step / max(cfg.warmup_steps, 1), max=1.0)
    prog = torch.clamp(
        (step - cfg.warmup_steps) / max(cfg.total_steps - cfg.warmup_steps, 1), 0.0, 1.0
    )
    cos = 0.5 * (1 + torch.cos(math.pi * prog))
    frac = cfg.min_lr_frac + (1 - cfg.min_lr_frac) * cos
    return cfg.lr * warm * frac


def zero_spec(spec: Spec, shape: Tuple[int, ...], mesh, rules: ShardingRules) -> Spec:
    """Add fsdp-axis sharding to the first unsharded, divisible dim (ZeRO)."""
    fsdp = _resolve_axes(rules.table().get("fsdp"), mesh)
    if fsdp is None:
        return spec
    fsdp_t = axes_tuple(fsdp)
    size = math.prod(mesh.shape[a] for a in fsdp_t)
    used = {a for entry in spec for a in axes_tuple(entry)}
    if any(a in used for a in fsdp_t):
        return spec
    entries = list(spec) + [None] * (len(shape) - len(spec))
    for i, (entry, dim) in enumerate(zip(entries, shape)):
        if entry is None and dim % size == 0 and dim >= size:
            entries[i] = fsdp if isinstance(fsdp, str) else fsdp_t
            return tuple(entries)
    return spec


def opt_pspecs(param_specs, param_shapes, mesh, rules: ShardingRules) -> OptState:
    """The specs of the :class:`OptState` from the parameters' specs and
    shapes (trees of dicts; a shape leaf is anything with ``.shape``, or a
    ``(shape, dtype)`` pair)."""
    def one(spec, shaped):
        shape = shaped[0] if isinstance(shaped, tuple) else shaped.shape
        return zero_spec(spec, tuple(shape), mesh, rules)

    z = map_tree(one, param_specs, param_shapes)
    return OptState(master=z, mu=z, nu=z, count=())


def to_zero_block(t: torch.Tensor, spec: Spec, zspec: Spec, mesh) -> torch.Tensor:
    """``t``, this rank's block under the parameter spec ``spec``, cut to its
    block under the ZeRO spec ``zspec`` (which shards more dims, never
    fewer; a dim either spec cuts over the model axis stays this rank's
    block of it)."""
    for dim, (a, b) in enumerate(zip(spec, zspec)):
        if a != b:
            if a is not None:
                raise ValueError(f"ZeRO spec {zspec} is no refinement of {spec}")
            t = mesh.local_block(t, (None,) * dim + (b,))
    return t


def init(params, mesh=None, specs=None, zspecs=None) -> OptState:
    """The master copy (f32) and zero moments of ``params``, on their
    devices; the count 0. On a ``mesh`` ``params`` are this rank's blocks
    under ``specs`` and the state is cut to its blocks under ``zspecs``
    (:func:`opt_pspecs`' master)."""
    dev = leaves(params)[0].device
    if mesh is not None:
        params = map_tree(lambda t, a, b: to_zero_block(t, a, b, mesh), params, specs, zspecs)
    return OptState(
        master=map_tree(lambda a: a.to(torch.float32, copy=True), params),
        mu=map_tree(lambda a: torch.zeros(a.shape, dtype=torch.float32, device=a.device),
                    params),
        nu=map_tree(lambda a: torch.zeros(a.shape, dtype=torch.float32, device=a.device),
                    params),
        count=torch.zeros((), dtype=torch.int32, device=dev),
    )


def global_norm(tree, mesh=None, zspecs=None) -> torch.Tensor:
    """sqrt of the sum of every leaf's f32 sum of squares, leaf by leaf (the
    f32 copy of one leaf at a time). On a ``mesh`` the leaves are this
    rank's blocks under ``zspecs``: each rank sums the elements it owns (a
    leaf replicated over an axis, the model axis of a leaf whose ``tp`` dim
    did not divide among them, counts on the ranks ``mesh.owns`` names:
    coordinate 0 on that axis), one ``all_reduce`` sums the f32 partials,
    then the square root."""
    flat = leaves(tree)
    owned = [True] * len(flat) if mesh is None else [mesh.owns(z) for z in leaves(zspecs)]
    total = torch.zeros((), dtype=torch.float32, device=flat[0].device)
    for g, mine in zip(flat, owned):
        if mine:
            total = total + torch.sum(torch.square(g.to(torch.float32)))
    if mesh is not None:
        total = mesh.all_reduce(total)
    return torch.sqrt(total)


@torch.no_grad()
def apply(cfg: AdamWConfig, grads, opt: OptState, mesh=None,
          zspecs=None) -> Tuple[Any, OptState, Dict[str, torch.Tensor]]:
    """One AdamW update. Returns (new compute params, the new state,
    metrics ``{"grad_norm", "lr"}``), the params in the grads' dtypes.

    The returned state holds ``opt``'s own master, mu and nu tensors,
    updated in place; ``count`` is a new tensor. On a ``mesh`` the grads
    and the state are this rank's ZeRO blocks under ``zspecs``, the norm is
    the whole gradient's (:func:`global_norm`) and the params returned are
    the blocks. (The reference's ``compute_dtype`` argument is unused there
    and has no twin.)"""
    count = opt.count + 1
    gnorm = global_norm(grads, mesh, zspecs)
    if cfg.grad_clip:
        scale = torch.clamp(cfg.grad_clip / (gnorm + 1e-9), max=1.0)
    else:
        scale = None
    lr = schedule(cfg, count)
    b1c = 1 - cfg.b1 ** count.to(torch.float32)
    b2c = 1 - cfg.b2 ** count.to(torch.float32)

    flat_g = leaves(grads)
    flat_m, flat_v, flat_p = leaves(opt.mu), leaves(opt.nu), leaves(opt.master)
    new_params = []
    for g, m, v, p in zip(flat_g, flat_m, flat_v, flat_p):
        # the reference's upd(g, m, v, p), its operations in its order, with
        # m, v and p written in place and two leaf-sized f32 temporaries
        g32 = g.to(torch.float32, copy=True)
        if scale is not None:
            g32.mul_(scale)
        m.mul_(cfg.b1).add_(g32 * (1 - cfg.b1))
        g32.square_().mul_(1 - cfg.b2)
        v.mul_(cfg.b2).add_(g32)
        denom = torch.div(v, b2c, out=g32).sqrt_().add_(cfg.eps)  # sqrt(vhat) + eps
        step = (m / b1c).div_(denom)
        if p.dim() >= 2 and cfg.weight_decay:  # decoupled decay on matrices only
            step.add_(torch.mul(p, cfg.weight_decay, out=g32))
        p.sub_(step.mul_(lr))
        del g32, denom, step
        new_params.append(p.to(g.dtype, copy=True))
    params = rebuild(grads, new_params)
    return params, OptState(opt.master, opt.mu, opt.nu, count), {"grad_norm": gnorm, "lr": lr}
