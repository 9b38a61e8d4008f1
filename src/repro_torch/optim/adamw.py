"""Mixed-precision AdamW: bf16 compute parameters, an f32 master copy and
f32 moments.

Port of ``repro.optim.adamw`` on one card. The reference shards the master
copy and both moments over its mesh's ``fsdp`` axes (ZeRO-1, ``zero_spec``
and ``opt_pspecs``); one card has no mesh, so those two have no twin here.

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


def leaves(tree) -> List[torch.Tensor]:
    """The tensors of a tree of dicts, in the reference's order (keys
    sorted, as ``jax.tree_util`` flattens a dict)."""
    if isinstance(tree, dict):
        return [t for k in sorted(tree) for t in leaves(tree[k])]
    return [tree]


def map_tree(fn, tree):
    """``tree`` with ``fn`` applied to every tensor."""
    if isinstance(tree, dict):
        return {k: map_tree(fn, v) for k, v in tree.items()}
    return fn(tree)


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


def init(params) -> OptState:
    """The master copy (f32) and zero moments of ``params``, on their
    devices; the count 0."""
    dev = leaves(params)[0].device
    return OptState(
        master=map_tree(lambda a: a.to(torch.float32, copy=True), params),
        mu=map_tree(lambda a: torch.zeros(a.shape, dtype=torch.float32, device=a.device),
                    params),
        nu=map_tree(lambda a: torch.zeros(a.shape, dtype=torch.float32, device=a.device),
                    params),
        count=torch.zeros((), dtype=torch.int32, device=dev),
    )


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum of every leaf's f32 sum of squares, leaf by leaf (the
    f32 copy of one leaf at a time)."""
    total = 0
    for g in leaves(tree):
        total = total + torch.sum(torch.square(g.to(torch.float32)))
    return torch.sqrt(total)


@torch.no_grad()
def apply(cfg: AdamWConfig, grads,
          opt: OptState) -> Tuple[Any, OptState, Dict[str, torch.Tensor]]:
    """One AdamW update. Returns (new compute params, the new state,
    metrics ``{"grad_norm", "lr"}``), the params in the grads' dtypes.

    The returned state holds ``opt``'s own master, mu and nu tensors,
    updated in place; ``count`` is a new tensor. (The reference's
    ``compute_dtype`` argument is unused there and has no twin.)"""
    count = opt.count + 1
    gnorm = global_norm(grads)
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
