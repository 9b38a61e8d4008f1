"""Meshes of ``torch.distributed`` ranks. Port of ``repro.launch.mesh``.

A :class:`RankMesh` is the twin of ``jax.sharding.Mesh`` over processes:
named axes, a ``shape`` dict, each rank's coordinate on every axis (rank r
sits at ``unravel_index(r, shape)``, row-major, as a ``Mesh`` lays out its
device array), each rank's device, and one process group for every axis
and every axis tuple the sharding rules use. A block of a dim sharded over
an axis tuple goes to the rank whose row-major index over those axes is the
block's: for ``("pod", "data")`` the block index is
``pod_idx * |data| + data_idx``, as a ``NamedSharding`` places blocks.

A world of one, or no process group, is the mesh of one: it runs no
collective. The library never initialises a group; the caller does
(``python -m torch.distributed.run``, a test, ``chip_smoke.py``).

Collectives and their route. NCCL serves ranks on their own cards. Ranks
that share one card need gloo (NCCL refuses two ranks on one device), and
gloo's collectives take host tensors: on a mesh over gloo whose ranks hold
card tensors, every collective copies its input to the host, runs there and
copies the result back. The route (:attr:`RankMesh.route`) is fixed when the
mesh is built and never changes; :attr:`RankMesh.counters` counts each
collective's payload and the bytes staged through the host.

Gradients. Under grad mode a collective of a tensor that requires grad
goes through its ``torch.autograd.Function`` (:class:`AllGather`,
:class:`ReduceScatter`, :class:`AllReduce`, :class:`AllToAll`), whose
backward is its adjoint: all-gather and reduce-scatter are each other's,
all-reduce is its own, an all-to-all's is the reverse all-to-all. The
gradient of every rank's input is then that of the sum of every rank's
output, which is what the sharded train step differentiates (the
backward's payloads count in ``counters`` like any other). Elsewhere
(serving, the Tucker paths, the step's own gradient moves) the same
collective runs directly, with the same bits.
"""
from __future__ import annotations

import dataclasses
import datetime
import math
import time
from typing import Any, Dict, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.base import resolve_device
from repro_torch.models.sharding import DEFAULT_RULES, Axes, Spec, axes_tuple

__all__ = ["AllGather", "AllReduce", "AllToAll", "RankMesh", "ReduceScatter", "make_host_mesh",
           "make_mesh", "make_production_mesh"]

GROUP_TIMEOUT_S = 120  # every group a mesh builds: a lost rank fails the run, never hangs it
ROUTES = ("none", "nccl", "gloo", "gloo-host-staged")

# the tensor collectives under their current names, the older ones where
# this torch lacks them
_all_gather_single = getattr(dist, "all_gather_single", None) or dist.all_gather_into_tensor
_reduce_scatter_single = (getattr(dist, "reduce_scatter_single", None)
                          or dist.reduce_scatter_tensor)
_all_to_all_single = dist.all_to_all_single


def _default_group() -> Any:
    return dist.group.WORLD if dist.is_available() and dist.is_initialized() else None


def _new_counters() -> Dict[str, float]:
    return {"all_gather": 0, "reduce_scatter": 0, "all_reduce": 0, "all_to_all": 0,
            "host_staged": 0, "seconds": 0.0}


@dataclasses.dataclass
class RankMesh:
    """Named axes over the ranks of a process group (see the module's
    docstring). Build it with :func:`make_mesh` or :func:`make_host_mesh`:
    building one over a group is collective, every rank in the same order.

    Attributes:
      axis_names: the axes, outermost first.
      shape: ``{axis: size}`` in axis order, as ``Mesh.shape``.
      rank: this process's rank in the group.
      coords: ``{axis: index}``, this rank's coordinate on each axis.
      devices: each rank's device, in rank order.
      group: the group the mesh spans (None for the mesh of one).
      route: how collectives run (one of :data:`ROUTES`).
      counters: bytes by collective since :meth:`reset_counters`: the
        payload of each (the whole tensor an all-gather returns, a
        reduce-scatter takes, an all-reduce reduces, an all-to-all sends)
        and the bytes copied
        between card and host on the staged route; and ``seconds``, the
        host's time inside the collectives (staging included).
    """

    axis_names: Tuple[str, ...]
    shape: Dict[str, int]
    rank: int
    coords: Dict[str, int]
    devices: Tuple[str, ...]
    group: Any = None
    route: str = "none"
    _groups: Dict[Tuple[str, ...], Any] = dataclasses.field(default_factory=dict, repr=False)
    counters: Dict[str, float] = dataclasses.field(default_factory=_new_counters)

    @property
    def size(self) -> int:
        return math.prod(self.shape.values())

    @property
    def device(self) -> torch.device:
        """This rank's device."""
        return torch.device(self.devices[self.rank])

    def reset_counters(self) -> None:
        self.counters.update(_new_counters())

    # -- blocks ---------------------------------------------------------------
    def live_axes(self, axes: Axes) -> Tuple[str, ...]:
        """``axes`` as a tuple, without the axes of size 1 (which split
        nothing); an axis tuple must keep the mesh's order."""
        names = axes_tuple(axes)
        order = [self.axis_names.index(a) for a in names]
        if order != sorted(order):
            raise ValueError(f"axes {names} are not in the mesh's order {self.axis_names}")
        return tuple(a for a in names if self.shape[a] > 1)

    def axes_size(self, axes: Axes) -> int:
        return math.prod(self.shape[a] for a in axes_tuple(axes))

    def block_index(self, axes: Axes) -> int:
        """This rank's block of a dim sharded over ``axes``: its row-major
        index over those axes' coordinates."""
        idx = 0
        for a in axes_tuple(axes):
            idx = idx * self.shape[a] + self.coords[a]
        return idx

    def local_block(self, t: torch.Tensor, spec: Spec) -> torch.Tensor:
        """This rank's block of the whole tensor ``t`` under ``spec`` (a
        view; a replicated dim stays whole)."""
        for dim, axes in enumerate(spec):
            n = self.axes_size(axes)
            if n > 1:
                if t.shape[dim] % n:
                    raise ValueError(f"dim {dim} of {tuple(t.shape)} does not divide over {axes}")
                size = t.shape[dim] // n
                t = t.narrow(dim, self.block_index(axes) * size, size)
        return t

    def owns(self, spec: Spec) -> bool:
        """Whether this rank counts a tensor of ``spec`` in a sum over the
        mesh: the tensor is replicated over every axis the spec does not
        shard, and rank coordinate 0 on those axes holds the copy that
        counts."""
        sharded = {a for axes in spec for a in axes_tuple(axes)}
        return all(self.coords[a] == 0 for a in self.axis_names if a not in sharded)

    # -- collectives ----------------------------------------------------------
    def group_for(self, axes: Axes) -> Any:
        """The group of the ranks that share this rank's coordinates off
        ``axes``: the one a collective over ``axes`` runs in."""
        live = self.live_axes(axes)
        if not live:
            return None
        if live not in self._groups:
            raise ValueError(f"the mesh built no group for the axes {live}")
        return self._groups[live]

    def _host(self, t: torch.Tensor) -> torch.Tensor:
        """``t`` where the group's collectives take it: a pinned host copy on
        the staged route (complete when this returns), else ``t``
        contiguous."""
        if self.route != "gloo-host-staged":
            return t.contiguous()
        self.counters["host_staged"] += t.numel() * t.element_size()
        out = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        out.copy_(t, non_blocking=True)
        torch.cuda.current_stream(t.device).synchronize()
        return out

    def _back(self, t: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
        if self.route != "gloo-host-staged":
            return t
        self.counters["host_staged"] += t.numel() * t.element_size()
        return t.to(like.device, non_blocking=True)

    def all_gather(self, t: torch.Tensor, dim: int, axes: Axes) -> torch.Tensor:
        """The whole tensor from every rank's block along ``dim``, the
        blocks in the order of :meth:`block_index` over ``axes``; under
        grad, :class:`AllGather`."""
        if self.group_for(axes) is None:
            return t
        if _tracked(t):
            return AllGather.apply(t, self, dim, axes)
        return self._all_gather(t, dim, axes)

    def _all_gather(self, t: torch.Tensor, dim: int, axes: Axes) -> torch.Tensor:
        group = self.group_for(axes)
        t0 = time.perf_counter()
        n = dist.get_world_size(group)
        src = self._host(t.movedim(dim, 0))
        out = torch.empty((n * src.shape[0],) + tuple(src.shape[1:]), dtype=src.dtype,
                          device=src.device, pin_memory=src.is_pinned())
        _all_gather_single(out, src, group=group)
        self.counters["all_gather"] += out.numel() * out.element_size()
        out = self._back(out, t).movedim(0, dim)
        self.counters["seconds"] += time.perf_counter() - t0
        return out

    def reduce_scatter(self, t: torch.Tensor, dim: int, axes: Axes) -> torch.Tensor:
        """The sum over the ranks of ``axes`` of the whole tensor ``t``,
        cut to this rank's block along ``dim``; summed in ``t``'s dtype;
        under grad, :class:`ReduceScatter`."""
        if self.group_for(axes) is None:
            return t
        if _tracked(t):
            return ReduceScatter.apply(t, self, dim, axes)
        return self._reduce_scatter(t, dim, axes)

    def _reduce_scatter(self, t: torch.Tensor, dim: int, axes: Axes) -> torch.Tensor:
        group = self.group_for(axes)
        t0 = time.perf_counter()
        n = dist.get_world_size(group)
        src = self._host(t.movedim(dim, 0))
        out = torch.empty((src.shape[0] // n,) + tuple(src.shape[1:]), dtype=src.dtype,
                          device=src.device, pin_memory=src.is_pinned())
        _reduce_scatter_single(out, src, group=group)
        self.counters["reduce_scatter"] += src.numel() * src.element_size()
        out = self._back(out, t).movedim(0, dim)
        self.counters["seconds"] += time.perf_counter() - t0
        return out

    def all_reduce(self, t: torch.Tensor, axes: Axes = None) -> torch.Tensor:
        """The sum of ``t`` over the ranks of ``axes`` (every axis when
        None), a new tensor on ``t``'s device; under grad,
        :class:`AllReduce`."""
        axes = self.axis_names if axes is None else axes
        if self.group_for(axes) is None:
            return t
        if _tracked(t):
            return AllReduce.apply(t, self, axes)
        return self._all_reduce(t, axes)

    def _all_reduce(self, t: torch.Tensor, axes: Axes) -> torch.Tensor:
        group = self.group_for(axes)
        t0 = time.perf_counter()
        src = self._host(t)
        if src is t:
            src = t.clone()
        dist.all_reduce(src, group=group)
        self.counters["all_reduce"] += src.numel() * src.element_size()
        out = self._back(src, t)
        self.counters["seconds"] += time.perf_counter() - t0
        return out

    def all_to_all(self, t: torch.Tensor, split_dim: int, concat_dim: int,
                   axes: Axes) -> torch.Tensor:
        """``jax.lax.all_to_all(t, axes, split_dim, concat_dim, tiled=True)``:
        ``t`` cut into n equal blocks along ``split_dim`` (n the size of
        ``axes``), block i sent to the rank of :meth:`block_index` i over
        ``axes``, and the n blocks received concatenated along ``concat_dim``
        in the senders' block order; under grad, :class:`AllToAll`."""
        if self.group_for(axes) is None:
            return t
        if _tracked(t):
            return AllToAll.apply(t, self, split_dim, concat_dim, axes)
        return self._all_to_all(t, split_dim, concat_dim, axes)

    def _all_to_all(self, t: torch.Tensor, split_dim: int, concat_dim: int,
                    axes: Axes) -> torch.Tensor:
        group = self.group_for(axes)
        t0 = time.perf_counter()
        n = dist.get_world_size(group)
        split_dim, concat_dim = split_dim % t.dim(), concat_dim % t.dim()
        if t.shape[split_dim] % n:
            raise ValueError(f"all_to_all: dim {split_dim} of {tuple(t.shape)} does not divide "
                             f"over {n} ranks")
        moved = t.movedim(split_dim, 0)
        blocks = moved.reshape((n, moved.shape[0] // n) + tuple(moved.shape[1:]))
        src = self._host(blocks)
        out = torch.empty(src.shape, dtype=src.dtype, device=src.device,
                          pin_memory=src.is_pinned())
        _all_to_all_single(out, src, group=group)
        self.counters["all_to_all"] += src.numel() * src.element_size()
        out = self._back(out, t)
        # each received block back in t's layout, then side by side on concat_dim
        out = out.movedim(1, split_dim + 1)
        out = torch.cat(out.unbind(0), dim=concat_dim)
        self.counters["seconds"] += time.perf_counter() - t0
        return out

    def gather_full(self, t: torch.Tensor, spec: Spec) -> torch.Tensor:
        """The whole tensor from this rank's block under ``spec``."""
        for dim, axes in enumerate(spec):
            t = self.all_gather(t, dim, axes)
        return t

    def barrier(self) -> None:
        if self.group is not None:
            dist.barrier(group=self.group)


def _tracked(t: torch.Tensor) -> bool:
    """Whether autograd records a collective of ``t``."""
    return torch.is_grad_enabled() and t.requires_grad


class AllGather(torch.autograd.Function):
    """:meth:`RankMesh.all_gather` under autograd; the backward
    reduce-scatters (sums) the whole gradient back to each rank's block."""

    @staticmethod
    def forward(ctx, t, mesh, dim: int, axes):
        ctx.mesh, ctx.dim, ctx.axes = mesh, dim, axes
        return mesh._all_gather(t, dim, axes)

    @staticmethod
    def backward(ctx, grad):
        return ctx.mesh._reduce_scatter(grad, ctx.dim, ctx.axes), None, None, None


class ReduceScatter(torch.autograd.Function):
    """:meth:`RankMesh.reduce_scatter` under autograd; the backward
    all-gathers the blocks' gradients (every rank's input fed every
    block)."""

    @staticmethod
    def forward(ctx, t, mesh, dim: int, axes):
        ctx.mesh, ctx.dim, ctx.axes = mesh, dim, axes
        return mesh._reduce_scatter(t, dim, axes)

    @staticmethod
    def backward(ctx, grad):
        return ctx.mesh._all_gather(grad, ctx.dim, ctx.axes), None, None, None


class AllReduce(torch.autograd.Function):
    """:meth:`RankMesh.all_reduce` under autograd; the backward all-reduces
    the gradients (each rank's input fed every rank's sum)."""

    @staticmethod
    def forward(ctx, t, mesh, axes):
        ctx.mesh, ctx.axes = mesh, axes
        return mesh._all_reduce(t, axes)

    @staticmethod
    def backward(ctx, grad):
        return ctx.mesh._all_reduce(grad, ctx.axes), None, None


class AllToAll(torch.autograd.Function):
    """:meth:`RankMesh.all_to_all` under autograd; the backward is the
    reverse all-to-all (split along the forward's ``concat_dim``, joined
    along its ``split_dim``), which sends each block's gradient back to the
    rank it came from."""

    @staticmethod
    def forward(ctx, t, mesh, split_dim: int, concat_dim: int, axes):
        ctx.mesh, ctx.axes = mesh, axes
        ctx.split_dim, ctx.concat_dim = split_dim % t.dim(), concat_dim % t.dim()
        return mesh._all_to_all(t, split_dim, concat_dim, axes)

    @staticmethod
    def backward(ctx, grad):
        return (ctx.mesh._all_to_all(grad, ctx.concat_dim, ctx.split_dim, ctx.axes),
                None, None, None, None)


def _axis_sets(axis_names: Sequence[str], shape: Dict[str, int]):
    """The axis tuples that need a group: every axis alone, every axis
    tuple of the rules table and all the axes together (the MoE aux loss
    averages over the batch and sequence axes), each without its size-1
    axes, in the mesh's order; deduplicated, in one order on every rank."""
    sets = [(a,) for a in axis_names]
    for axes in DEFAULT_RULES.table().values():
        sets.append(tuple(a for a in axis_names if a in axes_tuple(axes)))
    sets.append(tuple(axis_names))
    out = []
    for s in sets:
        live = tuple(a for a in s if shape[a] > 1)
        if live and live not in out:
            out.append(live)
    return out


def make_mesh(shape: Sequence[int], axes: Sequence[str], group: Any = None,
              device="cuda") -> RankMesh:
    """A mesh of ``shape`` with axis names ``axes`` over the ranks of
    ``group`` (else the default group when one is initialised, else a world
    of one). Its size must be the group's; ``device`` is this rank's device.
    Collective over the group: every rank builds every sub-group, in the
    same order."""
    shape, axes = tuple(int(s) for s in shape), tuple(axes)
    if len(shape) != len(axes) or len(set(axes)) != len(axes):
        raise ValueError(f"shape {shape} and axes {axes} must pair one to one")
    dev = resolve_device(device)
    shape_d = dict(zip(axes, shape))
    if group is None:
        group = _default_group()
    world = dist.get_world_size(group) if group is not None else 1
    want = math.prod(shape)
    if want > world:
        raise ValueError(f"a {shape} mesh needs {want} ranks; the group has {world}")
    if want < world:
        raise ValueError(f"a {shape} mesh covers {want} of the group's {world} ranks")
    if world == 1:
        return RankMesh(axes, shape_d, 0, {a: 0 for a in axes}, (str(dev),))
    rank = dist.get_rank(group)
    coords = dict(zip(axes, (int(c) for c in np.unravel_index(rank, shape))))
    devices = [None] * world
    dist.all_gather_object(devices, str(dev), group=group)
    backend = str(dist.get_backend(group))
    route = "nccl" if backend == "nccl" else (
        "gloo-host-staged" if dev.type == "cuda" else "gloo")
    global_ranks = (dist.get_process_group_ranks(group) if group is not dist.group.WORLD
                    else list(range(world)))
    groups = {}
    timeout = datetime.timedelta(seconds=GROUP_TIMEOUT_S)
    grid = np.arange(world).reshape(shape)
    for live in _axis_sets(axes, shape_d):
        if math.prod(shape_d[a] for a in live) == world:
            groups[live] = group  # the whole world: the group itself
            continue
        moved = np.moveaxis(grid, [axes.index(a) for a in live],
                            range(len(axes) - len(live), len(axes)))
        members = moved.reshape(-1, math.prod(shape_d[a] for a in live))
        for row in members:  # every rank creates every sub-group, in this order
            g = dist.new_group([global_ranks[r] for r in row], timeout=timeout)
            if rank in row:
                groups[live] = g
    return RankMesh(axes, shape_d, rank, coords, tuple(devices), group, route, groups)


def make_host_mesh(group: Any = None, device="cuda") -> RankMesh:
    """Every rank of ``group`` (else of the default group, else the world
    of one) as a ``(n, 1)`` ``("data", "model")`` mesh: the mesh the
    reference's ``examples/train_lm.py`` trains on."""
    if group is None:
        group = _default_group()
    n = dist.get_world_size(group) if group is not None else 1
    return make_mesh((n, 1), ("data", "model"), group, device)


def make_production_mesh(*, multi_pod: bool = False, group: Any = None,
                         device="cuda") -> RankMesh:
    """16x16 (one pod, 256 ranks) or 2x16x16 (two pods, 512 ranks).

    Axes: ("data", "model") single-pod; ("pod", "data", "model") multi-pod.
    The "pod" axis is the slow axis: only data-parallel gradient reduction
    and MoE-weight FSDP gathers cross it. Any other world raises."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    if group is None:
        group = _default_group()
    world = dist.get_world_size(group) if group is not None else 1
    if world != math.prod(shape):
        raise ValueError(f"the production mesh {shape} needs {math.prod(shape)} ranks; "
                         f"the group has {world}")
    return make_mesh(shape, axes, group, device)
