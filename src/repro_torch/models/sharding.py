"""Logical-axis sharding rules -> partition specs. Port of
``repro.models.sharding``.

Every parameter and activation is annotated with *logical* dimension names;
a rules table maps logical names to mesh axes. Meshes that lack an axis
(single-pod has no "pod"; one rank has one mesh of one) simply drop it, so
the same model code runs on any mesh shape: the basis for elastic
re-sharding.

Baseline layout:
  batch   -> ("pod", "data")   activation/data parallel
  seq     -> "model"           sequence/context parallel activations
  tp      -> "model"           tensor-parallel flat weight dims
  vocab   -> "model"           vocab-parallel embedding + logits
  experts -> "model"           expert parallel (MoE)
  fsdp    -> ("pod", "data")   ZeRO-style weight/optimizer sharding (MoE
                               expert weights; optimizer master/moments)

A spec is a plain tuple with one entry per dim: ``None``, an axis name, or
a tuple of names; it is exactly ``tuple(jax.sharding.PartitionSpec(...))``
of the reference's spec. The mesh is any object with ``axis_names`` and a
``shape`` dict (:class:`repro_torch.launch.mesh.RankMesh`).

:class:`ServeLayout` is what a call on a mesh shares between its layers (a
prefill, a decode step, or a train step's forward): where one call's rows,
positions and weight blocks lie, and the collectives that move a tensor
from one of those layouts to another (the reference leaves those moves to
GSPMD, after its ``constrain`` hints). The moves are ``RankMesh``'s
collectives, differentiable under grad (each one's backward its adjoint).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Sequence, Tuple, Union

import torch

Axes = Union[None, str, Tuple[str, ...]]
Spec = Tuple[Axes, ...]


@dataclasses.dataclass(frozen=True)
class ShardingRules:
    rules: Tuple[Tuple[str, Axes], ...] = (
        ("batch", ("pod", "data")),
        ("seq", "model"),
        ("kvseq", "model"),
        ("vocab", "model"),
        ("tp", "model"),
        ("tp_in", "model"),
        ("heads", "model"),
        ("experts", "model"),
        ("fsdp", ("pod", "data")),
        ("expert_fsdp", ("pod", "data")),
        ("layers", None),
        ("none", None),
    )

    def table(self) -> Dict[str, Axes]:
        return dict(self.rules)

    def replace(self, **kv) -> "ShardingRules":
        tab = self.table()
        tab.update(kv)
        return ShardingRules(rules=tuple(tab.items()))


DEFAULT_RULES = ShardingRules()

# Train: dense weights ZeRO-3-sharded over the data axes (all-gathered per
# layer inside the layer body); serve: weights TP-only resident (decode must
# not pay per-layer weight gathers). MoE expert weights stay fsdp-sharded in
# both.
RULES_TRAIN = DEFAULT_RULES
RULES_SERVE = DEFAULT_RULES.replace(fsdp=None)


def axes_tuple(axes: Axes) -> Tuple[str, ...]:
    """A spec entry as a tuple of axis names (``()`` for ``None``)."""
    if axes is None:
        return ()
    return (axes,) if isinstance(axes, str) else tuple(axes)


def _resolve_axes(axes: Axes, mesh) -> Axes:
    """Drop mesh axes that do not exist on this mesh (elastic meshes)."""
    if axes is None:
        return None
    if isinstance(axes, str):
        return axes if axes in mesh.axis_names else None
    kept = tuple(a for a in axes if a in mesh.axis_names)
    if not kept:
        return None
    return kept if len(kept) > 1 else kept[0]


def _size(axes: Axes, mesh) -> int:
    size = 1
    for a in axes_tuple(axes):
        size *= mesh.shape[a]
    return size


def spec_for(logical: Sequence[str], rules: ShardingRules, mesh,
             shape: Optional[Sequence[int]] = None) -> Spec:
    """The spec of a tensor with the given logical dim names.

    If ``shape`` is provided, any dim whose size does not divide evenly by
    the resolved mesh-axis size is replicated (the reference's guardrail
    for reduced and smoke configs)."""
    tab = rules.table()
    out = []
    for i, name in enumerate(logical):
        axes = _resolve_axes(tab.get(name, None), mesh)
        if axes is not None and shape is not None and shape[i] % _size(axes, mesh) != 0:
            axes = None
        out.append(axes)
    return tuple(out)


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A spec on a mesh: the twin of ``jax.sharding.NamedSharding``.
    :meth:`local` cuts a whole tensor to this rank's block."""

    mesh: Any
    spec: Spec

    def local(self, t: torch.Tensor) -> torch.Tensor:
        return self.mesh.local_block(t, self.spec)


def named_sharding(logical: Sequence[str], rules: ShardingRules, mesh,
                   shape: Optional[Sequence[int]] = None) -> NamedSharding:
    return NamedSharding(mesh, spec_for(logical, rules, mesh, shape))


def constrain(x: torch.Tensor, logical: Sequence[str], rules: ShardingRules,
              mesh) -> torch.Tensor:
    """The identity. The reference's ``with_sharding_constraint`` is a
    layout hint to GSPMD's partitioner; eager PyTorch has no partitioner,
    and each collective of the port is called where it runs."""
    return x


def axis_size(rules_name: str, rules: ShardingRules, mesh) -> int:
    return _size(_resolve_axes(rules.table().get(rules_name), mesh), mesh)


def dim_range(mesh, axes: Axes, size: int) -> Tuple[int, int]:
    """(start, stop) of this rank's block of a dim of ``size`` cut over
    ``axes``: the whole dim where it does not divide (``spec_for``'s
    fallback) or the axes are of size 1."""
    n = _size(axes, mesh)
    if n == 1 or size % n:
        return 0, size
    block = size // n
    i = mesh.block_index(axes)
    return i * block, (i + 1) * block


# the logical names that serving cuts over the model axes, which must all
# resolve to the same axes on a mesh (both rules tables map them to "model")
MODEL_NAMES = ("seq", "kvseq", "vocab", "tp", "heads", "experts")


@dataclasses.dataclass(frozen=True)
class ServeLayout:
    """Where one call (a prefill of ``s`` positions, a train step's
    forward of ``s``, built as a prefill's, or a decode step, ``s = 1``)
    lays its tensors on the mesh, under ``rules``:

      * rows: the batch is cut over the live ``"batch"`` axes when it
        divides (``rows``), else every rank holds every row;
      * positions: the residual stream ``("batch", "seq", "none")`` is cut
        over the model axes when ``s`` divides (``seq``), else replicated
        over them (a decode step's one position);
      * weights: a ``"tp"`` / ``"vocab"`` / ``"experts"`` dim is this rank's
        block when it divides over the model axes (:meth:`cut`), else whole.

    The model axes are the live axes that :data:`MODEL_NAMES` resolve to;
    a rules table that maps them to different axes is refused."""

    mesh: Any
    model: Tuple[str, ...]  # live model axes, () when the model axis is 1
    batch: Tuple[str, ...]  # live batch axes that cut the rows, () when not cut
    s: int  # the call's positions (the whole sequence)
    seq: bool  # the residual's positions are cut over ``model``

    @classmethod
    def build(cls, mesh, rules: ShardingRules, b: int, s: int) -> "ServeLayout":
        tab = rules.table()
        model = None
        for name in MODEL_NAMES:
            axes = mesh.live_axes(_resolve_axes(tab.get(name), mesh))
            if axes and model is not None and axes != model:
                raise ValueError(f"serving on a mesh needs {MODEL_NAMES} on one set of axes; "
                                 f"{name!r} is on {axes}, not {model}")
            model = axes or model
        model = model or ()
        batch = mesh.live_axes(_resolve_axes(tab.get("batch"), mesh))
        if set(batch) & set(model):
            raise ValueError(f"the batch axes {batch} overlap the model axes {model}")
        if batch and b % mesh.axes_size(batch):
            batch = ()  # the divisibility guard: every rank holds every row
        n = mesh.axes_size(model)
        return cls(mesh, model, batch, s, n > 1 and s % n == 0)

    @property
    def n(self) -> int:
        """Ranks over the model axes."""
        return self.mesh.axes_size(self.model)

    def rows(self, b: int) -> Tuple[int, int]:
        return dim_range(self.mesh, self.batch, b)

    def positions(self) -> Tuple[int, int]:
        """(start, stop) of this rank's positions of the residual."""
        return dim_range(self.mesh, self.model, self.s) if self.seq else (0, self.s)

    def cut(self, size: int) -> bool:
        """Whether a model-parallel dim of ``size`` is cut into blocks."""
        return self.n > 1 and size % self.n == 0

    def block(self, size: int) -> Tuple[int, int]:
        """(start, stop) of this rank's block of a model-parallel dim."""
        return dim_range(self.mesh, self.model, size)

    # -- moves between layouts -------------------------------------------------
    def all_positions(self, x: torch.Tensor) -> torch.Tensor:
        """The residual-layout ``x`` (b, s_local, ...) at every position."""
        return self.mesh.all_gather(x, 1, self.model) if self.seq else x

    def whole_cols(self, t: torch.Tensor, size: int) -> torch.Tensor:
        """``t``'s last dim whole, from this rank's block of a dim of ``size``
        (contiguous: the attention kernel reads a unit-stride last dim)."""
        if not self.cut(size):
            return t
        return self.mesh.all_gather(t, t.dim() - 1, self.model).contiguous()

    def reduce_partial(self, t: torch.Tensor) -> torch.Tensor:
        """The sum over the model axes of a partial product ``t`` (b, s,
        d) at every position, in the residual's layout: reduce-scattered
        over the positions where they are cut, else all-reduced."""
        if self.seq:
            return self.mesh.reduce_scatter(t, 1, self.model)
        return self.mesh.all_reduce(t, self.model)

    def model_sum(self, t: torch.Tensor) -> torch.Tensor:
        """The sum over the model axes of ``t``, each rank's partial sum over
        its block of a cut dim (a (b, s, 1) f32 sum of squares)."""
        return self.mesh.all_reduce(t, self.model) if self.n > 1 else t

    def row_product(self, a: torch.Tensor, w: torch.Tensor, size: int) -> torch.Tensor:
        """``a @ W`` in the residual's layout, for ``a`` (b, s, size) at every
        position with every column, and ``w`` this rank's row block of
        W (size, d) (W whole where ``size`` does not divide)."""
        if self.cut(size):
            c0, c1 = self.block(size)
            return self.reduce_partial(a[..., c0:c1] @ w)
        p0, p1 = self.positions()
        return (a @ w)[:, p0:p1]

    def whole_rows(self, t: torch.Tensor) -> torch.Tensor:
        """``t`` (b_rows, ...) with every row of the batch."""
        return self.mesh.all_gather(t, 0, self.batch) if self.batch else t
