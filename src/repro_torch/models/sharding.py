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
