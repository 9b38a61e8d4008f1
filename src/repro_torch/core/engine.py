"""Sweep engine: where each ALS sweep's two hot loops run, plus the cached
per-mode schedules of the tensor being decomposed.

Port of ``repro.core.engine``. The kernel path — the schedule-ordered
unfolding (``kernels.ops``) and the core update, either the TTM kernel on
the materialised last unfolding or, with ``fuse_core``, the megakernel that
rebuilds it from the nonzeros — runs the same code on both devices and
differs only in the device of its tensors:

  ``cuda``   the hand-written CUDA kernels, on a CUDA device;
  ``torch``  on the CPU, their plain PyTorch versions on the same schedules;
  ``auto``   ``cuda`` on a CUDA device, ``torch`` on the CPU.

``torch`` with ``use_kron_reuse`` is the twin of the reference's XLA engine
with Kron reuse, on either device: the paper's Kron-reuse chain of
``core.kron`` in torch ops and the core update as one ``torch.matmul``, no
kernel of the port's and no plain version of one; ``fuse_core`` is a
kernel-path layout, which it ignores, as the XLA engine does. That is the
one way ``torch`` runs on a CUDA device. Kron reuse is honoured on
``torch`` only: ``cuda``'s kernel 1 reads the factor rows through its
schedule, as the reference's Pallas engine ignores it.

A sharded plan wraps its engine in a :class:`ShardedSweepEngine`: the
engine runs on the rank's slice of the nonzeros (``shard_schedule``) and
each partial unfolding is summed over the ranks by one all-reduce.
"""
from __future__ import annotations

import dataclasses
import weakref
from typing import Any, Dict, List, Optional, Sequence

import torch
import torch.distributed as dist

from repro_torch.core.coo import SparseCOO
from repro_torch.core.kron import sparse_ttm_chain_reuse_device
from repro_torch.core.ttm import ttm_unfolded
from repro_torch.kernels import ops
from repro_torch.kernels.kron_kernel import DEFAULT_BI, DEFAULT_BN, PRECISIONS
from repro_torch.sparse.layout import (
    SLOTS_PER_PART,
    DeviceSchedule,
    KronReusePlan,
    ShardSchedule,
    build_kron_reuse,
    build_mode_layout,
    build_shard_schedule,
)

ENGINES = ("auto", "cuda", "torch")
JAX_ENGINES = ("xla", "pallas")


def resolve_engine(engine: str, device, use_kron_reuse: bool = False) -> str:
    """Map a requested engine and a device to the engine that will run."""
    if engine in JAX_ENGINES:
        raise ValueError(
            f"engine={engine!r} is a JAX engine of the repro package; the "
            f"PyTorch port's engines are {ENGINES}"
        )
    if engine not in ENGINES:
        raise ValueError(f"engine must be one of {ENGINES}, got {engine!r}")
    on_card = torch.device(device).type == "cuda"
    if engine == "auto":
        return "cuda" if on_card else "torch"
    if engine == "cuda" and not on_card:
        raise ValueError(f"engine='cuda' needs a CUDA device, got {device}")
    if engine == "torch" and on_card and not use_kron_reuse:
        raise ValueError(
            "engine='torch' runs the plain versions of the kernels, which the "
            "port never selects on a CUDA device: use engine='auto' or 'cuda' "
            "(or use_kron_reuse=True, the Kron-reuse chain in torch ops)"
        )
    return engine


class _Binding:
    """Ties a cache of per-tensor entries (each with ``with_values``) to the
    tensor they were built from. Other indices, or another shape, empty the
    cache; so does the indices tensor's death (the entries are O(nnz)
    memory). Other values on the same indices (another values tensor, or
    one written in place: its version counter moves) are taken into every
    entry with no rebuild. Indices written in place are not seen."""

    def __init__(self, cache: dict) -> None:
        self.cache = cache
        # weakrefs: a live referent makes the identity check sound without
        # pinning the tensor
        self._indices: Optional["weakref.ref"] = None
        self._shape: Optional[tuple] = None
        self._values: Optional["weakref.ref"] = None
        self._version = -1

    def bind(self, coo: SparseCOO) -> None:
        bound = self._indices() if self._indices is not None else None
        if bound is not coo.indices or self._shape != coo.shape:
            self.cache.clear()

            def _release(_ref, cache=self.cache):
                cache.clear()

            self._indices = weakref.ref(coo.indices, _release)
            self._shape = tuple(coo.shape)
        values = self._values() if self._values is not None else None
        version = coo.values._version
        if values is not coo.values or self._version != version:
            for key, entry in self.cache.items():
                self.cache[key] = entry.with_values(coo.values)
            self._values = weakref.ref(coo.values)
            self._version = version


@dataclasses.dataclass
class SweepEngine:
    """Sweep executor: resolved engine, device, and the schedule caches of
    the tensor it is bound to.

    The schedules are the expensive part (three stable sorts of the
    nonzeros), built once per (tensor, mode) and reused by every sweep and
    call. Handing the engine a different tensor is safe: the caches rebind
    when the indices tensor changes identity or the shape changes. The
    schedules also keep the slot-ordered values; those are taken again, with
    no new sort, when the values tensor changes identity or is written in
    place (its version counter moves). Indices written in place are not
    seen: hand the engine a new indices tensor instead.
    """

    name: str  # resolved: "cuda" or "torch"
    device: torch.device
    precision: str = "fp32"
    # core update through the fused megakernel instead of the split TTM.
    fuse_core: bool = False
    # the paper's Kron reuse (Sec. III-C), honoured on the torch engine only
    use_kron_reuse: bool = False
    # the schedule's geometry (nonzeros per block, rows per block) and the
    # unfolding kernel's row split: the launch parameters the autotuner sets
    # (``apply_blocks``); the defaults are the hand-picked ones.
    bn: int = DEFAULT_BN
    bi: int = DEFAULT_BI
    slots_per_part: int = SLOTS_PER_PART
    # per-mode schedule builds, cumulative; the plan reports per-call deltas.
    schedule_builds: int = 0
    dev_schedules: Dict[int, DeviceSchedule] = dataclasses.field(default_factory=dict)
    # this rank's slices of a whole tensor (sharded plans), by (mesh,
    # target_nnz)
    shard_schedules: Dict[tuple, ShardSchedule] = dataclasses.field(default_factory=dict)
    # the Kron-reuse dedup of each mode (use_kron_reuse on the torch engine)
    kron_plans: Dict[int, KronReusePlan] = dataclasses.field(default_factory=dict)
    # what each cache was built from: the mode schedules and dedup plans
    # from the tensor they sweep (a rank's slice under shard), the slices
    # from the whole tensor
    _dev_binding: "_Binding" = dataclasses.field(init=False, repr=False)
    _kron_binding: "_Binding" = dataclasses.field(init=False, repr=False)
    _shard_binding: "_Binding" = dataclasses.field(init=False, repr=False)

    def __post_init__(self) -> None:
        self._dev_binding = _Binding(self.dev_schedules)
        self._kron_binding = _Binding(self.kron_plans)
        self._shard_binding = _Binding(self.shard_schedules)

    @property
    def reuses_kron(self) -> bool:
        """Whether the sweeps run the Kron-reuse chain and the core update
        by ``torch.matmul`` in place of the kernel path: the flag, on the
        torch engine (the reference's rule: its XLA engine only)."""
        return self.use_kron_reuse and self.name == "torch"

    def kron_plan(self, coo: SparseCOO, mode: int) -> KronReusePlan:
        """The mode's Kron-reuse dedup (``sparse.layout.build_kron_reuse``),
        built once per tensor on the tensor's device and counted as a
        schedule build."""
        self._kron_binding.bind(coo)
        if mode not in self.kron_plans:
            self.kron_plans[mode] = build_kron_reuse(coo, mode)
            self.schedule_builds += 1
        return self.kron_plans[mode]

    def device_schedule(self, coo: SparseCOO, mode: int) -> DeviceSchedule:
        """The mode's schedule on the engine's device, built once: the
        kernels' row-block schedule, or with Kron reuse the dedup alone
        (``DeviceSchedule.from_kron_plan``), as the reference's."""
        self._dev_binding.bind(coo)
        if mode not in self.dev_schedules:
            if self.reuses_kron:
                self.dev_schedules[mode] = DeviceSchedule.from_kron_plan(
                    self.kron_plan(coo, mode), mode, tuple(coo.shape), self.device)
            else:
                self.dev_schedules[mode] = DeviceSchedule.from_layout(
                    build_mode_layout(coo, mode, bn=self.bn, bi=self.bi), coo, self.device,
                    slots_per_part=self.slots_per_part,
                )
            self.schedule_builds += 1
        return self.dev_schedules[mode]

    def shard_schedule(self, coo: SparseCOO, mesh: Any,
                       target_nnz: Optional[int] = None) -> ShardSchedule:
        """This rank's slice of ``coo`` on ``mesh``
        (:func:`~repro_torch.sparse.layout.build_shard_schedule`), copied to
        the rank's device once per (tensor, mesh, pad target) and counted as
        a schedule build. New values on the same coordinates (another
        values tensor, or one written in place) slice the values again and
        keep the indices slice, so the mode schedules built on it stay."""
        self._shard_binding.bind(coo)
        key = (mesh, None if target_nnz is None else int(target_nnz))
        if key not in self.shard_schedules:
            self.shard_schedules[key] = build_shard_schedule(coo, mesh, target_nnz=target_nnz)
            self.schedule_builds += 1
        return self.shard_schedules[key]

    def apply_blocks(self, cfg) -> None:
        """Adopt an autotuned configuration
        (:class:`repro_torch.kernels.autotune.BlockConfig`). A new schedule
        geometry (bn, bi, slots_per_part) drops the cached schedules, which
        are rebuilt at the next sweep; the layout sets ``fuse_core``."""
        geometry = (int(cfg.bn), int(cfg.bi), int(cfg.slots_per_part))
        if geometry != (self.bn, self.bi, self.slots_per_part):
            self.dev_schedules.clear()
        self.bn, self.bi, self.slots_per_part = geometry
        self.fuse_core = cfg.layout == "fused"

    def mode_unfolding(self, coo: SparseCOO, factors: Sequence[torch.Tensor],
                       mode: int) -> torch.Tensor:
        """Y_(mode): (I_mode, prod_{t != mode} R_t), f32 or f64 (Alg. 2
        line 5): the kernel path, or the Kron-reuse chain
        (:attr:`reuses_kron`)."""
        if self.reuses_kron:
            return sparse_ttm_chain_reuse_device(
                coo.indices, coo.values, factors, mode, self.device_schedule(coo, mode),
                shape=tuple(coo.shape))
        return ops.sparse_ttm_chain_device(
            coo.indices, coo.values, factors, mode,
            self.device_schedule(coo, mode),
            shape=tuple(coo.shape), precision=self.precision,
        )

    def core_unfolding(self, y_n: torch.Tensor, u_last: torch.Tensor) -> torch.Tensor:
        """G_(N) = U_N^T Y_(N) (Eq. 12), through the TTM kernel on the
        transposed views (no copy of the unfolding); with Kron reuse one
        matmul, as the reference's XLA engine."""
        if self.reuses_kron:
            return ttm_unfolded(y_n.T, u_last.T).T
        return ops.ttm(y_n.T, u_last.T, precision=self.precision).T

    def core_update(self, coo: SparseCOO, factors: Sequence[torch.Tensor],
                    y_n: torch.Tensor) -> torch.Tensor:
        """The core update with the engine's layout applied: with
        ``fuse_core`` on a 2- or 3-way tensor the megakernel re-streams the
        nonzeros so Y_(N) is not read back a second time; otherwise the
        split TTM over the materialised ``y_n``. Higher orders have no
        megakernel (``ops.sparse_ttm_core_device`` would rebuild ``y_n``
        through the whole chain and then run the same TTM), so they take
        the split TTM directly. The reference takes the fused path only on
        its kernel engine; both engines here are kernel engines (``torch``
        runs the kernels' plain versions), so both honour the flag, unless
        Kron reuse takes the XLA engine's place."""
        n = coo.ndim
        if self.fuse_core and n <= 3 and not self.reuses_kron:
            return ops.sparse_ttm_core_device(
                coo.indices, coo.values, factors, n - 1,
                self.device_schedule(coo, n - 1),
                shape=tuple(coo.shape), precision=self.precision,
            )
        return self.core_unfolding(y_n, factors[n - 1])


@dataclasses.dataclass
class ShardedSweepEngine:
    """One rank's sweep engine under a sharded plan: the twin of the
    reference's ``build_sharded_program`` bodies (a local
    ``sparse_ttm_chain``, then ``psum`` over the nnz axes).

    ``local`` is the rank's :class:`SweepEngine`, which runs on the rank's
    slice of the nonzeros (a tensor of the whole shape). Each partial
    unfolding it returns is summed over ``mesh``'s group by one
    ``all_reduce`` in place; the core update is the split TTM on the summed
    Y_(N), on every rank (a fused core update would contract a partial Y).
    ``core.hooi``'s sweep loop runs on it unchanged. A failed or timed-out
    collective raises out of the sweep: nothing falls back to an unsharded
    run.
    """

    local: SweepEngine
    mesh: Any  # repro_torch.core.distributed.ShardMesh

    def replicate(self, tensors: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        """Rank 0's ``tensors`` on every rank, by one broadcast of them
        flattened (none in a world of one): the initial factors, so that
        ranks whose generators or ``factors_init`` differ still sweep one
        set of factors. Same-shape, same-dtype tensors come back."""
        group = self.mesh.group
        if group is None or not tensors:
            return list(tensors)
        flat = torch.cat([t.reshape(-1) for t in tensors])
        dist.broadcast(flat, src=dist.get_global_rank(group, 0), group=group)
        return [part.view_as(t) for part, t in zip(flat.split([t.numel() for t in tensors]),
                                                    tensors)]

    def all_reduce(self, y: torch.Tensor) -> torch.Tensor:
        """``y`` summed over the ranks, in place (no collective in a world
        of one)."""
        if self.mesh.group is not None:
            dist.all_reduce(y, op=dist.ReduceOp.SUM, group=self.mesh.group)
        return y

    def mode_unfolding(self, coo: SparseCOO, factors: Sequence[torch.Tensor],
                       mode: int) -> torch.Tensor:
        """Y_(mode) of the whole tensor from this rank's slice ``coo``."""
        return self.all_reduce(self.local.mode_unfolding(coo, factors, mode).contiguous())

    def core_update(self, coo: SparseCOO, factors: Sequence[torch.Tensor],
                    y_n: torch.Tensor) -> torch.Tensor:
        """G_(N) = U_N^T Y_(N) on the summed ``y_n``: the split TTM."""
        return self.local.core_unfolding(y_n, factors[coo.ndim - 1])


def make_engine(engine: str = "auto", device="cuda", *,
                precision: str = "fp32", fuse_core: bool = False,
                use_kron_reuse: bool = False) -> SweepEngine:
    """Resolve ``engine`` for ``device`` and build a reusable engine."""
    if precision not in PRECISIONS:
        raise ValueError(f"precision must be one of {PRECISIONS}, got {precision!r}")
    device = torch.device(device)
    return SweepEngine(name=resolve_engine(engine, device, use_kron_reuse), device=device,
                       precision=precision, fuse_core=fuse_core,
                       use_kron_reuse=use_kron_reuse)


def available_engines() -> List[str]:
    """Engines that can run here: ``torch`` always; ``cuda`` when a CUDA
    device is present and every kernel builds (``nvcc`` at first use)."""
    from repro_torch.kernels import _build

    out = ["torch"]
    if torch.cuda.is_available():
        try:
            _build.build_all()
        except RuntimeError:  # no nvcc, or a source that does not compile
            return out
        out.append("cuda")
    return out
