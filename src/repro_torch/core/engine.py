"""Sweep engine: where each ALS sweep's two hot loops run, plus the cached
per-mode schedules of the tensor being decomposed.

Port of ``repro.core.engine``. Both engines run one code path — the
schedule-ordered unfolding (``kernels.ops``) and the core update, either the
TTM kernel on the materialised last unfolding or, with ``fuse_core``, the
megakernel that rebuilds it from the nonzeros — and differ only in the
device of their tensors:

  ``cuda``   the hand-written CUDA kernels, on a CUDA device;
  ``torch``  their plain PyTorch versions, on the CPU;
  ``auto``   ``cuda`` on a CUDA device, ``torch`` on the CPU.

Nothing on the card selects the plain versions.
"""
from __future__ import annotations

import dataclasses
import weakref
from typing import Dict, List, Optional, Sequence

import torch

from repro_torch.core.coo import SparseCOO
from repro_torch.kernels import ops
from repro_torch.kernels.kron_kernel import DEFAULT_BI, DEFAULT_BN, PRECISIONS
from repro_torch.sparse.layout import SLOTS_PER_PART, DeviceSchedule, build_mode_layout

ENGINES = ("auto", "cuda", "torch")
JAX_ENGINES = ("xla", "pallas")


def resolve_engine(engine: str, device) -> str:
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
    if engine == "torch" and on_card:
        raise ValueError(
            "engine='torch' runs the plain versions of the kernels, which the "
            "port never selects on a CUDA device: use engine='auto' or 'cuda'"
        )
    return engine


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
    # the schedule's geometry (nonzeros per block, rows per block) and the
    # unfolding kernel's row split: the launch parameters the autotuner sets
    # (``apply_blocks``); the defaults are the hand-picked ones.
    bn: int = DEFAULT_BN
    bi: int = DEFAULT_BI
    slots_per_part: int = SLOTS_PER_PART
    # per-mode schedule builds, cumulative; the plan reports per-call deltas.
    schedule_builds: int = 0
    dev_schedules: Dict[int, DeviceSchedule] = dataclasses.field(default_factory=dict)
    # weakref to the indices tensor the caches were built from: a live
    # referent makes the identity check sound without pinning the tensor.
    _bound_indices: Optional["weakref.ref"] = None
    _bound_shape: Optional[tuple] = None
    # the values the schedules' slot values were taken from, and their
    # version counter then (in-place writes move it)
    _bound_values: Optional["weakref.ref"] = None
    _bound_values_version: int = -1

    def _bind(self, coo: SparseCOO) -> None:
        bound = self._bound_indices() if self._bound_indices is not None else None
        if bound is not coo.indices or self._bound_shape != coo.shape:
            self.dev_schedules.clear()

            # drop the schedules with the tensor: they are O(nnz) memory.
            def _release(_ref, cache=self.dev_schedules):
                cache.clear()

            self._bound_indices = weakref.ref(coo.indices, _release)
            self._bound_shape = tuple(coo.shape)
        values = self._bound_values() if self._bound_values is not None else None
        version = coo.values._version
        # same coordinates, other values: no new sort
        if values is not coo.values or self._bound_values_version != version:
            for mode, sched in self.dev_schedules.items():
                self.dev_schedules[mode] = sched.with_values(coo.values)
            self._bound_values = weakref.ref(coo.values)
            self._bound_values_version = version

    def device_schedule(self, coo: SparseCOO, mode: int) -> DeviceSchedule:
        """The mode's schedule on the engine's device, built once."""
        self._bind(coo)
        if mode not in self.dev_schedules:
            self.dev_schedules[mode] = DeviceSchedule.from_layout(
                build_mode_layout(coo, mode, bn=self.bn, bi=self.bi), coo, self.device,
                slots_per_part=self.slots_per_part,
            )
            self.schedule_builds += 1
        return self.dev_schedules[mode]

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
        """Y_(mode): (I_mode, prod_{t != mode} R_t), f32 (Alg. 2 line 5)."""
        return ops.sparse_ttm_chain_device(
            coo.indices, coo.values, factors, mode,
            self.device_schedule(coo, mode),
            shape=tuple(coo.shape), precision=self.precision,
        )

    def core_unfolding(self, y_n: torch.Tensor, u_last: torch.Tensor) -> torch.Tensor:
        """G_(N) = U_N^T Y_(N) (Eq. 12), through the TTM kernel on the
        transposed views (no copy of the unfolding)."""
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
        runs the kernels' plain versions), so both honour the flag."""
        n = coo.ndim
        if self.fuse_core and n <= 3:
            return ops.sparse_ttm_core_device(
                coo.indices, coo.values, factors, n - 1,
                self.device_schedule(coo, n - 1),
                shape=tuple(coo.shape), precision=self.precision,
            )
        return self.core_unfolding(y_n, factors[n - 1])


def make_engine(engine: str = "auto", device="cuda", *,
                precision: str = "fp32", fuse_core: bool = False) -> SweepEngine:
    """Resolve ``engine`` for ``device`` and build a reusable engine."""
    if precision not in PRECISIONS:
        raise ValueError(f"precision must be one of {PRECISIONS}, got {precision!r}")
    device = torch.device(device)
    return SweepEngine(name=resolve_engine(engine, device), device=device,
                       precision=precision, fuse_core=fuse_core)


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
