"""Sharded sparse HOOI over ``torch.distributed`` (SPMD, data parallel).

Port of ``repro.core.distributed``. The reference shards the nonzeros over
a JAX device mesh inside one ``shard_map`` program; the port runs the same
scheme as SPMD over a process group, every rank running the same Python:

  * the nonzeros (COO rows) are padded with explicit zeros to an even
    multiple of the world size and each rank keeps its contiguous slice
    on its own device (``sparse.layout.build_shard_schedule``);
  * the factor matrices are replicated (they are small: I_n x R_n): each
    call starts from rank 0's initial factors, by one broadcast
    (``ShardedSweepEngine.replicate``);
  * each rank runs the Kron accumulation over its slice, a partial Y_(n),
    and one ``all_reduce`` (sum) over the group completes it
    (``core.engine.ShardedSweepEngine``): the scatter-add is linear in the
    nonzeros, so the partial sums add up;
  * the factor update runs replicated on every rank. The sweeps need no
    broadcast: a ring all-reduce (NCCL's, gloo's) hands every rank the same bits, so
    every rank's QRP sees the same input and returns the same factors.

A sweep's communication is N all-reduces of I_n x prod_{t != n} R_t
elements, whatever the nnz (:func:`psum_bytes_per_sweep`, reported per call
as ``TuckerResult.collective_bytes_per_sweep``).

The library never initialises a process group: the caller does (torchrun,
a test, ``chip_smoke.py``) and sets each rank's card
(``torch.cuda.set_device(LOCAL_RANK)``). Without a group, a sharded spec of
one device is a world of one with no collective. NCCL serves ranks on their
own cards; ranks that share one card need gloo (NCCL refuses two ranks on
one device), which stages each all-reduce through the host.
"""
from __future__ import annotations

import dataclasses
import warnings
from typing import Any, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.core.coo import SparseCOO
from repro_torch.sparse.layout import build_shard_schedule

__all__ = [
    "ShardMesh",
    "hooi_sparse_distributed",
    "psum_bytes_per_sweep",
    "shard_nonzeros",
    "world_size",
]


@dataclasses.dataclass(frozen=True)
class ShardMesh:
    """The ranks a sharded plan runs on: the port's twin of the reference's
    one-axis ``jax.sharding.Mesh``, built by
    :func:`repro_torch.tucker.planning.mesh_for_shard`.

    Attributes:
      group: the ``torch.distributed`` process group, or None for a world
        of one (no collective at all).
      world_size: ranks in the group, the shards of the nonzeros.
      rank: this process's rank in the group.
      axis: the name of the nonzero axis (``ShardSpec.axis``).
      devices: each rank's device, in rank order (``"cuda:0"``, ``"cpu"``).
    """

    group: Any
    world_size: int
    rank: int
    axis: str
    devices: Tuple[str, ...]

    @property
    def device(self) -> torch.device:
        """This rank's device."""
        return torch.device(self.devices[self.rank])

    @property
    def backend(self) -> str:
        """The group's backend (``"nccl"``, ``"gloo"``), or ``"none"``."""
        return "none" if self.group is None else str(dist.get_backend(self.group))


def world_size(group: Any = None) -> int:
    """Ranks in ``group``, else in the default group when one is
    initialised, else 1 (a process without a group is a world of one)."""
    if group is not None:
        return int(dist.get_world_size(group))
    if dist.is_available() and dist.is_initialized():
        return int(dist.get_world_size())
    return 1


def psum_bytes_per_sweep(shape: Sequence[int], ranks: Sequence[int],
                         dtype=torch.float32) -> int:
    """Collective payload of one ALS sweep: N all-reduces, one per mode,
    each of the whole partial unfolding Y_(n), I_n x prod_{t != n} R_t
    elements at the working precision (a torch or numpy dtype). The
    quantity does not depend on nnz."""
    if isinstance(dtype, torch.dtype):
        itemsize = torch.empty((), dtype=dtype).element_size()
    else:
        itemsize = int(np.dtype(dtype).itemsize)
    shape, ranks = tuple(shape), tuple(ranks)
    total = 0
    for mode, dim in enumerate(shape):
        k = int(np.prod([r for t, r in enumerate(ranks) if t != mode]))
        total += int(dim) * k * itemsize
    return total


def shard_nonzeros(coo: SparseCOO, mesh: ShardMesh,
                   target_nnz: Optional[int] = None) -> SparseCOO:
    """This rank's shard of ``coo`` on ``mesh``: its slice of the nonzeros
    padded to an even multiple of the world size, on its device, as a COO
    tensor of ``coo``'s shape (``sparse.layout.build_shard_schedule``)."""
    return build_shard_schedule(coo, mesh, target_nnz=target_nnz).coo


def hooi_sparse_distributed(coo: SparseCOO, ranks: Sequence[int], group: Any = None,
                            n_iter: int = 5, method: str = "gram",
                            generator: Optional[torch.Generator] = None, device="cuda"):
    """Data-parallel Alg. 2 over a process group (``group``, or the default
    group, or a world of one without one); every rank calls it with the same
    tensor.

    .. deprecated:: use ``repro_torch.tucker`` with
       ``TuckerSpec(shard=ShardSpec(num_devices=...))``; this shim shards
       over every rank of the group and delegates to
       ``tucker.plan(spec, mesh=...)``.
    """
    from repro_torch import tucker  # the tucker package imports this module's users

    warnings.warn(
        "hooi_sparse_distributed is deprecated; use repro_torch.tucker.plan with "
        "TuckerSpec(shard=ShardSpec(num_devices=...)).",
        DeprecationWarning,
        stacklevel=2,
    )
    shard = tucker.ShardSpec(num_devices=world_size(group))
    spec = tucker.TuckerSpec(shape=tuple(coo.shape), ranks=tuple(ranks), method=method,
                             n_iter=n_iter, shard=shard)
    mesh = tucker.mesh_for_shard(shard, group, device=device)
    return tucker.plan(spec, device=device, mesh=mesh)(coo, generator=generator)
