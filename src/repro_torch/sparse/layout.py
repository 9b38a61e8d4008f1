"""The per-mode sweep schedule: nonzeros grouped by output row block, the
Kron-reuse dedup, and the batch assembly of same-shape tensors.

Port of ``repro.sparse.layout``, with the shard padding of the sharded
sweeps (:func:`build_shard_schedule`) and the paper's Sec. III-C Kron reuse
(:func:`build_kron_reuse`: each distinct tuple of non-mode coordinates
once, built with ``torch.unique`` on the tensor's device). The schedule is built
with torch ops on whatever device the indices live on, so a tensor already
on the card is scheduled there (three stable sorts of the nonzeros, which on
the host take minutes at tens of millions of nonzeros). The arrays are
exactly those of the numpy reference: ``torch.sort(stable=True)`` and
numpy's stable argsort give the one stable permutation.
"""
from __future__ import annotations

import dataclasses
import math
from typing import List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.coo import SparseCOO


class KronReusePlan(NamedTuple):
    """The dedup of one mode's non-mode coordinate tuples (the paper's Kron
    reuse, Sec. III-C), on the device of the tensor it was built from.
    ``modes`` is the descending non-mode order of
    :func:`repro_torch.core.kron.kron_rows`'s columns."""

    unique_indices: torch.Tensor  # (n_unique, N-1) int32, rows into the non-mode factors
    inverse: torch.Tensor  # (nnz,) int32: nonzero -> its unique Kron row
    modes: Tuple[int, ...]

    def with_values(self, values: torch.Tensor) -> "KronReusePlan":
        """The same plan: it depends on the coordinates only."""
        return self


def build_kron_reuse(coo: SparseCOO, skip_mode: int) -> KronReusePlan:
    """Deduplicate the (N-1)-tuples of non-mode coordinates so that each
    distinct Kronecker row is computed once, in the original nonzero order.

    The reference sorts on the host (``np.unique(axis=0,
    return_inverse=True)``); ``torch.unique(dim=0, return_inverse=True)``
    sorts the rows lexicographically too, on the tensor's own device, so
    ``unique_indices`` and ``inverse`` are the reference's arrays."""
    modes = tuple(t for t in range(coo.ndim - 1, -1, -1) if t != skip_mode)
    sub = coo.indices[:, list(modes)]
    if sub.shape[0] == 0:
        return KronReusePlan(sub.to(torch.int32), sub.new_zeros((0,), dtype=torch.int32),
                             modes)
    uniq, inverse = torch.unique(sub, dim=0, return_inverse=True)
    return KronReusePlan(uniq.to(torch.int32), inverse.reshape(-1).to(torch.int32), modes)


class SortedCOO(NamedTuple):
    """Nonzeros of one tensor, permuted into mode-major row-block order and
    padded to block multiples: the engine's per-mode streaming schedule.

    All tensors live on the device of the indices they were built from.
    Padding slots carry ``valid == 0`` and a safe gather index of 0.
    """

    mode: int
    shape: Tuple[int, ...]
    order: torch.Tensor  # (nnz_padded,) int32 gather index into the nonzeros
    valid: torch.Tensor  # (nnz_padded,) f32 1.0 real / 0.0 padding
    rel_row: torch.Tensor  # (nnz_padded,) int32 row within the target block
    blkmap: torch.Tensor  # (n_blocks,) int32 target row block of each nnz block
    first: torch.Tensor  # (n_blocks,) int32 1 iff first block of its target
    last: torch.Tensor  # (n_blocks,) int32 1 iff last block of its target
    segments: torch.Tensor  # (I_mode + 1,) int64 row boundaries (sorted order)
    n_row_blocks: int
    bn: int  # nonzeros per block
    bi: int  # output rows per block
    # keep-mask over output rows; None when every row block is visited.
    row_mask: Optional[torch.Tensor] = None

    @property
    def nnz_padded(self) -> int:
        return int(self.order.shape[0])


def build_schedule(rows: torch.Tensor, n_rows: int, bn: int, bi: int):
    """Stable-sort ``rows``, group into BI-row output blocks, and pad each
    group to a BN multiple so every nnz block targets exactly one row block.

    Returns ``(order, valid, rel_row, blkmap, first, last, n_row_blocks,
    perm)`` as in the reference: ``order`` holds safe gather indices
    (padding slots point at 0 with ``valid == 0``), ``first``/``last`` flag
    each group's boundary blocks, and ``perm`` is the plain stable sort by
    row (before padding).
    """
    if bn <= 0 or bi <= 0:
        raise ValueError(f"block sizes must be positive, got bn={bn} bi={bi}")
    rows = torch.as_tensor(rows).to(torch.int64)
    dev = rows.device
    nnz = int(rows.shape[0])
    n_row_blocks = max(1, -(-n_rows // bi))
    sorted_rows, perm = torch.sort(rows, stable=True)
    grp_bounds = torch.searchsorted(
        sorted_rows, torch.arange(0, n_row_blocks + 1, device=dev) * bi
    )
    cnt = torch.diff(grp_bounds)  # nonzeros per row-block group
    blocks_per_grp = -(-cnt // bn)  # ceil; 0 for empty groups
    padded_len = blocks_per_grp * bn
    total = int(padded_len.sum())
    if total == 0:  # empty tensor: one all-padding block
        order = torch.full((bn,), -1, dtype=torch.int64, device=dev)
        blkmap = torch.zeros((1,), dtype=torch.int32, device=dev)
        first = torch.ones((1,), dtype=torch.int32, device=dev)
    else:
        zero = torch.zeros((1,), dtype=torch.int64, device=dev)
        out_start = torch.cat([zero, torch.cumsum(padded_len, 0)[:-1]])
        order = torch.full((total,), -1, dtype=torch.int64, device=dev)
        # destination slot of each sorted nonzero: its group's output offset
        # plus its position within the group.
        grp_of = torch.repeat_interleave(
            torch.arange(n_row_blocks, device=dev), cnt, output_size=nnz
        )
        dest = out_start[grp_of] + (
            torch.arange(nnz, device=dev) - grp_bounds[:-1][grp_of]
        )
        order[dest] = perm
        n_blocks = total // bn
        blkmap = torch.repeat_interleave(
            torch.arange(n_row_blocks, dtype=torch.int32, device=dev),
            blocks_per_grp, output_size=n_blocks,
        )
        first = torch.zeros((n_blocks,), dtype=torch.int32, device=dev)
        blk_start = torch.cat([zero, torch.cumsum(blocks_per_grp, 0)[:-1]])
        first[blk_start[blocks_per_grp > 0]] = 1
    # a group's last block sits right before the next group's first.
    last = torch.empty_like(first)
    last[:-1] = first[1:]
    last[-1] = 1
    valid = (order >= 0).to(torch.float32)
    safe = torch.where(order >= 0, order, 0)
    rel = rows[safe] % bi if nnz else torch.zeros_like(safe)
    rel = torch.where(order >= 0, rel, 0)
    return (
        safe.to(torch.int32), valid, rel.to(torch.int32), blkmap, first, last,
        n_row_blocks, perm,
    )


def visited_row_mask(
    blkmap: torch.Tensor, n_row_blocks: int, bi: int, n_rows: int
) -> Optional[torch.Tensor]:
    """Keep-mask over output rows whose row block no nnz block targets;
    ``None`` means every row block is visited."""
    visited = torch.zeros((n_row_blocks,), dtype=torch.bool, device=blkmap.device)
    visited[blkmap.long()] = True
    if bool(visited.all()):
        return None
    return torch.repeat_interleave(visited, bi)[:n_rows]


def build_mode_layout(coo: SparseCOO, mode: int, bn: int = 128,
                      bi: int = 128) -> SortedCOO:
    """The mode-``mode`` schedule of one tensor (see :func:`build_schedule`)
    plus its per-row segment boundaries, on the tensor's device."""
    rows = coo.indices[:, mode].to(torch.int64)
    n_rows = int(coo.shape[mode])
    order, valid, rel, blkmap, first, last, n_row_blocks, perm = build_schedule(
        rows, n_rows, bn, bi
    )
    segments = torch.searchsorted(
        rows[perm], torch.arange(n_rows + 1, device=rows.device)
    )
    return SortedCOO(
        mode=mode, shape=tuple(coo.shape), order=order, valid=valid,
        rel_row=rel, blkmap=blkmap, first=first, last=last,
        segments=segments.to(torch.int64), n_row_blocks=n_row_blocks,
        bn=bn, bi=bi,
        row_mask=visited_row_mask(blkmap, n_row_blocks, bi, n_rows),
    )


def layout_padding_fraction(layout: SortedCOO) -> float:
    """Share of the schedule's slots that are padding, the price of block
    alignment."""
    return 1.0 - float(layout.valid.sum()) / max(1, layout.nnz_padded)


def slot_rows(sched) -> torch.Tensor:
    """Absolute output row of every schedule slot (int64); padding slots
    point at the first row of their block."""
    return (torch.repeat_interleave(sched.blkmap.long(), sched.bn) * sched.bi
            + sched.rel_row.long())


# Work split of the unfolding kernel: about this many schedule slots per
# CTA, at most this many CTAs. Ranges snap to row starts, so a tensor whose
# rows hold more slots than this gets one row per CTA; on the card, many
# small ranges beat a few waves of large ones (see PERF.md).
SLOTS_PER_PART = 1024
MAX_PARTS = 65536


def row_parts(layout, n_parts: Optional[int] = None,
              slots_per_part: int = SLOTS_PER_PART) -> torch.Tensor:
    """Cut the schedule's slots into about ``n_parts`` ranges of equal size
    (by default one per ``slots_per_part`` slots, at most ``MAX_PARTS``),
    each starting at the first slot of a row, so that no output row crosses
    two ranges. Returns the (n_cuts + 1,) int64 range boundaries, the last
    being ``nnz_padded``.

    The unfolding kernel gives each range to one CTA, which then owns every
    row that starts in it: it sums them in registers and writes them with
    plain stores, no atomics. Padding slots sit at the end of their group,
    after that group's real rows, so they stay in the range of a real row of
    their group (they carry value 0).
    """
    nnzp = int(layout.rel_row.shape[0])
    dev = layout.rel_row.device
    if slots_per_part < 1:
        raise ValueError(f"slots_per_part must be >= 1, got {slots_per_part}")
    if n_parts is None:
        n_parts = min(MAX_PARTS, max(1, -(-nnzp // slots_per_part)))
    rows = slot_rows(layout)
    real = layout.valid > 0
    start = real.clone()
    start[1:] &= (rows[1:] != rows[:-1]) | ~real[:-1]
    starts = torch.nonzero(start).flatten()
    if starts.numel() == 0:  # all padding: one range, nothing to sum
        return torch.tensor([0, nnzp], dtype=torch.int64, device=dev)
    targets = torch.arange(n_parts, device=dev, dtype=torch.int64) * nnzp // n_parts
    pick = torch.searchsorted(starts, targets).clamp_(max=starts.numel() - 1)
    cuts = torch.unique(starts[pick])  # sorted; starts[0] == 0 for nnz > 0
    return torch.cat([cuts, torch.tensor([nnzp], dtype=torch.int64, device=dev)])


# the chain kernel's ranges hold at most slots_per_part slots, and fewer on a
# small tensor, so that it still gives the card about this many warps (an
# H100 holds 132 SMs x 16 of them)
CHAIN_MIN_RANGES = 2048


def chain_range_slots(nnzp: int, slots_per_part: int = SLOTS_PER_PART) -> int:
    """Slots a range of the order >= 4 chain kernel holds for ``nnzp``
    slots: ``slots_per_part``, or fewer when that would give fewer than
    ``CHAIN_MIN_RANGES`` ranges (then a multiple of 32, the kernel's chunk,
    and at least 32)."""
    per = -(-nnzp // CHAIN_MIN_RANGES)
    return min(slots_per_part, max(32, -(-per // 32) * 32))


def even_cuts(nnzp: int, slots_per_range: int = SLOTS_PER_PART, device=None) -> torch.Tensor:
    """Cut ``nnzp`` slots into ranges of ``slots_per_range`` slots (the last
    one shorter), wherever the rows fall: the (n_ranges + 1,) int64
    boundaries, built on ``device``. The order >= 4 unfolding kernel
    (``csrc/kron_chain_scatter.cu``) gives each range to one warp, so a row
    longer than a range spreads over several warps and every warp does the
    same work; the rows a range shares with its neighbours are summed from
    per-range partials in range order."""
    if slots_per_range < 1:
        raise ValueError(f"slots_per_range must be >= 1, got {slots_per_range}")
    n_ranges = max(1, -(-nnzp // slots_per_range))
    cuts = torch.arange(n_ranges + 1, dtype=torch.int64, device=device) * slots_per_range
    return cuts.clamp_(max=nnzp)


def operand_modes(n: int, mode: int) -> Tuple[int, ...]:
    """The modes whose factor rows form a mode-``mode`` Kron row, in
    descending order (the last varies fastest)."""
    return tuple(t for t in range(n - 1, -1, -1) if t != mode)


@dataclasses.dataclass(frozen=True)
class DeviceSchedule:
    """One mode's schedule as the unfolding needs it, its tensors on the
    sweep's device, moved there once (a no-op when the layout was built
    there) and reused every sweep. ``parts`` is the unfolding kernel's
    row-aligned work split (:func:`row_parts`); the kernel needs no
    ``first``/``last`` block flags, so they stay on the layout.
    ``chain_cuts`` is the order >= 4 kernel's split, ranges of equal length
    that ignore row starts (:func:`even_cuts`, :func:`chain_range_slots`);
    None below order 4.

    ``idx`` and ``vals`` are the tensor's nonzeros in slot order, built once
    because they do not change between sweeps: ``idx`` (nnz_padded, N - 1)
    int32 holds each slot's coordinates in the modes of
    :func:`operand_modes` (``indices[order]`` without the mode's own
    column), ``vals`` (nnz_padded,) ``values[order] * valid`` (0 on
    padding slots). At NELL-2 size they take ~0.9 GB a mode.

    A Kron-reuse schedule (:meth:`from_kron_plan`) holds the dedup alone:
    ``kron_unique``, ``kron_inverse`` and ``kron_modes``, every scatter
    field None, as the reference's."""

    order: Optional[torch.Tensor]
    valid: Optional[torch.Tensor]
    rel_row: Optional[torch.Tensor]
    blkmap: Optional[torch.Tensor]
    row_mask: Optional[torch.Tensor]
    parts: Optional[torch.Tensor]
    idx: Optional[torch.Tensor]
    vals: Optional[torch.Tensor]
    mode: int
    shape: Tuple[int, ...]
    n_row_blocks: int
    bn: int
    bi: int
    kron_unique: Optional[torch.Tensor] = None
    kron_inverse: Optional[torch.Tensor] = None
    kron_modes: Optional[Tuple[int, ...]] = None
    chain_cuts: Optional[torch.Tensor] = None

    @classmethod
    def from_layout(cls, layout, coo: SparseCOO, device=None, *,
                    mode: Optional[int] = None,
                    slots_per_part: int = SLOTS_PER_PART) -> "DeviceSchedule":
        """The schedule of ``layout`` (a :class:`SortedCOO`, or a
        ``kron_kernel.ScatterPlan`` with its ``mode`` given), built from
        ``coo``, on ``device`` (the layout's by default), its row split at
        about ``slots_per_part`` slots a range (:func:`row_parts`) and, for
        an order >= 4 tensor, the chain kernel's cuts of exactly that many,
        or fewer on a small tensor (:func:`chain_range_slots`,
        :func:`even_cuts`)."""
        dev = torch.device(device) if device is not None else layout.order.device
        mode = layout.mode if mode is None else mode

        def put(t):
            return None if t is None else t.to(dev)

        order = put(layout.order)
        valid = put(layout.valid)
        nnzp = int(order.shape[0])
        cols = list(operand_modes(coo.ndim, mode))
        idx = _in_slot_order(coo.indices.to(dev)[:, cols], order)
        return cls(
            order=order, valid=valid,
            rel_row=put(layout.rel_row), blkmap=put(layout.blkmap),
            row_mask=put(layout.row_mask),
            parts=put(row_parts(layout, slots_per_part=slots_per_part)),
            idx=idx, vals=slot_values(coo.values.to(dev), order, valid),
            mode=mode, shape=tuple(coo.shape),
            n_row_blocks=layout.n_row_blocks, bn=layout.bn, bi=layout.bi,
            chain_cuts=(even_cuts(nnzp, chain_range_slots(nnzp, slots_per_part), dev)
                        if coo.ndim >= 4 else None),
        )

    @classmethod
    def from_kron_plan(cls, plan: KronReusePlan, mode: int, shape: Tuple[int, ...],
                       device=None) -> "DeviceSchedule":
        """The Kron-reuse dedup alone, on ``device`` (the plan's by default):
        the reuse chain needs no scatter schedule."""
        dev = torch.device(device) if device is not None else plan.inverse.device
        return cls(order=None, valid=None, rel_row=None, blkmap=None, row_mask=None,
                   parts=None, idx=None, vals=None, mode=mode, shape=tuple(shape),
                   n_row_blocks=0, bn=0, bi=0,
                   kron_unique=plan.unique_indices.to(dev),
                   kron_inverse=plan.inverse.to(dev), kron_modes=tuple(plan.modes))

    def with_values(self, values: torch.Tensor) -> "DeviceSchedule":
        """The same schedule for a tensor with the same coordinates and
        other ``values`` (a Kron-reuse schedule holds no values)."""
        if self.order is None:
            return self
        return dataclasses.replace(
            self, vals=slot_values(values.to(self.order.device), self.order, self.valid))


def _in_slot_order(t: torch.Tensor, order: torch.Tensor) -> torch.Tensor:
    """Rows of ``t`` in slot order; zeros when ``t`` is empty (an empty
    tensor's schedule is one block of padding slots)."""
    if t.shape[0] == 0:
        return t.new_zeros((order.shape[0],) + tuple(t.shape[1:]))
    return t.index_select(0, order)


def slot_values(values: torch.Tensor, order: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """``values`` in slot order, 0 on padding slots."""
    return _in_slot_order(values, order) * valid


# -- shards of the nonzeros across the ranks of a shard mesh -----------------


def shard_pad_nnz(nnz: int, n_shards: int) -> int:
    """Padded nnz for even sharding: the least multiple of ``n_shards``
    that is >= ``nnz`` and >= ``n_shards`` (every shard owns at least one
    slot, even for an empty tensor). The one place the shard padding math
    lives, as in the reference."""
    if int(n_shards) < 1:
        raise ValueError(f"n_shards must be >= 1, got {n_shards}")
    if int(nnz) < 0:
        raise ValueError(f"nnz must be >= 0, got {nnz}")
    n_shards = int(n_shards)
    return max(((int(nnz) + n_shards - 1) // n_shards) * n_shards, n_shards)


@dataclasses.dataclass(frozen=True)
class ShardSchedule:
    """One rank's share of a tensor's nonzeros, on the rank's device.

    The nonzeros are padded with explicit zeros (index 0, value 0: they add
    nothing to any contraction) to a :func:`shard_pad_nnz` multiple, and
    rank r owns the r-th contiguous slice of that padded stream. Only the
    slice is copied to the rank's device, once; the whole tensor stays
    where the caller keeps it (in a world of one, a tensor already on the
    rank's device is its own slice). ``indices`` and ``values`` are the slice,
    :attr:`coo` the slice as a tensor of the whole tensor's shape. The
    counters describe the real nonzeros (``nnz``), not the padding.
    """

    indices: torch.Tensor  # (nnz_padded / n_shards, N) int32, this rank's slice
    values: torch.Tensor  # (nnz_padded / n_shards,)
    shape: Tuple[int, ...]
    mesh: object  # repro_torch.core.distributed.ShardMesh
    n_shards: int
    rank: int
    nnz: int  # real stored nonzeros of the whole tensor (before padding)
    nnz_padded: int

    @property
    def coo(self) -> SparseCOO:
        """This rank's slice as a COO tensor of the whole tensor's shape."""
        return SparseCOO(self.indices, self.values, self.shape)

    @property
    def shard_counts(self) -> np.ndarray:
        """Real (non-padding) nonzeros owned by each shard. Padding is
        appended, so shards are contiguous slices of the padded stream."""
        per = self.nnz_padded // self.n_shards
        starts = np.arange(self.n_shards) * per
        return np.clip(self.nnz - starts, 0, per)

    @property
    def imbalance(self) -> float:
        """Load imbalance across shards: ``1 - min/max`` of per-shard real
        nnz (0.0 = perfectly even; 1.0 when some shard is all padding).
        Reported per call as ``TuckerResult.shard_imbalance``."""
        counts = self.shard_counts
        mx = int(counts.max())
        if mx == 0:
            return 0.0
        return 1.0 - int(counts.min()) / mx

    def with_values(self, values: torch.Tensor) -> "ShardSchedule":
        """The same slice for a tensor with the same coordinates and other
        ``values`` (the whole tensor's): only the values are sliced again."""
        per = self.nnz_padded // self.n_shards
        return dataclasses.replace(self, values=_shard_slice(
            values, self.rank * per, per, self.values.device))


def _shard_slice(t: torch.Tensor, start: int, length: int, device) -> torch.Tensor:
    """Rows ``start:start + length`` of ``t`` padded with zeros past its
    end, on ``device``: ``t`` itself when that is all of it and it is
    already there (a world of one holds the tensor once), else a new
    tensor (never a view that would keep the whole of ``t`` alive there)."""
    if start == 0 and length == t.shape[0] and t.device == torch.device(device):
        return t
    real = t[min(start, t.shape[0]):min(start + length, t.shape[0])].to(device)
    pad = real.new_zeros((length - real.shape[0],) + tuple(t.shape[1:]))
    return torch.cat([real, pad])


def build_shard_schedule(coo: SparseCOO, mesh, target_nnz: Optional[int] = None) -> ShardSchedule:
    """This rank's :class:`ShardSchedule` of ``coo`` on ``mesh`` (a
    :class:`~repro_torch.core.distributed.ShardMesh`): the nonzeros padded
    to a :func:`shard_pad_nnz` multiple of the mesh's world size, and the
    rank's contiguous slice copied to its device.

    ``target_nnz`` raises the pad floor (a serving bucket, as in the
    reference); the schedule still records the real stored nnz, so
    ``shard_counts`` and ``imbalance`` tell where the real nonzeros sit.
    """
    n_shards, rank = int(mesh.world_size), int(mesh.rank)
    nnz = coo.nnz
    floor = max(nnz, int(target_nnz)) if target_nnz is not None else nnz
    padded = shard_pad_nnz(floor, n_shards)
    per = padded // n_shards
    dev = mesh.device
    return ShardSchedule(
        indices=_shard_slice(coo.indices, rank * per, per, dev),
        values=_shard_slice(coo.values, rank * per, per, dev),
        shape=tuple(coo.shape), mesh=mesh, n_shards=n_shards, rank=rank,
        nnz=nnz, nnz_padded=padded,
    )


# -- batches of same-shape tensors ---------------------------------------------


def bucket_nnz(nnz: int, base: int = 512, growth: float = 2.0) -> int:
    """Smallest bucket boundary >= ``nnz`` on the geometric grid
    ``base, ceil(base*growth), ceil(base*growth^2), ...``.

    ``nnz = 0`` maps to ``base`` (a bucket is a pad *target*, never smaller
    than one block of real capacity).
    """
    if int(base) < 1:
        raise ValueError(f"bucket base must be >= 1, got {base}")
    if not growth > 1.0:
        raise ValueError(f"bucket growth must be > 1, got {growth}")
    if int(nnz) < 0:
        raise ValueError(f"nnz must be >= 0, got {nnz}")
    b = int(base)
    while b < int(nnz):
        b = int(math.ceil(b * float(growth)))
    return b


def _batch_members(coos: Sequence[SparseCOO], what: str):
    """The common (shape, value dtype, device) of a batch, checked."""
    if not coos:
        raise ValueError(f"{what} needs at least one tensor")
    shapes = {tuple(c.shape) for c in coos}
    if len(shapes) != 1:
        raise ValueError(f"{what} needs same-shape tensors, got {shapes}")
    dtypes = {c.values.dtype for c in coos}
    if len(dtypes) != 1:
        # silent promotion would run narrow members at a wider dtype and
        # break batched-vs-sequential parity; make the caller decide
        raise ValueError(
            f"{what} needs one common value dtype, got "
            f"{sorted(str(d) for d in dtypes)}: cast the members, or plan with "
            f"a concrete spec dtype"
        )
    devices = {c.device for c in coos}
    if len(devices) != 1:
        raise ValueError(f"{what} needs the members on one device, got {devices}")
    return shapes.pop(), dtypes.pop(), devices.pop()


def pad_coo_batch(coos: Sequence[SparseCOO], target_nnz: Optional[int] = None):
    """Stack k same-shape COO tensors into batched ``(k, nnz_pad, N)`` int32
    index and ``(k, nnz_pad)`` value tensors on the members' device, each
    padded with explicit zeros (the padding convention of
    ``SparseCOO.pad_to``: index 0, value 0).

    ``target_nnz=None`` pads to the batch max; anything smaller than the
    batch max is an error: padding never drops nonzeros. (The port's batched
    sweeps stack the members block-diagonally instead,
    :func:`stack_coo_batch`, and pad nothing.)
    """
    shape, dtype, dev = _batch_members(coos, "pad_coo_batch")
    nnz_max = max(c.nnz for c in coos)
    target = nnz_max if target_nnz is None else int(target_nnz)
    if target < nnz_max:
        raise ValueError(
            f"target_nnz={target} would drop nonzeros: batch max nnz is {nnz_max}"
        )
    idx = torch.zeros((len(coos), target, len(shape)), dtype=torch.int32, device=dev)
    val = torch.zeros((len(coos), target), dtype=dtype, device=dev)
    for b, c in enumerate(coos):
        idx[b, :c.nnz] = c.indices
        val[b, :c.nnz] = c.values
    return idx, val


def stack_coo_batch(coos: Sequence[SparseCOO]) -> Tuple[SparseCOO, List[int]]:
    """The block-diagonal stack of k same-shape tensors: one COO tensor of
    shape (k I_1, ..., k I_N) in which member i's coordinates are offset by
    i I_m in every mode m, on the members' device.

    One unfolding of the stack is the k members' unfoldings one under the
    other: rows i I_n ... (i + 1) I_n - 1 of its mode-n unfolding hold member
    i's nonzeros contracted with rows i I_m ... of the stacked factors,
    member i's own, and nothing mixes members. Returns the stack and the
    (k + 1,) nonzero offsets: member i's nonzeros are the stack's
    ``offsets[i]:offsets[i + 1]``, in their own order.
    """
    shape, _, dev = _batch_members(coos, "stack_coo_batch")
    k = len(coos)
    if k * max(shape) >= 2 ** 31:
        raise ValueError(f"{k} members of shape {shape}: stacked coordinates overflow int32")
    counts = [c.nnz for c in coos]
    offsets = [0]
    for n in counts:
        offsets.append(offsets[-1] + n)
    member = torch.repeat_interleave(
        torch.arange(k, dtype=torch.int32, device=dev),
        torch.tensor(counts, device=dev), output_size=offsets[-1])
    base = torch.tensor(shape, dtype=torch.int32, device=dev)
    idx = torch.cat([c.indices.to(torch.int32) for c in coos]) + member[:, None] * base
    vals = torch.cat([c.values for c in coos])
    return SparseCOO(idx, vals, tuple(k * s for s in shape)), offsets
