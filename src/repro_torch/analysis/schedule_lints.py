"""Scatter-race lint: prove that the unfolding kernels' writes are disjoint
from the schedule arrays they index, and that their launch fits the card's
shared memory.

Port of ``repro.analysis.schedule_lints``. The port's kernels 1 and 5
(``csrc/kron_scatter.cu``, ``csrc/kron_scatter_ttm.cu``, both on the warp
walk of ``csrc/kron_walk.cuh``) sum without atomics, so their correctness
rests on exactly these properties of the mode's schedule:

  * the slot of every nonzero: ``order`` is a permutation of the nonzeros
    over the valid slots, and slot t writes row
    ``blkmap[t // bn] * bi + rel_row[t]`` (the walk's ``load_meta``), the
    nonzero's own row;
  * a padding slot carries value 0 (``vals``), so the walk neither adds it
    nor lets it start or end a row;
  * every row's slots are one contiguous run in slot order, and the row
    split ``parts`` (``sparse/layout.py::row_parts``) cuts only at the
    first slot of a row: a warp owns every row that starts in its range,
    sums it in registers and writes it with a plain store, so a row cut in
    two, or served twice, would be written twice (a lost sum);
  * ``idx`` and ``vals`` are the slot-ordered coordinates and values the
    walk gathers factor rows through, and rows that no slot reaches stay
    zero (``row_mask``);
  * at order >= 4, ``chain_cuts`` (``sparse/layout.py::even_cuts``) cover
    the slots once, in order: the chain kernel (``csrc/kron_chain_scatter.cu``)
    gives each range to one warp and sums the rows that ranges share from
    their partials in range order, so a gap or an overlap would drop or
    double a slot.

:func:`scatter_race_lint_schedule` re-derives the reference's own
invariants on a :class:`~repro_torch.sparse.layout.SortedCOO` (the same
arrays as the reference's, so the same seeded faults flag the same check in
both packages); :func:`scatter_race_lint_device` those above on the
:class:`~repro_torch.sparse.layout.DeviceSchedule` the kernels read;
:func:`scatter_race_lint` both for every mode of an engine, with the
launch's shared memory (``kernels.autotune.smem_bytes``) against the
device's per-block limit, the port's twin of the reference's VMEM budget.
The first in numpy on host copies (the reference's code), the second in
torch ops on the schedule's device: a green run is the proof.
"""
from __future__ import annotations

from typing import Any, List, Sequence

import numpy as np

from repro_torch.analysis.findings import Finding


def _np(t: Any) -> np.ndarray:
    """A host numpy copy of a tensor (or of an array-like)."""
    if hasattr(t, "detach"):
        return t.detach().cpu().numpy()
    return np.asarray(t)


def _is_permutation(a: np.ndarray, n: int) -> bool:
    """Whether the n entries of ``a`` are 0 .. n - 1 once each (O(n): the
    schedules of a large tensor hold ~10^8 slots)."""
    if a.shape[0] != n:
        return False
    if n == 0:
        return True
    if a.min() < 0 or a.max() >= n:
        return False
    return bool((np.bincount(a, minlength=n) == 1).all())


def scatter_race_lint_schedule(
    sched: Any, rows: Any, *, where: str = "schedule"
) -> List[Finding]:
    """Audit one mode's :class:`repro_torch.sparse.layout.SortedCOO`
    against the original mode coordinates ``rows`` (length nnz)."""
    findings: List[Finding] = []
    rows = _np(rows).astype(np.int64)
    nnz = int(rows.shape[0])
    order = _np(sched.order)
    valid = _np(sched.valid)
    rel = _np(sched.rel_row)
    blkmap = _np(sched.blkmap)
    first = _np(sched.first)
    last = _np(sched.last)
    bn, bi = int(sched.bn), int(sched.bi)
    n_blocks = int(blkmap.shape[0])

    def err(msg: str) -> None:
        findings.append(Finding("scatter-race", "error", where, msg))

    if order.shape[0] != n_blocks * bn:
        err(
            f"padded schedule has {order.shape[0]} slots but the grid "
            f"covers {n_blocks} blocks x bn={bn}"
        )
        return findings  # slot->block mapping is undefined past this point

    vmask = valid > 0
    scheduled = order[vmask]
    if scheduled.shape[0] != nnz or not _is_permutation(scheduled, nnz):
        err(
            "valid schedule slots are not a permutation of the nonzeros — "
            "entries are dropped or double-scattered"
        )
        return findings

    if nnz:
        # the disjointness core: every scheduled nonzero lands inside its
        # block's row window, at its claimed relative row.
        blk_of_slot = np.repeat(np.arange(n_blocks), bn)
        target = blkmap[blk_of_slot].astype(np.int64) * bi + rel
        bad = vmask & (rows[order] != target)
        if bad.any():
            err(
                f"{int(bad.sum())} scheduled nonzero(s) target a row "
                "outside their block's row window — the scatter would "
                "clobber another block's rows (write race)"
            )
    if (rel < 0).any() or (rel >= bi).any():
        err(
            "rel_row out of [0, bi) — the row index overflows its row "
            "block"
        )
    if vmask.shape[0] and (
        (order[~vmask] != 0).any() or (rel[~vmask] != 0).any()
    ):
        findings.append(
            Finding(
                "scatter-race", "warning", where,
                "padding slots carry non-neutral gather/row indices — "
                "safe only while valid-masking is applied everywhere",
            )
        )

    if (blkmap < 0).any() or (blkmap >= int(sched.n_row_blocks)).any():
        err("blkmap targets a row block outside the unfolding")
    expect_first = np.zeros(n_blocks, dtype=first.dtype)
    expect_first[0] = 1
    if n_blocks > 1:
        expect_first[1:][blkmap[1:] != blkmap[:-1]] = 1
    if not np.array_equal(first, expect_first):
        err(
            "first-flags don't mark the row-block group boundaries — the "
            "accumulator is not zeroed on group entry (stale-read hazard)"
        )
    expect_last = np.empty_like(expect_first)
    expect_last[:-1] = expect_first[1:]
    expect_last[-1] = 1
    if not np.array_equal(last, expect_last):
        err(
            "last-flags don't mark the row-block group boundaries — a "
            "half-accumulated block would be contracted"
        )
    # one contiguous run per row block: a revisited block's second
    # 'first' zeroing would erase the first run's partial sums.
    run_starts = blkmap[expect_first == 1]
    if np.unique(run_starts).shape[0] != run_starts.shape[0]:
        err(
            "a row block is served by two disjoint runs — the second "
            "run's zeroing erases the first run's partial sums"
        )

    n_rows = int(sched.shape[sched.mode])
    seg = _np(sched.segments)
    if (
        seg.shape[0] != n_rows + 1
        or (nnz and (seg[0] != 0 or seg[-1] != nnz))
        or (np.diff(seg) < 0).any()
    ):
        err("segment boundaries are not a monotone cover of the nonzeros")
    elif nnz and not np.array_equal(
        np.diff(seg), np.bincount(rows, minlength=n_rows)
    ):
        err(
            "segment boundaries disagree with the per-row nonzero counts — "
            "the Kron-reuse path would mix rows across segments"
        )

    visited = np.zeros(int(sched.n_row_blocks), dtype=bool)
    in_range = blkmap[(blkmap >= 0) & (blkmap < visited.shape[0])]
    visited[in_range] = True
    if sched.row_mask is None:
        if not visited.all():
            err(
                "row blocks receive no nnz block but the schedule has no "
                "row mask — their stale rows leak into the factor update"
            )
    else:
        expect_mask = np.repeat(visited, bi)[:n_rows]
        if not np.array_equal(_np(sched.row_mask).astype(bool), expect_mask):
            err("row mask disagrees with the visited row blocks")
    return findings


def scatter_race_lint_device(sched: Any, coo: Any, *,
                             where: str = "schedule") -> List[Finding]:
    """Audit one mode's :class:`~repro_torch.sparse.layout.DeviceSchedule`
    (the arrays kernels 1 and 5 and the chain kernel read) against the
    tensor ``coo`` it was built from: the slot permutation, each slot's row,
    neutral padding, contiguous rows, the chain kernel's cuts, the row
    split's alignment (``parts``), and the slot-ordered ``idx`` / ``vals``.
    Torch ops on the schedule's own device (O(slots); only the verdicts
    are read back)."""
    import torch

    from repro_torch.sparse.layout import operand_modes

    findings: List[Finding] = []

    def err(msg: str) -> None:
        findings.append(Finding("scatter-race", "error", where, msg))

    if sched.order is None:  # a Kron-reuse schedule: no scatter to audit
        return findings
    dev = sched.order.device
    idx_all = coo.indices.to(dev).long()
    nnz = int(idx_all.shape[0])
    mode, bn, bi = int(sched.mode), int(sched.bn), int(sched.bi)
    order = sched.order.long()
    valid = sched.valid > 0
    rel = sched.rel_row.long()
    blkmap = sched.blkmap.long()
    nnzp = int(order.shape[0])
    if nnzp != blkmap.shape[0] * bn or rel.shape[0] != nnzp:
        err(f"{nnzp} slots, {rel.shape[0]} rel_rows, but {blkmap.shape[0]} blocks x "
            f"bn={bn} — the walk's row of a slot (blkmap[t / bn]) is undefined")
        return findings
    scheduled = order[valid]
    if scheduled.numel() != nnz or (nnz and (
            int(scheduled.min()) < 0 or int(scheduled.max()) >= nnz
            or not bool((torch.bincount(scheduled, minlength=nnz) == 1).all()))):
        err("valid slots are not a permutation of the nonzeros — a nonzero is "
            "dropped or summed twice")
        return findings
    safe = torch.where(valid, order, 0)
    slot_row = torch.repeat_interleave(blkmap, bn) * bi + rel
    if nnz and bool((valid & (slot_row != idx_all[safe, mode])).any()):
        err("a valid slot's row (blkmap[t / bn] * bi + rel_row[t]) is not its "
            "nonzero's row — the walk would write another row (write race)")
    if bool(((rel < 0) | (rel >= bi)).any()) or bool(
            ((blkmap < 0) | (blkmap >= int(sched.n_row_blocks))).any()):
        err("rel_row or blkmap out of range — a slot's row falls outside the unfolding")
    vals = sched.vals
    if vals is None or vals.shape[0] != nnzp:
        err("the slot-ordered values are missing or of the wrong length")
    else:
        values = coo.values.to(dev)
        want = torch.where(valid, values[safe] if nnz else torch.zeros_like(vals),
                           torch.zeros((), dtype=values.dtype, device=dev)).to(vals.dtype)
        if not torch.equal(vals, want):
            err("vals is not values[order] * valid — a padding slot that carries a "
                "value would start, end or add to a row")
    idx = sched.idx
    cols = list(operand_modes(coo.ndim, mode))
    if idx is None or tuple(idx.shape) != (nnzp, len(cols)):
        err("the slot-ordered coordinates idx are missing or of the wrong shape")
    elif nnz and not torch.equal(idx[valid].long(), idx_all[scheduled][:, cols]):
        err("idx is not the slots' non-mode coordinates — the walk would gather "
            "another nonzero's factor rows")
    # every row's slots are one contiguous run: the walk's segmented sum
    # writes a row once, when it ends
    real_rows = slot_row[valid]
    if real_rows.numel():
        starts = torch.ones_like(real_rows, dtype=torch.bool)
        starts[1:] = real_rows[1:] != real_rows[:-1]
        runs = real_rows[starts]
        if torch.unique(runs).numel() != runs.numel():
            err("a row's slots are split into two runs — its two partial sums "
                "would both be stored, the second over the first")
    cuts = getattr(sched, "chain_cuts", None)
    if coo.ndim >= 4 and cuts is None:
        err("an order >= 4 schedule without chain_cuts — the chain kernel has no ranges")
    elif cuts is not None and (cuts.numel() < 2 or int(cuts[0]) != 0 or int(cuts[-1]) != nnzp
                               or bool((torch.diff(cuts) <= 0).any())):
        err("chain_cuts are not a strictly increasing cover [0, nnz_padded] of the slots "
            "— a slot would be dropped or summed twice")
    parts = sched.parts.long() if sched.parts is not None else None
    if parts is None:
        err("the schedule has no row split (parts)")
        return findings
    if (parts.numel() < 2 or int(parts[0]) != 0 or int(parts[-1]) != nnzp
            or bool((torch.diff(parts) <= 0).any())):
        err("the row split's boundaries are not a strictly increasing cover "
            "[0, nnz_padded] of the slots")
        return findings
    # a range must open on the first slot of a row: a cut whose last real
    # slot before it and first real slot from it share a row (padding slots
    # carry 0 and neither end nor start a row) splits that row
    cuts = parts[1:-1]
    if cuts.numel():
        pos = torch.arange(nnzp, device=dev)
        prev_real = torch.cummax(torch.where(valid, pos, -1), 0).values  # last real <= t
        next_real = torch.flip(torch.cummin(torch.flip(torch.where(valid, pos, nnzp), (0,)),
                                            0).values, (0,))  # first real >= t
        before, after = prev_real[cuts - 1], next_real[cuts]
        inside = ((before >= 0) & (after < nnzp)
                  & (slot_row[before.clamp(0, nnzp - 1)] == slot_row[after.clamp(0, nnzp - 1)]))
        n_bad = int(inside.sum())
        if n_bad:
            err(f"{n_bad} row-split boundary(ies) fall inside a row — two warps would "
                f"each store a partial sum of the row (write race)")
    return findings


def scatter_race_lint(
    engine: Any,
    coo: Any,
    *,
    ranks: Sequence[int],
    precision: str = "fp32",
    where: str = "engine",
) -> List[Finding]:
    """Audit every mode schedule the kernel engine hands its kernels for
    ``coo`` (the reference's :class:`SortedCOO` invariants on the layout,
    the walk's on the device schedule), the engine-vs-schedule block shape,
    and the launch's shared memory against the device's limit."""
    from repro_torch.kernels.autotune import BlockConfig, _smem_limit, smem_bytes
    from repro_torch.sparse.layout import build_mode_layout

    findings: List[Finding] = []
    if engine.reuses_kron:  # the Kron-reuse chain has no scatter schedule
        return findings
    idx = coo.indices
    for m in range(coo.ndim):
        loc = f"{where}/mode{m}"
        layout = build_mode_layout(coo, m, bn=engine.bn, bi=engine.bi)
        findings += scatter_race_lint_schedule(layout, idx[:, m], where=loc)
        sched = engine.device_schedule(coo, m)
        findings += scatter_race_lint_device(sched, coo, where=loc)
        if (int(sched.bn), int(sched.bi)) != (int(engine.bn), int(engine.bi)):
            findings.append(
                Finding(
                    "scatter-race", "error", loc,
                    f"schedule built with bn={sched.bn} bi={sched.bi} but "
                    f"the engine runs bn={engine.bn} bi={engine.bi} — the "
                    "kernels' row windows disagree with the schedule",
                )
            )
    cfg = BlockConfig(bn=int(engine.bn), bi=int(engine.bi),
                      slots_per_part=int(engine.slots_per_part),
                      layout="fused" if engine.fuse_core else "split")
    dtype = str(coo.values.dtype).replace("torch.", "")
    need = smem_bytes(cfg, coo.shape, tuple(ranks), precision, dtype)
    limit = _smem_limit(engine.device)
    if need > limit:
        findings.append(
            Finding(
                "scatter-race", "error", f"{where}/smem",
                f"BlockConfig {tuple(cfg)} needs {need} bytes of shared "
                f"memory a block, over the device's {limit}-byte limit — the "
                "launch's staging ring does not fit",
            )
        )
    return findings
