#!/usr/bin/env python3
"""Run the PyTorch/CUDA port (src/repro_torch) on one NVIDIA card and check it.

    python3 chip_smoke.py

Phases, each fatal on failure (the script exits nonzero and prints no
result line):

1. the card's name and power limit, and an ``nvcc`` build of every kernel
   from ``src/repro_torch/kernels/csrc``, all sources at once;
2. each of the five kernels against its plain PyTorch version on the card,
   at odd small shapes and under both precisions (nnz not a multiple of
   128, duplicates, zero padding, one slice, ranks 5x3, 13x22x10, 16 and
   33x40, 2-way, an order-5 chain, ``fused=False`` against the fused kernel, and the
   megakernel with a group's row 0 and its padding in different ranges);
   kernels 1 and 5 read the factor matrices through the schedule and each
   gives the same bits twice; each ``ttm`` call launches one kernel and
   gives the same bits twice;
3. the card against the CPU from the same factors (fit history, factor
   projectors and core): a NELL-2-like tensor (1000^3, 24,000 nonzeros,
   ranks 16, 5 sweeps) split and with ``fuse_core``, a 4-way tensor
   (200x200x200x20, 1,000,000 nonzeros, ranks 8, 5 sweeps), and a small
   4-way tensor with ``fuse_core`` (which takes the split TTM);
4. the 3-way main path at the published size of FROSTT's NELL-2 tensor
   (12,092 x 9,184 x 28,818, 76,879,419 nonzeros; synthetic uniform
   coordinates, values uniform in [0.1, 10)), ranks (16, 16, 16), 5 sweeps:
   launch counts, per-sweep time, no gather of (nnz, R) operand rows in a
   warm sweep (``ops._gathered_block_rows.calls``), kernels 1-2 against
   their plain versions at the path's own shapes under both precisions,
   kernel 1's same bits from two calls, and their times and bounds; then
   the per-sweep pipeline (``pipeline="python"``) on the same tensor and
   factors: its launches, the scan pipeline's fit, factors and core bit for
   bit, and its time per sweep beside the scan pipeline's;
5. path B, the same tensor through ``make_engine("cuda", fuse_core=True)``:
   launch counts, the fit, factors and core against phase 4's, per-sweep
   time in turns with the split path, no gather of (nnz, R) operand rows in
   its warm runs, peak memory beside the split path's, and the megakernel
   against its plain version and the split core update, its same bits from
   two calls, its time and bound;
6. path A, the 4-way path at the published size of FROSTT's NIPS tensor
   (2,482 x 2,862 x 14,036 x 17, 3,101,609 nonzeros; synthetic uniform
   coordinates, counts Poisson(3) + 1), ranks 16, 5 sweeps: launch counts,
   per-sweep time, peak memory, the chained kernels and the core TTM
   against their plain versions at the path's shapes, and the core against
   one built from the returned factors by the plain versions alone;
7. kernels 6 (flash attention) and 7 (the Mamba-2 SSD chunk) against their
   plain versions at odd shapes: GQA, MQA, T > S, S not a block multiple,
   D 16-128 (80 included), non-causal, the Zamba2 serving shape at S 1,024,
   the model's strided views (head dim 28 among them), in f32 (the CUDA-core
   route) and bf16 (the tensor-core route), each call checked to take its
   dtype's route; kernel 7 at L 1-256 (63, 64, 255 among them), N and P
   1-128 (17 and 80 among them) and a decay steep enough that exp above
   the diagonal overflows, each with B and C in bf16 and in f32;
8. zamba2-2.7b SMOKE, card against CPU from the same seeded weights, in
   float32 and bfloat16: prefill logits, 8 teacher-forced decode steps and
   the greedy tokens of ``Engine.generate``;
9. the LM serving path at full width: zamba2-2.7b as registered (54 Mamba-2
   layers, d 2,560, 2.42 B parameters from a seeded generator on the card),
   ``Engine.generate`` of 64 new tokens after 4 prompts of 4,096 tokens:
   launch counts (9 and 54 per prefill, the 9 on the tensor-core route),
   prefill ms, decode ms per step,
   tokens/s, peak memory and the device's busy share; kernel 6 against its
   plain version on one layer's real inputs; kernel 7 against its plain
   version on every one of the 54 calls of a warm prefill, each on the
   inputs its layer really receives, at the fp32 rule, with two controls
   on layer 0's inputs (the function in f64 must pass the rule, its
   products on one TF32 pass must fail it); both kernels' times and
   bounds; and, as a guard against gross faults, the last-token prefill
   logits against a prefill that runs the plain versions on the card,
   within a limit set in the same run from the f64 control's movement;
10. the paper's Table V tensors (Amazon 20000^3 at ranks 32, NELL-2's
    1000^3 portion, the exact matmul tensor, the 130x150 angiogram at ranks
    (30, 35)) at their published ranks and sweeps: card against CPU, the fit
    against an error taken without the projection identity (densely, or at
    the nonzeros for Amazon), ms per sweep, peak memory, launches, the
    paper's call counts, and kernels 1 and 2 at these shapes against their
    plain versions, with times and bounds;
11. dense HOOI: Table II (a rank-16 tensor with 1e-9 noise, svd,
    householder and gram) card against CPU at 200^3 and at the paper's
    800^3 its dense errors, ms per sweep and peak; Fig. 6 (sparse gram
    against dense svd at 200^3, three sparsities, warm times); and EM
    completion, card against CPU at 64x64x32 and a 256x256x128 volume
    observed at 20%: the error on the unobserved entries, ms per EM round;
12. the Tucker decomposition service (``repro_torch.serve.TuckerService``,
    max_batch 16, max_wait_ms 5, 2 executors) fed by 4 threads: 64 requests
    at the NELL-2 portion's shape (householder, 5 sweeps), 32 at Amazon's
    (gram, 2 sweeps) and 16 4-way tensors (200x200x200x20, ranks 8, gram, 3
    sweeps), nonzeros drawn per request; every result against the same
    request served alone per-tensor (fit 1e-4, projectors 1e-3, core 1e-3 x
    max|core| after sign alignment), dispatches per tenant <= ceil(N / 16),
    each flush's launches (kernel 1 or the kernel 3 + 4 chain as one
    member's run, kernel 2 once a member a sweep), requests/s, p50 / p99,
    the sequential loop's requests/s, peak memory, one flush alone and its
    busy share, and kernels 1-4 at a flush's stacked shapes against their
    plain versions with times and bounds;
13. autotuning and snapshot/resume on phase 4's tensor, drawn anew: a cold
    ``autotune=True`` plan (one search, ``min(4, candidates)`` trials with
    the default among them, none raising; each trial's config and ms), its
    result within phase 3's tolerances of phase 4's (its bits when the pick
    is the default), kernel 1 (and 5) on the tuned schedules against their
    plain versions, a warm plan with no search and no trial, a forced
    ``"fused"`` trial that launches kernel 5, the tuned and the split warm
    sweep ms in turns; snapshots every 2 sweeps (phase 4's bits, 4 written,
    3 kept, schedules built in the first segment only, phase 4's launches),
    a kill at sweep 4 and ``tucker.resume`` (phase 4's bits, no schedule
    build), a retried segment (phase 4's bits), the overhead at 1 and 5
    sweeps a segment; and the kill and resume of a 4-way tensor at tenant
    C's shape (kernels 3, 4, 2), its uninterrupted run's bits and launches;
14. sharded sparse HOOI (``TuckerSpec.shard``) in ranks spawned with
    ``torch.multiprocessing``: phase 4's tensor (drawn anew in each rank,
    its checksum held to phase 4's) over NCCL in a world of one (phase 4's
    bits, kernels 1 and 2 launched as in phase 4, the all-reduce bytes of
    a sweep worked out here); on 4 ranks over gloo sharing the card (every
    rank the same bits, phase 3's tolerances of phase 4, the imbalance,
    kernels 1 and 2 on every rank, warm sweep ms, all-reduce ms a sweep,
    kernel 1's ms on one rank's slice, peak memory per rank); tenant C's
    4-way shape on 4 ranks (kernels 3, 4, 2 on every rank, within phase 3's
    tolerances of its unsharded run); a kill at sweep 4 resumed on 4 ranks
    (the uninterrupted 4-rank bits, the 4-rank fingerprint in the manifest,
    rank 0 alone writing) and on 2 (the clamp warning, phase 3's
    tolerances);
15. one JSON line per phase, the kernels line, then the device line.

Needs one CUDA card, ``nvcc`` (on PATH or under /usr/local/cuda), and the
checkout's ``src/`` beside this file. Imports nothing of JAX.
"""
from __future__ import annotations

import dataclasses
import gc
import json
import math
import os
import subprocess
import sys
import time
from functools import partial
from pathlib import Path
from typing import Optional

# Path A holds a 51 GB contrib per mode whose size changes from mode to
# mode; without expandable segments the caching allocator splits the freed
# 51 GB block for small tensors and cannot hand it out whole again (an
# out-of-memory error on the second mode with 47 GiB reserved but free).
# Set before torch is imported, which reads it once.
os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF", "expandable_segments:True")

import numpy as np  # noqa: E402
import torch  # noqa: E402

ROOT = Path(__file__).resolve().parent

# H100 SXM peaks (NVIDIA data sheet): HBM bandwidth, the f32 CUDA-core rate
# and the dense bf16 and TF32 tensor-core rates. Kernel 6 on bf16 operands
# runs on the tensor cores and its bound counts them at the bf16 rate;
# kernel 1's fp32 products run on the tensor cores (3xTF32) and its bound
# counts them at the TF32 rate; kernel 7's bound counts C B^T on bf16
# operands at the bf16 rate and its other products (3xTF32) as three
# products at the TF32 rate; every other kernel does its arithmetic in f32
# on the CUDA cores.
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_FLOPS = 67e12
PEAK_BF16_FLOPS = 989e12
PEAK_TF32_FLOPS = 495e12

NELL2_SHAPE = (12092, 9184, 28818)
NELL2_NNZ = 76_879_419
NELL2_RANKS = (16, 16, 16)
NIPS_SHAPE = (2482, 2862, 14036, 17)  # frostt.io/tensors/nips
NIPS_NNZ = 3_101_609
NIPS_RANKS = (16, 16, 16, 16)
N_ITER = 5
WARM_RUNS = 5  # warm NELL-2 decompositions timed in phase 4
SEED = 0

# Tolerances, as a fraction of max|plain|:
# fp32: kernel and plain form the same rounded terms (a*b, then *v) and
#   differ only in the order of their f32 sums (the kernel sums each output
#   in slot order, index_add_ in atomic order, cuBLAS in its own blocks).
#   Two orders of n terms drift apart like a random walk of about sqrt(n)
#   roundings of 2^-24 each, and with cancellation that drift is measured
#   against an output far smaller than its terms: at NELL-2 size (8.4 K
#   terms per row) it reached 6.6e-6 x max|plain|. So the limit is
#   1e-5, raised to 4 sqrt(n) 2^-24 where n, the most terms summed into one
#   output, makes that larger (2.2e-5 at 8.4 K terms).
# bf16_fp32acc: both round each product to bf16 the same way and sum in
#   f32, so they agree as closely as fp32 does; 2e-2 is the bound the
#   reference's own kernel tests set for bf16 operands, kept as the stated
#   limit.
TOL = {"fp32": 1e-5, "bf16_fp32acc": 2e-2}
# "bf16" (kernel 6 on bf16 operands): the kernel and its plain version each
# round their f32 output to bf16, so they can land one bf16 ulp (2^-8
# relative) apart; 2^-7 x max|plain| leaves room for the f32 differences
# beneath that rounding.
BF16_OUT_TOL = 2.0 ** -7

# device-side symbols of each wrapper's kernels, for the profiler's sums; the
# leading "::" keeps "::ttm_kernel" from matching the megakernel's
# "kron_scatter_ttm_kernel"
KERNEL_SYMBOLS = {
    "fused_kron_scatter": ("::kron_scatter_kernel",),
    "ttm": ("::ttm_kernel",),
    "kron_contrib": ("::kron_contrib_kernel",),
    "scatter_rows": ("::scatter_rows_kernel",),
    "fused_kron_scatter_ttm": ("::kron_scatter_ttm_kernel", "::kron_scatter_ttm_reduce_kernel"),
    "flash_attention": ("::flash_attention_kernel", "::flash_attention_wgmma_kernel"),
    "ssd_chunk": ("::ssd_chunk_kernel",),
}
NO_LM_LAUNCHES = {"flash_attention": 0, "ssd_chunk": 0}


class Failure(Exception):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise Failure(msg)


def log(*parts) -> None:
    print(*parts, flush=True)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    if not (ROOT / "src" / "repro_torch" / "kernels" / "csrc").is_dir():
        print("chip_smoke: src/repro_torch is not beside this script", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    torch.backends.cuda.matmul.allow_tf32 = False  # plain versions in full f32
    torch.backends.cudnn.allow_tf32 = False

    from repro_torch.kernels import _build

    dev = torch.device("cuda", 0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=False,
    ).stdout.strip().splitlines()
    card = smi[0] if smi else "nvidia-smi unavailable"
    log(card)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)} count {torch.cuda.device_count()}")
    if sys.argv[1:]:
        print(f"chip_smoke: unknown arguments {sys.argv[1:]}", file=sys.stderr)
        return 2

    t0 = time.perf_counter()
    secs = _build.build_all(force=True)
    log(f"phase 1: built {sorted(secs)} in {time.perf_counter() - t0:.2f} s "
        f"(nvcc in parallel: " + ", ".join(f"{k} {v:.2f} s" for k, v in sorted(secs.items())) + ")")
    for name in _build.SOURCES:
        for line in (_build.BUILD_DIR / f"{name}.ptxas.log").read_text().splitlines():
            if "registers" in line or "spill" in line:
                log(f"  ptxas {name}: {line.strip()}")

    def timed(name, fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        log(f"phase {name}: {time.perf_counter() - t0:.1f} s")
        return out

    timed("2 kernels", phase2_kernels, dev)
    timed("3 card vs CPU", phase3_mid, dev)
    kernels, coo, split_res, split_peak = timed("4 NELL-2", phase4_nell2, dev, card)
    # phase 13 draws this tensor anew and holds its runs to these bits
    ref4 = {"checksum": coo_checksum(coo), "fit": split_res.fit_history.copy(),
            "factors": [f.cpu() for f in split_res.factors], "core": split_res.core.cpu()}
    kernels.update(timed("5 path B", phase5_fused_core, dev, card, coo, split_res, split_peak))
    del coo, split_res
    release_memory()
    kernels.update(timed("6 path A", phase6_nips, dev, card))
    release_memory()
    timed("7 LM kernels", phase7_lm_kernels, dev)
    timed("8 SMOKE card vs CPU", phase8_smoke_card_vs_cpu, dev)
    kernels.update(timed("9 Zamba2 serving", phase9_zamba2, dev, card))
    timed("10 Table V", phase10_table5, dev, card)
    timed("11 dense HOOI and completion", phase11_dense, dev, card)
    timed("12 Tucker service", phase12_service, dev, card)
    timed("13 autotuning and snapshots", phase13_autotune_snapshots, dev, card, ref4)
    timed("14 sharded", phase14_sharded, dev, card, ref4)
    print(json.dumps({"kernels": [kernels[k] for k in wrappers()]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


# -- helpers -----------------------------------------------------------------


def synced(out):
    """``out`` after the card has finished the launch that made it, so a
    fault in that launch surfaces here."""
    torch.cuda.synchronize()
    return out


def against_plain(got, want, precision: str, n_terms: int):
    """(max abs error, limit, tol, max|plain|, within) of ``got`` against
    ``want`` under TOL or, for ``precision="bf16"``, BF16_OUT_TOL (see
    there); ``n_terms`` is the most terms summed into one output."""
    scale = float(want.abs().max()) if want.numel() else 0.0
    err = float((got - want).abs().max()) if want.numel() else 0.0
    tol = BF16_OUT_TOL if precision == "bf16" else TOL[precision]
    if precision == "fp32":
        tol = max(tol, 4 * n_terms ** 0.5 * 2.0 ** -24)
    limit = tol * max(scale, 1e-30)
    return err, limit, tol, scale, bool(torch.isfinite(got).all()) and err <= limit


def compare(name: str, precision: str, got, want, n_terms: int) -> float:
    """Max abs error of ``got`` against ``want``, checked by
    :func:`against_plain`."""
    torch.cuda.synchronize()
    err, limit, tol, scale, ok = against_plain(got, want, precision, n_terms)
    log(f"  {name} [{precision}]: max_abs_err {err:.3e} <= {limit:.3e} "
        f"(tol {tol:.3g} x max|plain| {scale:.3e}, {n_terms} terms) {'ok' if ok else 'FAIL'}")
    check(ok, f"{name} [{precision}] disagrees with its plain version")
    return err


def time_ms(fn, reps: int = 5, flush_l2: bool = False) -> float:
    """Median milliseconds of ``fn`` over ``reps`` runs after one warm-up,
    each bracketed by CUDA events; optionally with L2 flushed before each."""
    junk = torch.empty(64 << 20, dtype=torch.uint8, device="cuda") if flush_l2 else None
    fn()
    times = []
    for _ in range(reps):
        if junk is not None:
            junk.zero_()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return sorted(times)[len(times) // 2]


def profile_run(fn) -> dict:
    """Device time by kernel name over one call of ``fn`` (torch.profiler),
    and the device's busy share of the call's wall time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    by_name = {}
    for ev in prof.events():
        if ev.device_type == DeviceType.CUDA:
            ms, n = by_name.get(ev.name, (0.0, 0))
            by_name[ev.name] = (ms + ev.time_range.elapsed_us() / 1e3, n + 1)
    busy_ms = sum(ms for ms, _ in by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:15]
    out = {"wall_ms": wall_ms, "device_busy_ms": busy_ms,
           "device_kernels": sum(n for _, n in by_name.values()),
           "busy_share": busy_ms / wall_ms if wall_ms else None,
           "top": [{"kernel": k[:90], "ms": ms, "count": n} for k, (ms, n) in top],
           "kernel_ms": {
               name: sum(ms for k, (ms, _) in by_name.items() if any(p in k for p in pats))
               for name, pats in KERNEL_SYMBOLS.items()}}
    log(f"  profile of a warm run: wall {wall_ms:.1f} ms, device busy {busy_ms:.1f} ms"
        + ("" if by_name else " (the profiler saw no device events)"))
    for row in out["top"]:
        log(f"    {row['ms']:9.3f} ms {row['count']:5d}x  {row['kernel']}")
    return out


def host_launch_us(dev, n: int = 2000) -> float:
    """Host microseconds per call of a one-element torch op on the card (the
    dispatch and launch that each of QRP's small kernels pays), over ``n``
    calls after a warm-up."""
    x = torch.zeros(1, device=dev)
    for _ in range(100):
        x.add_(1)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        x.add_(1)
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / n * 1e6


def check_ttm_call(label: str, y, u, precision: str):
    """``ttm`` on the card: one device kernel per call (counted where the C
    side launches it), and the same bits from two calls on the same inputs.
    Returns the first result."""
    from repro_torch.kernels import kron_kernel, ttm_kernel

    before = ttm_kernel.kernels_launched()
    first = synced(ttm_kernel.ttm(y, u, precision=precision))
    n = ttm_kernel.kernels_launched() - before
    again = synced(ttm_kernel.ttm(y, u, precision=precision))
    log(f"  ttm {label} [{precision}]: {n} kernel launch per call, bulk copies "
        f"{ttm_kernel.bulk_copies(*kron_kernel._cast_operands(precision, y, u))}, "
        f"same bits twice: {torch.equal(first, again)}")
    check(n == 1, f"ttm {label} [{precision}] launched {n} kernels, want 1")
    check(torch.equal(first, again), f"ttm {label} [{precision}] differs between two calls")
    return first


def bound(nbytes: float, flops: float, peak_flops: float = PEAK_F32_FLOPS):
    """(ms, what bounds it): the least time the card could take to move
    ``nbytes`` and do ``flops`` operations at ``peak_flops`` (the f32
    CUDA-core rate unless given)."""
    t_bytes, t_ops = nbytes / PEAK_BYTES_PER_S, flops / peak_flops
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def nbytes_of(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def wrappers() -> dict:
    """Each kernel's wrapper, by kernel name; each counts its launches."""
    from repro_torch.kernels import flash_attention, kron_kernel, ssd_scan, ttm_kernel

    return {"fused_kron_scatter": kron_kernel.fused_kron_scatter, "ttm": ttm_kernel.ttm,
            "kron_contrib": kron_kernel.kron_contrib, "scatter_rows": kron_kernel.scatter_rows,
            "fused_kron_scatter_ttm": kron_kernel.fused_kron_scatter_ttm,
            "flash_attention": flash_attention.flash_attention, "ssd_chunk": ssd_scan.ssd_chunk}


def reset_launches() -> None:
    for fn in wrappers().values():
        fn.launches = 0
        for route in getattr(fn, "launches_by_route", {}):
            fn.launches_by_route[route] = 0


def read_launches() -> dict:
    return {name: fn.launches for name, fn in wrappers().items()}


def release_memory() -> None:
    """Drop cached plans (and their schedules) and return freed blocks."""
    from repro_torch import tucker

    tucker.clear_plan_cache()
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()


def chain_plain(rows, vals, sched, n_rows: int, precision: str, step: int = 0):
    """The order >= 4 unfolding through the plain versions alone, on slot
    chunks of ``step`` slots (all at once for 0), so that the full-size
    contrib is never formed: the same Kron rows and the same sums as
    kron_contrib -> kron_contrib -> scatter_rows."""
    from repro_torch.kernels import kron_kernel
    from repro_torch.sparse.layout import slot_rows

    k = 1
    for r in rows:
        k *= r.shape[1]
    out = torch.zeros((sched.n_row_blocks * sched.bi, k), dtype=torch.float32,
                      device=vals.device)
    slots = slot_rows(sched)
    step = step or vals.shape[0]
    for s in range(0, vals.shape[0], step):
        c = kron_kernel.kron_contrib_plain(rows[0][s:s + step], rows[1][s:s + step],
                                           vals[s:s + step], precision=precision)
        for extra in rows[2:]:
            c = kron_kernel.kron_contrib_plain(c, extra[s:s + step],
                                               torch.ones_like(vals[s:s + step]))
        out.index_add_(0, slots[s:s + step], c)
    return kron_kernel._mask_unvisited(out[:n_rows], sched)


def kron_factors(fs, mode):
    """Kernel 1's two factor matrices for ``mode`` (the second None for a
    2-way tensor), in the order of the schedule's slot coordinates."""
    from repro_torch.sparse.layout import operand_modes

    modes = operand_modes(len(fs), mode)
    return fs[modes[0]], (fs[modes[1]] if len(modes) > 1 else None)


def max_row_count(coo, mode) -> int:
    """The most nonzeros that share one mode-``mode`` coordinate: the most
    terms the unfolding sums into one output."""
    return int(torch.bincount(coo.indices[:, mode].long()).max()) if coo.nnz else 0


def schedule_of(coo, mode):
    from repro_torch.sparse.layout import DeviceSchedule, build_mode_layout

    return DeviceSchedule.from_layout(build_mode_layout(coo, mode), coo)


# -- phase 2 -----------------------------------------------------------------


def phase2_kernels(dev) -> None:
    from repro_torch.core.coo import SparseCOO
    from repro_torch.kernels import kron_kernel, ops, ttm_kernel
    from repro_torch.sparse.layout import row_parts

    log("phase 2: kernels against their plain versions, odd shapes")
    rng = np.random.default_rng(SEED)

    def coo_of(shape, idx, vals):
        return SparseCOO.from_parts(idx.astype(np.int32), vals.astype(np.float32),
                                    shape, device=dev)

    cases = []
    shape = (50, 40, 30)
    idx = np.stack([rng.integers(0, s, 1000) for s in shape], 1)
    cases.append(("nnz 1000 (not a multiple of 128), ranks 5x3", coo_of(
        shape, idx, rng.standard_normal(1000)), (4, 3, 5)))
    dup = np.concatenate([idx[:300], idx[:300], idx[:77]])
    cases.append(("duplicate coordinates", coo_of(shape, dup, rng.standard_normal(677)),
                  (4, 3, 5)))
    base = coo_of(shape, idx[:500], rng.standard_normal(500))
    cases.append(("explicit zero padding rows", base.pad_to(631), (4, 3, 5)))
    one = np.stack([np.full(700, 777), rng.integers(0, 200, 700), rng.integers(0, 90, 700)], 1)
    cases.append(("one slice, most row blocks empty", coo_of(
        (1000, 200, 90), one, rng.standard_normal(700)), (6, 5, 7)))
    cases.append(("ranks 33x40, K over six 32-lane tiles", coo_of(
        shape, idx, rng.standard_normal(1000)), (4, 40, 33)))
    big = (300, 200, 100)
    cases.append(("ranks 16, 20,000 nnz, many chunks a range", coo_of(
        big, np.stack([rng.integers(0, s_, 20000) for s_ in big], 1),
        rng.standard_normal(20000)), (16, 16, 16)))
    cases.append(("ranks 13x22x10, factor rows padded to 16 bytes", coo_of(
        shape, idx, rng.standard_normal(1000)), (13, 22, 10)))
    two = np.stack([rng.integers(0, 300, 900), rng.integers(0, 200, 900)], 1)
    cases.append(("2-way tensor", coo_of((300, 200), two, rng.standard_normal(900)), (6, 4)))
    # row 0 of the first 128-row group gets a range of its own (5,000 slots),
    # and the group's padding (it aliases row 0) lands in row 5's range.
    alias_rows = np.concatenate([np.zeros(5000), np.full(300, 3), np.full(301, 5),
                                 rng.integers(200, 400, 700)])
    alias = coo_of((400, 30, 20), np.stack(
        [alias_rows, rng.integers(0, 30, alias_rows.size), rng.integers(0, 20, alias_rows.size)],
        1), rng.standard_normal(alias_rows.size))
    cases.append(("row 0 and its group's padding in different ranges", alias, (4, 3, 5)))
    for label, coo, ranks in cases:
        fs = [torch.randn(s, r, device=dev) for s, r in zip(coo.shape, ranks)]
        for mode in range(coo.ndim):
            sched = schedule_of(coo, mode)
            n_rows = coo.shape[mode]
            rows, vals = ops._gathered_block_rows(coo.indices, coo.values, fs, mode,
                                                  sched, coo.ndim)
            fa, fb = kron_factors(fs, mode)
            n_terms = max_row_count(coo, mode)
            tag = f"{label} mode {mode} ({rows[0].shape[1]}x{rows[1].shape[1]})"
            for prec in ("fp32", "bf16_fp32acc"):
                got = synced(kron_kernel.fused_kron_scatter(fa, fb, sched, n_rows, precision=prec))
                want = synced(kron_kernel.fused_kron_scatter_plain(fa, fb, sched, n_rows,
                                                                   precision=prec))
                compare(f"fused_kron_scatter {tag}", prec, got, want, n_terms)
                again = synced(kron_kernel.fused_kron_scatter(fa, fb, sched, n_rows,
                                                              precision=prec))
                check(torch.equal(got, again), f"fused_kron_scatter {tag} differs between two "
                      f"runs")
                contrib = synced(kron_kernel.kron_contrib(rows[0], rows[1], vals, precision=prec))
                compare(f"kron_contrib {tag}", prec, contrib, synced(
                    kron_kernel.kron_contrib_plain(rows[0], rows[1], vals, precision=prec)), 1)
                compare(f"scatter_rows {tag} of the {prec} contrib", "fp32",
                        synced(kron_kernel.scatter_rows(contrib, sched, n_rows)),
                        synced(kron_kernel.scatter_rows_plain(contrib, sched, n_rows)), n_terms)
                compare(f"fused=False chain against kernel 1, {tag}", prec, synced(
                    ops.sparse_ttm_chain_device(coo.indices, coo.values, fs, mode, sched,
                                                shape=coo.shape, fused=False, precision=prec)),
                    got, n_terms)
                g_want = synced(kron_kernel.fused_kron_scatter_ttm_plain(
                    fa, fb, fs[mode], sched, n_rows, precision=prec))
                g = synced(kron_kernel.fused_kron_scatter_ttm(
                    fa, fb, fs[mode], sched, n_rows, precision=prec))
                compare(f"fused_kron_scatter_ttm {tag}", prec, g, g_want, coo.nnz)
                again = synced(kron_kernel.fused_kron_scatter_ttm(
                    fa, fb, fs[mode], sched, n_rows, precision=prec))
                check(torch.equal(g, again), f"fused_kron_scatter_ttm {tag} differs "
                      f"between two runs")
                if coo is alias:  # the segmented sums under other row-aligned splits
                    for n_parts in (1, 2, 3, 7):
                        sp = dataclasses.replace(sched, parts=row_parts(sched, n_parts))
                        label2 = f"{tag}, {int(sp.parts.numel()) - 1} ranges"
                        compare(f"fused_kron_scatter {label2}", prec, synced(
                            kron_kernel.fused_kron_scatter(fa, fb, sp, n_rows, precision=prec)),
                            want, n_terms)
                        compare(f"scatter_rows {label2}", "fp32",
                                synced(kron_kernel.scatter_rows(contrib, sp, n_rows)),
                                synced(kron_kernel.scatter_rows_plain(contrib, sp, n_rows)),
                                n_terms)
                        compare(f"fused_kron_scatter_ttm {label2}", prec, synced(
                            kron_kernel.fused_kron_scatter_ttm(fa, fb, fs[mode], sp, n_rows,
                                                               precision=prec)),
                            g_want, coo.nnz)
            if coo is alias and mode == 0:
                parts = sched.parts.tolist()
                first_pad = int(torch.nonzero(sched.valid[:5632] == 0).min())
                check(parts[1] <= 5000 < first_pad and first_pad not in parts,
                      f"alias case: ranges {parts[:4]}, first padding slot {first_pad}")
    # an order-5 tensor: kron_contrib chained three times, then scatter_rows;
    # its core update is that chain followed by the TTM kernel.
    shape5, ranks5 = (30, 20, 10, 8, 6), (3, 2, 4, 2, 3)
    coo5 = coo_of(shape5, np.stack([rng.integers(0, s, 2000) for s in shape5], 1),
                  rng.standard_normal(2000))
    fs5 = [torch.randn(s, r, device=dev) for s, r in zip(shape5, ranks5)]
    for mode in range(5):
        sched = schedule_of(coo5, mode)
        rows, vals = ops._gathered_block_rows(coo5.indices, coo5.values, fs5, mode, sched, 5)
        n_terms = max_row_count(coo5, mode)
        for prec in ("fp32", "bf16_fp32acc"):
            y = synced(ops.sparse_ttm_chain_device(coo5.indices, coo5.values, fs5, mode, sched,
                                                   shape=shape5, precision=prec))
            y_plain = synced(chain_plain(rows, vals, sched, shape5[mode], prec))
            compare(f"order-5 chain mode {mode}", prec, y, y_plain, n_terms)
            compare(f"order-5 core update mode {mode}", prec, synced(ops.sparse_ttm_core_device(
                coo5.indices, coo5.values, fs5, mode, sched, shape=shape5, precision=prec)),
                synced(ttm_kernel.ttm_plain(y_plain.T, fs5[mode].T, precision=prec).T),
                coo5.nnz)
    for l_, i_, r_, transposed in ((15, 1000, 3, True), (256, 28818, 16, True),
                                   (100, 300, 17, False), (8, 8, 8, False)):
        if transposed:  # the path's views: y = Y_(N)^T, u = U_N^T
            y = torch.randn(i_, l_, device=dev).T
            u = torch.randn(i_, r_, device=dev).T
        else:
            y = torch.randn(l_, i_, device=dev)
            u = torch.randn(r_, i_, device=dev)
        for prec in ("fp32", "bf16_fp32acc"):
            label = f"y ({l_}, {i_}){' transposed' if transposed else ''} u ({r_}, {i_})"
            compare(f"ttm {label}", prec, check_ttm_call(label, y, u, prec),
                    synced(ttm_kernel.ttm_plain(y, u, precision=prec)), i_)


# -- phase 3 -----------------------------------------------------------------


def phase3_mid(dev) -> None:
    from repro_torch.core.engine import make_engine
    from repro_torch.sparse.generators import random_sparse_tensor

    log("phase 3: card against CPU from the same factors, 5 sweeps")
    nell = random_sparse_tensor((1000, 1000, 1000), 2.4e-5, seed=11, value_dist="uniform")
    card_vs_cpu("NELL-2-like 1000^3, 24,000 nnz, ranks 16", nell, (16, 16, 16),
                expect={"fused_kron_scatter": 3 * N_ITER, "ttm": N_ITER})
    card_vs_cpu("the same with fuse_core", nell, (16, 16, 16),
                engine=lambda d: make_engine("auto", d, fuse_core=True),
                expect={"fused_kron_scatter": 3 * N_ITER, "fused_kron_scatter_ttm": N_ITER})
    four = random_sparse_tensor((200, 200, 200, 20), 1e6 / (200 * 200 * 200 * 20), seed=12,
                                value_dist="counts")
    card_vs_cpu("4-way 200x200x200x20, 1,000,000 nnz, ranks 8", four, (8, 8, 8, 8),
                expect={"kron_contrib": 8 * N_ITER, "scatter_rows": 4 * N_ITER,
                        "ttm": N_ITER})
    # no megakernel above order 3: fuse_core takes the TTM of the Y_(N) the
    # sweep built, with no second chain
    small = random_sparse_tensor((60, 50, 40, 10), 2e4 / (60 * 50 * 40 * 10), seed=13,
                                 value_dist="counts")
    card_vs_cpu("4-way 60x50x40x10, 20,000 nnz, ranks 4, fuse_core", small, (4, 4, 4, 4),
                engine=lambda d: make_engine("auto", d, fuse_core=True),
                expect={"kron_contrib": 8 * N_ITER, "scatter_rows": 4 * N_ITER,
                        "ttm": N_ITER})


def card_vs_cpu(label, x, ranks=None, engine=None, expect=None, spec=None,
                align: str = "sign", fit_tol: float = 1e-4):
    """Decompose ``x`` (a COO, or a dense tensor for ``spec``'s dense
    algorithm) on the card and on the CPU from the same seeded orthonormal
    factors, by ``spec`` (``TuckerSpec(x.shape, ranks, n_iter=N_ITER)`` by
    default), through a prebuilt engine from ``engine(device)`` when given;
    the fit histories must agree within ``fit_tol`` (1e-4), the factor
    projectors within 1e-3 and the cores, once the factor columns' signs are
    matched, within 1e-3 x max|CPU core|; the card run must launch
    ``expect`` (nothing on the dense paths). Returns the card's and the
    CPU's results.

    ``align="basis"`` compares the card's core in the CPU's factor basis,
    G x_n (U_cpu,n^T U_card,n), for a tensor whose QRP pivots tie exactly
    (the binary matmul tensor's column norms): rounding then breaks the ties
    differently on the two devices, the same subspace comes in another
    column order, and signs alone cannot match the cores."""
    from repro_torch import tucker

    spec = spec or tucker.TuckerSpec(x.shape, ranks, n_iter=N_ITER)
    rng = np.random.default_rng(SEED)
    f0 = [np.linalg.qr(rng.standard_normal((s, r)))[0].astype(np.float32)
          for s, r in zip(spec.shape, spec.ranks)]
    res = {}
    for d in ("cuda", "cpu"):
        reset_launches()
        t0 = time.perf_counter()
        plan = tucker.plan(spec, device=d, engine=engine(d) if engine else None)
        res[d] = plan(x, factors_init=[torch.from_numpy(f) for f in f0])
        torch.cuda.synchronize()
        launches = {k: v for k, v in read_launches().items() if v}
        log(f"  {label} on {d}: {time.perf_counter() - t0:.2f} s, launches {launches}")
        if d == "cuda":
            check(launches == (expect or {}), f"{label}: launches {launches}, want {expect}")
        else:
            check(not launches, f"{label}: the CPU run launched {launches}")
    cu, cp = res["cuda"], res["cpu"]
    card_engine = "cuda" if spec.algorithm == "sparse" else "torch"
    check(cu.engine == card_engine and cp.engine == "torch", f"engines {cu.engine}, {cp.engine}")
    hist_err = float(np.abs(cu.fit_history - cp.fit_history).max())
    proj_err = max(
        float((a.cpu() @ a.cpu().T - b @ b.T).abs().max())
        for a, b in zip(cu.factors, cp.factors)
    )
    log(f"  fit card {cu.fit_history.tolist()}")
    log(f"  fit cpu  {cp.fit_history.tolist()}")
    log(f"  fit history max diff {hist_err:.3e} <= {fit_tol:g}; projector UU^T max diff "
        f"{proj_err:.3e} <= 1e-3; card launches {cu.launches}")
    check(cu.fit_history.shape == cp.fit_history.shape and hist_err <= fit_tol,
          f"{label}: card and CPU fit histories disagree")
    check(proj_err <= 1e-3, f"{label}: card and CPU factor subspaces disagree")
    from repro_torch.core.ttm import ttm

    core = cu.core.cpu()
    for n, (a, b) in enumerate(zip(cu.factors, cp.factors)):
        if align == "basis":
            core = ttm(core, b.T @ a.cpu(), n)
        else:  # a factor column is defined up to its sign: flip the core's slices to match
            sign = torch.sign((a.cpu() * b).sum(0))
            core = core * sign.reshape([-1 if t == n else 1 for t in range(core.dim())])
    scale = float(cp.core.abs().max())
    core_err = float((core - cp.core).abs().max())
    log(f"  core max diff ({align} aligned) {core_err:.3e} <= {1e-3 * scale:.3e} "
        f"(1e-3 x max|core| {scale:.3e})")
    check(bool(torch.isfinite(core).all()) and core_err <= 1e-3 * scale,
          f"{label}: card and CPU cores disagree")
    return cu, cp


# -- phase 4 -----------------------------------------------------------------


def synthetic(dev, shape, nnz: int, seed: int, values: str):
    """Unique uniform coordinates at a published shape and nonzero count,
    drawn on the card from a seeded generator: sort-based dedup, no loop over
    the nonzeros. (The same steps in host numpy took 202 s at NELL-2 size on
    the shared host CPU of an H100 node.) ``values`` is "uniform" (uniform
    in [0.1, 10), like ``repro.sparse.datasets.nell2_like``) or "counts"
    (Poisson(3) + 1, like ``value_dist="counts"``)."""
    g = torch.Generator(device=dev).manual_seed(seed)
    total = 1
    for s in shape:
        total *= s
    lin = torch.empty(0, dtype=torch.int64, device=dev)
    while lin.numel() < nnz:
        more = torch.randint(0, total, (nnz - lin.numel() + nnz // 1000 + 1024,),
                             generator=g, device=dev, dtype=torch.int64)
        lin = torch.unique(torch.cat([lin, more]))
    lin = lin[torch.randperm(lin.numel(), generator=g, device=dev)[:nnz]]
    idx = torch.empty((nnz, len(shape)), dtype=torch.int32, device=dev)
    for k in range(len(shape) - 1, -1, -1):
        idx[:, k] = lin % shape[k]
        lin = lin // shape[k]
    if values == "uniform":
        vals = torch.rand(nnz, generator=g, device=dev) * 9.9 + 0.1
    else:
        vals = torch.poisson(torch.full((nnz,), 3.0, device=dev), generator=g) + 1.0
    return idx, vals


def unique_coords(coo) -> bool:
    lin = torch.zeros(coo.nnz, dtype=torch.int64, device=coo.indices.device)
    for k, s in enumerate(coo.shape):
        lin = lin * s + coo.indices[:, k].long()
    return int(torch.unique(lin).numel()) == coo.nnz


def phase4_nell2(dev, card: str):
    from repro_torch import tucker
    from repro_torch.core.coo import SparseCOO
    from repro_torch.kernels import kron_kernel, ops, ttm_kernel

    log(f"phase 4: NELL-2 size {NELL2_SHAPE}, {NELL2_NNZ} nnz, ranks {NELL2_RANKS}, "
        f"{N_ITER} sweeps")
    t0 = time.perf_counter()
    idx, vals = synthetic(dev, NELL2_SHAPE, NELL2_NNZ, SEED, "uniform")
    coo = SparseCOO.from_parts(idx, vals, NELL2_SHAPE)
    torch.cuda.synchronize()
    t_gen = time.perf_counter() - t0
    check(unique_coords(coo), "synthetic coordinates are not unique")
    del idx, vals
    spec = tucker.TuckerSpec(shape=NELL2_SHAPE, ranks=NELL2_RANKS, n_iter=N_ITER)
    plan = tucker.plan(spec, device=dev)

    # the main path, cold: every count starts at 0 here and is read right after.
    torch.cuda.reset_peak_memory_stats()
    resident_gb = torch.cuda.memory_allocated() / 1e9  # the tensor
    reset_launches()
    t0 = time.perf_counter()
    res = tucker.decompose(coo, NELL2_RANKS, n_iter=N_ITER, device=dev)
    torch.cuda.synchronize()
    t_cold = time.perf_counter() - t0
    launches = read_launches()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    hist = res.fit_history
    log(f"  cold run: {t_cold:.3f} s, launches {launches}, schedule builds "
        f"{res.schedule_builds}, fit {hist.tolist()}")
    check(res.engine == "cuda", f"engine {res.engine}")
    check(launches == {"fused_kron_scatter": 3 * N_ITER, "ttm": N_ITER, "kron_contrib": 0,
                       "scatter_rows": 0, "fused_kron_scatter_ttm": 0, **NO_LM_LAUNCHES},
          f"main path launches {launches}, want {3 * N_ITER} and {N_ITER}")
    check(hist.shape == (N_ITER,) and bool(np.all(np.isfinite(hist)))
          and bool(np.all((hist >= 0) & (hist <= 1))), f"fit history {hist}")
    check(all(bool(torch.isfinite(f).all()) for f in res.factors)
          and bool(torch.isfinite(res.core).all()), "non-finite factors or core")
    check(tuple(res.core.shape) == NELL2_RANKS, f"core shape {tuple(res.core.shape)}")

    # warm runs (schedules cached on the plan's engine): per-sweep time of
    # each, and no gather of (nnz, R) operand rows (kernel 1 reads the
    # factors itself). Most of a sweep is the host launching QRP's small
    # kernels, so the runs' spread is reported beside the host's cost of one
    # small launch and the device kernels per sweep.
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    gathers = ops._gathered_block_rows.calls
    warm_runs = []
    t0 = time.perf_counter()
    for _ in range(WARM_RUNS):
        start.record()
        warm = plan(coo)
        end.record()
        end.synchronize()
        warm_runs.append(start.elapsed_time(end) / N_ITER)
        check(warm.schedule_builds == 0, "warm run rebuilt schedules")
        check(np.array_equal(warm.fit_history, hist), "warm run differs from the cold run")
    t_warm = (time.perf_counter() - t0) / WARM_RUNS
    gathers = ops._gathered_block_rows.calls - gathers
    sweep_ms = float(np.median(warm_runs))
    launch_us = host_launch_us(dev)
    log(f"  warm runs: " + ", ".join(f"{m:.2f}" for m in warm_runs)
        + f" ms per sweep (median {sweep_ms:.2f}), operand-row gathers {gathers}; "
        f"host {launch_us:.2f} us per small torch kernel")
    check(gathers == 0, f"the warm split sweep gathered operand rows {gathers} times")
    profile = profile_run(lambda: plan(coo))
    kernels_per_sweep = profile["device_kernels"] / N_ITER
    log(f"  {kernels_per_sweep:.0f} device kernels per sweep: x {launch_us:.2f} us = "
        f"{kernels_per_sweep * launch_us / 1e3:.2f} ms of host launches per sweep")
    python_pipeline = per_sweep_pipeline(plan, coo, res, launches, sweep_ms)

    # each kernel at the path's shapes, against its plain version.
    eng, fs = plan.engine, [f.contiguous() for f in res.factors]
    kron_ms = {p: 0.0 for p in TOL}
    kron_plain_ms = {p: 0.0 for p in TOL}
    kron_bound, kron_err, per_mode = {p: 0.0 for p in TOL}, {p: 0.0 for p in TOL}, []
    kron_bytes, kron_flops = 0, 0
    y_last = None
    for mode in range(3):
        sched = eng.device_schedule(coo, mode)
        n_rows = NELL2_SHAPE[mode]
        fa, fb = kron_factors(fs, mode)
        nnz_real = NELL2_NNZ
        n_terms = max_row_count(coo, mode)
        slots = int(sched.vals.shape[0])
        for p in TOL:
            kern = partial(kron_kernel.fused_kron_scatter, fa, fb, sched, n_rows, precision=p)
            plain = partial(kron_kernel.fused_kron_scatter_plain, fa, fb, sched, n_rows,
                            precision=p)
            got, want = synced(kern()), synced(plain())
            kron_err[p] = max(kron_err[p], compare(
                f"fused_kron_scatter NELL-2 mode {mode} ({fa.shape[1]}x{fb.shape[1]}, "
                f"{slots} slots)", p, got, want, n_terms))
            check(torch.equal(got, synced(kern())),
                  f"fused_kron_scatter NELL-2 mode {mode} [{p}] differs between two calls")
            del want
            if p == "fp32" and mode == 2:
                y_last = got
            k_ms, p_ms = time_ms(kern), time_ms(plain, reps=1)
            k = fa.shape[1] * fb.shape[1]
            # what the kernel must read: the slot coordinates and values, the
            # schedule's rows and ranges, the two factor matrices (as cast)
            # once each; and Y written once
            nbytes = (nbytes_of(sched.idx, sched.vals, sched.rel_row, sched.blkmap, sched.parts,
                                *kron_kernel._cast_operands(p, fa, fb)) + n_rows * k * 4)
            flops = 3 * nnz_real * k
            # fp32 runs on the tensor cores (3xTF32), bf16_fp32acc on the CUDA cores
            peak = PEAK_TF32_FLOPS if p == "fp32" else PEAK_F32_FLOPS
            mode_bound, _ = bound(nbytes, flops, peak)
            kron_ms[p] += k_ms
            kron_plain_ms[p] += p_ms
            kron_bound[p] += mode_bound
            if p == "fp32":
                kron_bytes, kron_flops = kron_bytes + nbytes, kron_flops + flops
            per_mode.append({"mode": mode, "precision": p, "ms": k_ms, "plain_ms": p_ms,
                             "bound_ms": mode_bound, "bytes": nbytes, "flops": flops,
                             "parts": int(sched.parts.numel()) - 1})
            log(f"    mode {mode} [{p}]: kernel {k_ms:.3f} ms, plain {p_ms:.3f} ms, "
                f"bound {mode_bound:.3f} ms ({nbytes / 1e9:.2f} GB, {flops / 1e9:.1f} GFLOP), "
                f"{int(sched.parts.numel()) - 1} ranges (one a warp)")
            del got

    u = fs[2]
    ttm_row = {}
    for p in TOL:
        yc, uc = y_last.T, u.T
        kern = partial(ttm_kernel.ttm, yc, uc, precision=p)
        plain = partial(ttm_kernel.ttm_plain, yc, uc, precision=p)
        err = compare(f"ttm NELL-2 y {tuple(yc.shape)} (transposed view) u "
                      f"{tuple(uc.shape)}", p, check_ttm_call("NELL-2", yc, uc, p),
                      synced(plain()), yc.shape[1])
        yb, ub = kron_kernel._cast_operands(p, yc, uc)
        # one PyTorch call of the same function; bf16 matmul would round its
        # output to bf16, a different function, so none under bf16_fp32acc
        lib = partial(torch.matmul, yb, ub.T) if p == "fp32" else None
        l_, i_ = yc.shape
        nbytes = (l_ * i_ + u.shape[1] * i_) * yb.element_size() + l_ * u.shape[1] * 4
        flops = 2 * l_ * i_ * u.shape[1]
        ttm_row[p] = {
            "ms": time_ms(kern, reps=20, flush_l2=True),
            "plain_ms": time_ms(plain, reps=20, flush_l2=True),
            "library_ms": time_ms(lib, reps=20, flush_l2=True) if lib else None,
            "bound_ms": bound(nbytes, flops)[0], "bound_by": bound(nbytes, flops)[1],
            "max_abs_err": err,
        }
        log(f"    ttm [{p}]: {json.dumps(ttm_row[p])}")

    summary = {
        "phase": "4 NELL-2 main path", "card": card,
        "shape": NELL2_SHAPE, "nnz": NELL2_NNZ, "ranks": NELL2_RANKS, "n_iter": N_ITER,
        "setup_s": {"generate_on_card": t_gen,
                    "cold_decompose_incl_schedules": t_cold, "warm_decompose": t_warm},
        "sweep_ms": sweep_ms, "sweep_ms_warm_runs": warm_runs,
        "host_us_per_small_kernel": launch_us, "device_kernels_per_sweep": kernels_per_sweep,
        "launches_per_sweep": {k: v / N_ITER for k, v in launches.items()},
        "kron_ms_per_sweep": kron_ms, "kron_plain_ms_per_sweep": kron_plain_ms,
        "kron_bound_ms_per_sweep": kron_bound, "kron_per_mode": per_mode,
        "ttm": ttm_row,
        "profile_warm_run": profile,
        "peak_memory_gb": peak_gb, "resident_at_start_gb": resident_gb,
        "slot_cache_gb": sum(nbytes_of(eng.device_schedule(coo, m).idx,
                                       eng.device_schedule(coo, m).vals) for m in range(3)) / 1e9,
        "operand_row_gathers_warm_run": gathers,
        "fit_history": hist.tolist(),
        "python_pipeline": python_pipeline,
    }
    print(json.dumps(summary), flush=True)
    rows = [
        {"name": "fused_kron_scatter", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/kron_scatter.cu",
         "replaces": "src/repro/kernels/kron_kernel.py:306",
         "launches": launches["fused_kron_scatter"], "max_abs_err": kron_err["fp32"],
         "ms": kron_ms["fp32"], "plain_ms": kron_plain_ms["fp32"],
         "device_ms": profile["kernel_ms"]["fused_kron_scatter"] / N_ITER,
         "bound_ms": kron_bound["fp32"],
         "bound_by": bound(kron_bytes, kron_flops, PEAK_TF32_FLOPS)[1],
         "f32_core_bound_ms": bound(kron_bytes, kron_flops)[0],
         # no single PyTorch call computes it without first forming the
         # (nnz, K) Kron rows, 79 GB at this size
         "library_ms": None},
        {"name": "ttm", "route": "cuda", "source": "src/repro_torch/kernels/csrc/ttm.cu",
         "replaces": "src/repro/kernels/ttm_kernel.py:62",
         "launches": launches["ttm"], "max_abs_err": ttm_row["fp32"]["max_abs_err"],
         "ms": ttm_row["fp32"]["ms"], "plain_ms": ttm_row["fp32"]["plain_ms"],
         "device_ms": profile["kernel_ms"]["ttm"] / N_ITER,
         "bound_ms": ttm_row["fp32"]["bound_ms"], "bound_by": ttm_row["fp32"]["bound_by"],
         "library_ms": ttm_row["fp32"]["library_ms"]},
    ]
    return {r["name"]: r for r in rows}, coo, res, (peak_gb, resident_gb)


def per_sweep_pipeline(plan, coo, scan_res, scan_launches, scan_sweep_ms) -> dict:
    """The per-sweep pipeline (``pipeline="python"``) on phase 4's tensor,
    through the scan plan's engine (its schedules) and from the same initial
    factors (the plan's default draw): its launch counts, the scan run's fit
    history, factors and core bit for bit (the same sweeps on deterministic
    kernels; only the fit is read back after each sweep), and its ms per
    sweep beside the scan pipeline's median of this run."""
    from repro_torch import tucker

    py_plan = tucker.plan(dataclasses.replace(plan.spec, pipeline="python"),
                          device=plan.device, engine=plan.engine)
    reset_launches()
    py = py_plan(coo)
    torch.cuda.synchronize()
    launches = read_launches()
    same = (np.array_equal(py.fit_history, scan_res.fit_history)
            and torch.equal(py.core, scan_res.core)
            and all(torch.equal(a, b) for a, b in zip(py.factors, scan_res.factors)))
    log(f"  per-sweep pipeline: launches {launches}, dispatches {py.dispatches}, "
        f"schedule builds {py.schedule_builds}, same fit, factors and core as the scan "
        f"pipeline: {same}")
    check(launches == scan_launches, f"per-sweep pipeline launches {launches}, want "
          f"{scan_launches}")
    check(py.dispatches == N_ITER and py.schedule_builds == 0,
          f"per-sweep pipeline: {py.dispatches} dispatches, {py.schedule_builds} builds")
    check(same, "the per-sweep pipeline differs from the scan pipeline")
    runs = [ms / N_ITER for ms in warm_ms(lambda: py_plan(coo))]
    sweep_ms = float(np.median(runs))
    log(f"  per-sweep pipeline warm runs: " + ", ".join(f"{m:.2f}" for m in runs)
        + f" ms per sweep (median {sweep_ms:.2f}; the scan pipeline {scan_sweep_ms:.2f})")
    return {"sweep_ms": sweep_ms, "sweep_ms_warm_runs": runs,
            "scan_sweep_ms": scan_sweep_ms, "launches": launches,
            "dispatches": py.dispatches, "same_bits_as_scan": same}


# -- phase 5: path B, the fused core update at NELL-2 size ---------------------


def phase5_fused_core(dev, card: str, coo, split_res, split_peak):
    """``split_res`` and ``split_peak`` (peak and resident GB) are phase 4's
    cold run of the split path on ``coo``."""
    from repro_torch import tucker
    from repro_torch.core.engine import make_engine
    from repro_torch.kernels import kron_kernel, ops, ttm_kernel

    log(f"phase 5: path B, make_engine('cuda', fuse_core=True) on the phase 4 tensor, "
        f"{N_ITER} sweeps")
    spec = tucker.TuckerSpec(shape=NELL2_SHAPE, ranks=NELL2_RANKS, n_iter=N_ITER)
    plan = tucker.plan(spec, device=dev, engine=make_engine("cuda", dev, fuse_core=True))
    torch.cuda.reset_peak_memory_stats()
    resident_gb = torch.cuda.memory_allocated() / 1e9  # the tensor and phase 4's schedules
    reset_launches()
    t0 = time.perf_counter()
    res = plan(coo)  # the same seeded initial factors as phase 4's run
    torch.cuda.synchronize()
    t_cold = time.perf_counter() - t0
    launches = read_launches()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    hist = res.fit_history
    log(f"  cold run: {t_cold:.3f} s, launches {launches}, fit {hist.tolist()}")
    split_peak_gb, split_resident_gb = split_peak
    log(f"  cold peak memory: path B {peak_gb:.2f} GB, {peak_gb - resident_gb:.2f} above the "
        f"{resident_gb:.2f} GB resident (the tensor and phase 4's schedules); split path "
        f"(phase 4) {split_peak_gb:.2f} GB, {split_peak_gb - split_resident_gb:.2f} above the "
        f"{split_resident_gb:.2f} GB resident (the tensor)")
    check(res.engine == "cuda", f"engine {res.engine}")
    check(launches == {"fused_kron_scatter": 3 * N_ITER, "ttm": 0, "kron_contrib": 0,
                       "scatter_rows": 0, "fused_kron_scatter_ttm": N_ITER, **NO_LM_LAUNCHES},
          f"path B launches {launches}")
    hist_err = float(np.abs(hist - split_res.fit_history).max())
    proj_err = max(float((a @ a.T - b @ b.T).abs().max())
                   for a, b in zip(res.factors, split_res.factors))
    log(f"  against phase 4 (split core): fit history max diff {hist_err:.3e} <= 1e-4, "
        f"projector max diff {proj_err:.3e} <= 1e-3")
    check(hist.shape == (N_ITER,) and bool(np.all(np.isfinite(hist))) and hist_err <= 1e-4,
          "fused-core fit history disagrees with the split path")
    check(proj_err <= 1e-3, "fused-core factors disagree with the split path")
    check(tuple(res.core.shape) == NELL2_RANKS, f"fused-core core shape {tuple(res.core.shape)}")
    # the core is all that fuse_core changes (the factors never read it)
    core_err = compare("path B core against phase 4's split core", "fp32", res.core,
                       split_res.core, NELL2_NNZ)

    # warm runs of the split plan (phase 4's, cached) and of path B in turns,
    # each with its peak memory above what was allocated before it; path B
    # makes no (nnz, R) operand-row gather (kernel 5 reads the factors itself)
    split_plan = tucker.plan(spec, device=dev)
    turns, warm_peak = [], {"split": 0.0, "fused": 0.0}
    gathers = ops._gathered_block_rows.calls
    for name, p in (("split", split_plan), ("fused", plan), ("fused", plan),
                    ("split", split_plan)):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        before = torch.cuda.memory_allocated()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        calls = ops._gathered_block_rows.calls
        start.record()
        warm = p(coo)
        end.record()
        end.synchronize()
        turns.append((name, start.elapsed_time(end) / N_ITER))
        warm_peak[name] = max(warm_peak[name],
                              (torch.cuda.max_memory_allocated() - before) / 1e9)
        check(warm.schedule_builds == 0, f"{name} warm run rebuilt schedules")
        if name == "fused":
            check(np.array_equal(warm.fit_history, hist), "path B warm run changed its result")
            check(ops._gathered_block_rows.calls == calls,
                  "path B's warm run gathered (nnz, R) operand rows")
    gathers = ops._gathered_block_rows.calls - gathers
    log("  warm ms per sweep, in turns: " + ", ".join(f"{n} {ms:.1f}" for n, ms in turns)
        + f"; operand-row gathers {gathers}; peak above the resident memory: split "
        f"{warm_peak['split']:.3f} GB, path B {warm_peak['fused']:.3f} GB")
    check(gathers == 0, f"the warm runs gathered operand rows {gathers} times")
    sweep_ms = float(np.mean([ms for n, ms in turns if n == "fused"]))
    split_sweep_ms = float(np.mean([ms for n, ms in turns if n == "split"]))
    profile = profile_run(lambda: plan(coo))

    # the megakernel at the path's shapes: against its plain version, against
    # the split core update it replaces (kernel 1's Y, then the TTM kernel).
    eng, fs, mode = plan.engine, [f.contiguous() for f in res.factors], 2
    sched = eng.device_schedule(coo, mode)
    fa, fb = kron_factors(fs, mode)
    u = fs[mode]
    n_rows = NELL2_SHAPE[mode]
    ra, rb, r, k = fa.shape[1], fb.shape[1], u.shape[1], fa.shape[1] * fb.shape[1]
    nnzp = int(sched.vals.shape[0])
    grid = dict(kron_kernel.mega_grid(dev, ra, rb, kron_kernel._padded_factor(fa).shape[1],
                                      kron_kernel._padded_factor(fb).shape[1], r, False,
                                      int(sched.parts.numel()) - 1),
                ranges=int(sched.parts.numel()) - 1)
    log(f"  megakernel grid (fp32): {grid}")
    visited = int(torch.unique(coo.indices[:, mode]).numel())
    row = {}
    for p in TOL:
        kern = partial(kron_kernel.fused_kron_scatter_ttm, fa, fb, u, sched, n_rows,
                       precision=p)
        plain = partial(kron_kernel.fused_kron_scatter_ttm_plain, fa, fb, u, sched, n_rows,
                        precision=p)
        got = synced(kern())
        err = compare(f"fused_kron_scatter_ttm NELL-2 mode {mode}", p, got, synced(plain()),
                      NELL2_NNZ)
        check(torch.equal(got, synced(kern())),
              f"fused_kron_scatter_ttm NELL-2 mode {mode} [{p}] differs between two calls")
        y = synced(kron_kernel.fused_kron_scatter(fa, fb, sched, n_rows, precision=p))
        split = synced(ttm_kernel.ttm(y.T, u.T, precision=p).T)
        compare(f"fused_kron_scatter_ttm NELL-2 against the split core update", p, got,
                split, NELL2_NNZ)
        # what the kernel must read, as kernel 1's bound counts it: the slot
        # coordinates and values, the schedule's rows and ranges, the two
        # factor matrices and U (as cast) once each; and the core written once
        fac = kron_kernel._cast_operands(p, fa, fb, u)
        nbytes = (nbytes_of(sched.idx, sched.vals, sched.rel_row, sched.blkmap, sched.parts,
                            *fac) + r * k * 4)
        flops = 3 * NELL2_NNZ * k + 2 * visited * r * k
        # fp32 runs on the tensor cores (3xTF32), bf16_fp32acc's Kron terms
        # on the CUDA cores
        bound_ms, bound_by = bound(nbytes, flops,
                                   PEAK_TF32_FLOPS if p == "fp32" else PEAK_F32_FLOPS)
        # PR 12's design read the gathered (nnz, R) rows of a and b instead of
        # the coordinates, at the f32 CUDA-core rate
        gathered_bytes = (nnzp * (ra + rb) * fac[0].element_size()
                          + nbytes_of(sched.vals, sched.rel_row, sched.blkmap, sched.parts,
                                      fac[2]) + r * k * 4)
        row[p] = {"ms": time_ms(kern), "plain_ms": time_ms(plain, reps=1),
                  "split_ttm_ms": time_ms(partial(ttm_kernel.ttm, y.T, u.T, precision=p),
                                          reps=20, flush_l2=True),
                  "split_unfolding_ms": time_ms(partial(
                      kron_kernel.fused_kron_scatter, fa, fb, sched, n_rows, precision=p)),
                  "bound_ms": bound_ms, "bound_by": bound_by, "bytes": nbytes,
                  "flops": flops, "f32_core_bound_ms": bound(nbytes, flops)[0],
                  "pr12_design_bound_ms": bound(gathered_bytes, flops)[0],
                  "max_abs_err": err}
        log(f"    fused_kron_scatter_ttm [{p}]: {json.dumps(row[p])}")
        del y, split, got
    print(json.dumps({
        "phase": "5 path B fused core update", "card": card, "shape": NELL2_SHAPE,
        "nnz": NELL2_NNZ, "ranks": NELL2_RANKS, "n_iter": N_ITER,
        "setup_s": {"cold_decompose_incl_schedules": t_cold}, "sweep_ms": sweep_ms,
        "split_sweep_ms_same_call": split_sweep_ms, "turns": turns,
        "launches_per_sweep": {k: n / N_ITER for k, n in launches.items()},
        "operand_row_gathers_warm_runs": gathers,
        "megakernel": row, "megakernel_grid": grid, "core_max_abs_err_vs_split": core_err,
        "profile_warm_run": profile, "peak_memory_gb": peak_gb,
        "resident_at_start_gb": resident_gb, "split_peak_memory_gb_phase4": split_peak_gb,
        "split_resident_at_start_gb_phase4": split_resident_gb,
        "warm_peak_above_resident_gb": warm_peak,
        "fit_history": hist.tolist()}), flush=True)
    return {"fused_kron_scatter_ttm": {
        "name": "fused_kron_scatter_ttm", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/kron_scatter_ttm.cu",
        "replaces": "src/repro/kernels/kron_kernel.py:428",
        "launches": launches["fused_kron_scatter_ttm"], "max_abs_err": row["fp32"]["max_abs_err"],
        "ms": row["fp32"]["ms"], "plain_ms": row["fp32"]["plain_ms"],
        "device_ms": profile["kernel_ms"]["fused_kron_scatter_ttm"] / N_ITER,
        "bound_ms": row["fp32"]["bound_ms"], "bound_by": row["fp32"]["bound_by"],
        "pr12_design_bound_ms": row["fp32"]["pr12_design_bound_ms"],
        # no single PyTorch call builds Y from the nonzeros and contracts it
        "library_ms": None}}


# -- phase 6: path A, the 4-way path at NIPS size ------------------------------


def phase6_nips(dev, card: str):
    from repro_torch import tucker
    from repro_torch.core.coo import SparseCOO, fold_dense
    from repro_torch.core.engine import make_engine
    from repro_torch.kernels import kron_kernel, ops, ttm_kernel
    from repro_torch.sparse.layout import slot_rows

    log(f"phase 6: path A, NIPS size {NIPS_SHAPE}, {NIPS_NNZ} nnz, ranks {NIPS_RANKS}, "
        f"{N_ITER} sweeps")
    t0 = time.perf_counter()
    idx, vals = synthetic(dev, NIPS_SHAPE, NIPS_NNZ, SEED, "counts")
    coo = SparseCOO.from_parts(idx, vals, NIPS_SHAPE)
    torch.cuda.synchronize()
    t_gen = time.perf_counter() - t0
    check(unique_coords(coo), "synthetic coordinates are not unique")
    del idx, vals
    spec = tucker.TuckerSpec(shape=NIPS_SHAPE, ranks=NIPS_RANKS, n_iter=N_ITER)
    plan = tucker.plan(spec, device=dev)

    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t0 = time.perf_counter()
    res = tucker.decompose(coo, NIPS_RANKS, n_iter=N_ITER, device=dev)
    torch.cuda.synchronize()
    t_cold = time.perf_counter() - t0
    launches = read_launches()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    hist = res.fit_history
    log(f"  cold run: {t_cold:.3f} s, launches {launches}, schedule builds "
        f"{res.schedule_builds}, peak {peak_gb:.2f} GB, fit {hist.tolist()}")
    check(res.engine == "cuda", f"engine {res.engine}")
    check(launches == {"fused_kron_scatter": 0, "ttm": N_ITER, "kron_contrib": 8 * N_ITER,
                       "scatter_rows": 4 * N_ITER, "fused_kron_scatter_ttm": 0,
                       **NO_LM_LAUNCHES},
          f"path A launches {launches}")
    check(hist.shape == (N_ITER,) and bool(np.all(np.isfinite(hist)))
          and bool(np.all((hist >= 0) & (hist <= 1))), f"fit history {hist}")
    check(all(bool(torch.isfinite(f).all()) for f in res.factors),
          "non-finite factors")
    check(tuple(res.core.shape) == spec.ranks, f"core shape {tuple(res.core.shape)}")

    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    warm = plan(coo)
    end.record()
    end.synchronize()
    sweep_ms = start.elapsed_time(end) / N_ITER
    check(warm.schedule_builds == 0 and np.array_equal(warm.fit_history, hist),
          "path A warm run rebuilt schedules or changed its result")
    del warm
    profile = profile_run(lambda: plan(coo))

    # fuse_core on a 4-way tensor: there is no megakernel above order 3, so
    # the core update is the TTM of the Y_(3) the sweep built, with no second
    # chain: the launches, the result and the time are the split path's.
    fplan = tucker.plan(spec, device=dev, engine=make_engine("cuda", dev, fuse_core=True))
    fplan(coo)  # builds the new engine's schedules
    reset_launches()
    start.record()
    fres = fplan(coo)
    end.record()
    end.synchronize()
    fused_sweep_ms = start.elapsed_time(end) / N_ITER
    flaunch = read_launches()
    log(f"  fuse_core: {fused_sweep_ms:.1f} ms per sweep (split {sweep_ms:.1f}), launches "
        f"{flaunch}, core bit-identical to the split run: {torch.equal(fres.core, res.core)}")
    check(flaunch == launches, f"fuse_core on the 4-way path launches {flaunch}, want {launches}")
    check(np.abs(fres.fit_history - hist).max() <= 1e-4, "fuse_core fit history differs")
    compare("NIPS core with fuse_core against the split run", "fp32", fres.core, res.core,
            NIPS_NNZ)
    del fplan, fres

    # each kernel at the path's shapes against its plain version, mode by
    # mode; the 51 GB second-link contrib exists once at a time, and the
    # plain versions run on slot chunks of it.
    eng, fs = plan.engine, [f.contiguous() for f in res.factors]
    tot = {name: {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0, "bytes": 0, "flops": 0,
                  "bound_ms": 0.0, "max_abs_err": 0.0} for name in ("kron_contrib", "scatter_rows")}
    per_mode = []
    for mode in range(4):
        sched = eng.device_schedule(coo, mode)
        n_rows = NIPS_SHAPE[mode]
        rows, v = ops._gathered_block_rows(coo.indices, coo.values, fs, mode, sched, 4)
        ones = torch.ones_like(v)
        n_terms = max_row_count(coo, mode)
        nnzp = v.shape[0]
        m = {"mode": mode, "slots": nnzp, "ranges": int(sched.parts.numel()) - 1}
        k1 = rows[0].shape[1] * rows[1].shape[1]
        step = (1 << 26) // (k1 * rows[2].shape[1])  # slots per plain chunk: 268 MB
        # link 1: (nnzp, R) x (nnzp, R) -> (nnzp, R^2), written once, read by link 2
        c1 = synced(kron_kernel.kron_contrib(rows[0], rows[1], v))
        err1 = compare(f"kron_contrib NIPS mode {mode} link 1", "fp32", c1,
                       synced(kron_kernel.kron_contrib_plain(rows[0], rows[1], v)), 1)
        # link 2: (nnzp, R^2) x (nnzp, R) -> (nnzp, R^3), compared by chunks
        c2 = synced(kron_kernel.kron_contrib(c1, rows[2], ones))
        err2, scale2, finite = 0.0, 0.0, True
        for s in range(0, nnzp, step):  # chunks: a full-size temporary would not fit
            want = kron_kernel.kron_contrib_plain(c1[s:s + step], rows[2][s:s + step],
                                                  ones[s:s + step])
            err2 = max(err2, float((c2[s:s + step] - want).abs().max()))
            scale2 = max(scale2, float(want.abs().max()))
            finite = finite and bool(torch.isfinite(c2[s:s + step]).all())
        ok = finite and err2 <= TOL["fp32"] * max(scale2, 1e-30)
        log(f"  kron_contrib NIPS mode {mode} link 2 [fp32]: max_abs_err {err2:.3e} <= "
            f"{TOL['fp32'] * scale2:.3e} (by chunks of {step} slots) {'ok' if ok else 'FAIL'}")
        check(ok, f"kron_contrib NIPS mode {mode} link 2 disagrees with its plain version")
        y = synced(kron_kernel.scatter_rows(c2, sched, n_rows))
        err_s = compare(f"scatter_rows NIPS mode {mode}", "fp32", y,
                        synced(kron_kernel.scatter_rows_plain(c2, sched, n_rows)), n_terms)
        y_plain = synced(chain_plain(rows, v, sched, n_rows, "fp32", step))
        compare(f"Y_({mode}) NIPS, kernels against the plain chain by chunks", "fp32", y,
                y_plain, n_terms)
        if mode == 3:  # the core update's unfolding, (17, 4096)
            y3, y3_plain = y, y_plain
        slots = slot_rows(sched)
        k = c2.shape[1]
        # times: scatter_rows while c2 exists, then kron_contrib with c2 freed
        s_ms = time_ms(partial(kron_kernel.scatter_rows, c2, sched, n_rows))
        s_plain = time_ms(partial(kron_kernel.scatter_rows_plain, c2, sched, n_rows), reps=1)
        s_lib = time_ms(lambda: torch.zeros((n_rows, k), device=dev).index_add_(0, slots, c2),
                        reps=1)
        s_bytes = nbytes_of(c2, sched.rel_row, sched.blkmap, sched.parts) + n_rows * k * 4
        s_flops = NIPS_NNZ * k
        del c2, y
        torch.cuda.empty_cache()
        c_ms = time_ms(partial(kron_kernel.kron_contrib, rows[0], rows[1], v))
        c_ms += time_ms(partial(kron_kernel.kron_contrib, c1, rows[2], ones))
        c_plain = time_ms(partial(kron_kernel.kron_contrib_plain, rows[0], rows[1], v))

        def link2_plain_chunks():
            for s in range(0, nnzp, step):
                kron_kernel.kron_contrib_plain(c1[s:s + step], rows[2][s:s + step],
                                               ones[s:s + step])

        c_plain += time_ms(link2_plain_chunks, reps=1)
        c_lib = time_ms(lambda: torch.einsum("ti,tj->tij", rows[0] * v[:, None], rows[1]))
        c_lib += time_ms(lambda: torch.einsum("ti,tj->tij", c1 * ones[:, None], rows[2]),
                         reps=3)
        c_bytes = nbytes_of(rows[0], rows[1], v, c1, c1, rows[2], ones) + nnzp * k * 4
        c_flops = 2 * nnzp * k1 + 2 * nnzp * k
        for name, ms, pl, lib, nb, fl, err in (
                ("kron_contrib", c_ms, c_plain, c_lib, c_bytes, c_flops, max(err1, err2)),
                ("scatter_rows", s_ms, s_plain, s_lib, s_bytes, s_flops, err_s)):
            b_ms, _ = bound(nb, fl)
            t = tot[name]
            t["ms"] += ms
            t["plain_ms"] += pl
            t["library_ms"] += lib
            t["bytes"] += nb
            t["flops"] += fl
            t["bound_ms"] += b_ms
            t["max_abs_err"] = max(t["max_abs_err"], err)
            m[name] = {"ms": ms, "plain_ms": pl, "library_ms": lib, "bound_ms": b_ms}
        log(f"    mode {mode}: {json.dumps(m)}")
        per_mode.append(m)
        del c1, rows, v, ones, slots, y_plain
        torch.cuda.empty_cache()

    # the core update at the path's shapes: the TTM kernel on the transposed
    # views of Y_(3) (17, 4096) and U_3 (17, 16), against its plain version;
    # then the returned core against one made by the plain versions alone
    # (plain chain, plain TTM) from the returned factors, which are the ones
    # the last sweep's core update used.
    u3 = fs[3]
    ttm_row = {}
    for p in TOL:
        kern = partial(ttm_kernel.ttm, y3.T, u3.T, precision=p)
        plain = partial(ttm_kernel.ttm_plain, y3.T, u3.T, precision=p)
        err = compare(f"ttm NIPS y {tuple(y3.T.shape)} (transposed view) u {tuple(u3.T.shape)}",
                      p, check_ttm_call("NIPS", y3.T, u3.T, p), synced(plain()), y3.shape[0])
        ttm_row[p] = {"ms": time_ms(kern, reps=20), "plain_ms": time_ms(plain, reps=20),
                      "max_abs_err": err}
    core_plain = fold_dense(ttm_kernel.ttm_plain(y3_plain.T, u3.T).T, 3, NIPS_RANKS)
    core_err = compare("NIPS core against the plain chain and plain TTM", "fp32", res.core,
                       core_plain, NIPS_NNZ)
    del y3, y3_plain, core_plain
    print(json.dumps({
        "phase": "6 path A NIPS", "card": card, "shape": NIPS_SHAPE, "nnz": NIPS_NNZ,
        "ranks": NIPS_RANKS, "n_iter": N_ITER,
        "setup_s": {"generate_on_card": t_gen, "cold_decompose_incl_schedules": t_cold},
        "sweep_ms": sweep_ms, "fuse_core_sweep_ms": fused_sweep_ms,
        "launches_per_sweep": {k: n / N_ITER for k, n in launches.items()},
        "per_sweep": tot, "per_mode": per_mode, "ttm_core_update": ttm_row,
        "core_max_abs_err_vs_plain": core_err, "profile_warm_run": profile,
        "peak_memory_gb": peak_gb, "fit_history": hist.tolist()}), flush=True)
    out = {}
    for name, src, line in (("kron_contrib", "kron_contrib.cu", 74),
                            ("scatter_rows", "scatter_rows.cu", 207)):
        t = tot[name]
        out[name] = {
            "name": name, "route": "cuda", "source": f"src/repro_torch/kernels/csrc/{src}",
            "replaces": f"src/repro/kernels/kron_kernel.py:{line}",
            "launches": launches[name], "max_abs_err": t["max_abs_err"], "ms": t["ms"],
            "plain_ms": t["plain_ms"], "device_ms": profile["kernel_ms"][name] / N_ITER,
            "bound_ms": t["bound_ms"], "bound_by": bound(t["bytes"], t["flops"])[1],
            "library_ms": t["library_ms"]}
    return out


# -- phase 10: the paper's Table V tensors --------------------------------------

# Table V tensors densified for the quality check up to this many entries
# (NELL-2's 1000^3 is 4 GB in f32; Amazon's 20000^3 would be 32 TB).
TABLE5_DENSE_MAX = 1 << 30


def tf32_off() -> None:
    """The dense products (the dense path, the reconstructions) must run in
    full f32 on the card, as on the CPU: TF32 must be off, as ``main`` set it
    and phase 9 restores it."""
    check(not torch.backends.cuda.matmul.allow_tf32
          and torch.get_float32_matmul_precision() == "highest",
          "TF32 is allowed for float32 matrix products")


def error_at_nonzeros(coo, core, factors) -> float:
    """||X - Xhat|| / ||X|| from Xhat at the nonzeros alone, in float64 (a
    check, not the port's path): ||X - Xhat||^2 = ||X||^2 - 2 <X, Xhat> +
    ||G||^2 for orthonormal factors. Needs no dense tensor."""
    from repro_torch.core.reconstruct import reconstruct_at

    core, factors = core.double(), [f.double() for f in factors]
    x = coo.values.double()
    xx = float(x @ x)
    xhat = reconstruct_at(core, factors, coo.indices)
    return float(np.sqrt(max(xx - 2 * float(x @ xhat) + float((core * core).sum()), 0.0) / xx))


def warm_ms(fn, runs: int = 3) -> list:
    """Milliseconds of each of ``runs`` warm calls of ``fn``, each bracketed
    by CUDA events."""
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    out = []
    for _ in range(runs):
        start.record()
        fn()
        end.record()
        end.synchronize()
        out.append(start.elapsed_time(end))
    return out


def table5_kernels(name, coo, eng, fs) -> dict:
    """Kernels 1 and 2 at one Table V tensor's shapes, on the card and
    against their plain versions (fp32): kernel 1 on every mode, kernel 2 on
    the core update; times, the plain versions' and ``torch.matmul``'s, and
    bounds as in phase 4 (kernel 1's products at the TF32 rate)."""
    from repro_torch.kernels import kron_kernel, ttm_kernel

    n = coo.ndim
    k1 = {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0, "max_abs_err": 0.0, "bytes": 0,
          "flops": 0, "per_mode": []}
    y_last = None
    for mode in range(n):
        sched = eng.device_schedule(coo, mode)
        n_rows = coo.shape[mode]
        fa, fb = kron_factors(fs, mode)
        kern = partial(kron_kernel.fused_kron_scatter, fa, fb, sched, n_rows)
        plain = partial(kron_kernel.fused_kron_scatter_plain, fa, fb, sched, n_rows)
        got = synced(kern())
        k = got.shape[1]
        err = compare(f"fused_kron_scatter {name} mode {mode} (K {k}, {coo.nnz} nnz)", "fp32",
                      got, synced(plain()), max_row_count(coo, mode))
        check(torch.equal(got, synced(kern())), f"fused_kron_scatter {name} mode {mode} "
              f"differs between two calls")
        nbytes = (nbytes_of(sched.idx, sched.vals, sched.rel_row, sched.blkmap, sched.parts,
                            *[f for f in (fa, fb) if f is not None]) + n_rows * k * 4)
        flops = (3 if fb is not None else 2) * coo.nnz * k
        ms, p_ms = time_ms(kern), time_ms(plain, reps=1)
        b_ms = bound(nbytes, flops, PEAK_TF32_FLOPS)[0]
        k1["per_mode"].append({"mode": mode, "K": k, "ms": ms, "plain_ms": p_ms,
                               "bound_ms": b_ms})
        for key, v in (("ms", ms), ("plain_ms", p_ms), ("bound_ms", b_ms), ("bytes", nbytes),
                       ("flops", flops)):
            k1[key] += v
        k1["max_abs_err"] = max(k1["max_abs_err"], err)
        if mode == n - 1:
            y_last = got
    k1["bound_by"] = bound(k1["bytes"], k1["flops"], PEAK_TF32_FLOPS)[1]
    yc, uc = y_last.T, fs[n - 1].T
    l_, i_ = yc.shape
    err = compare(f"ttm {name} y {tuple(yc.shape)} u {tuple(uc.shape)}", "fp32",
                  check_ttm_call(name, yc, uc, "fp32"),
                  synced(ttm_kernel.ttm_plain(yc, uc)), i_)
    nbytes = (l_ * i_ + uc.shape[0] * i_) * 4 + l_ * uc.shape[0] * 4
    flops = 2 * l_ * i_ * uc.shape[0]
    k2 = {"ms": time_ms(partial(ttm_kernel.ttm, yc, uc), reps=20, flush_l2=True),
          "plain_ms": time_ms(partial(ttm_kernel.ttm_plain, yc, uc), reps=20, flush_l2=True),
          "library_ms": time_ms(partial(torch.matmul, yc, uc.T), reps=20, flush_l2=True),
          "bound_ms": bound(nbytes, flops)[0], "bound_by": bound(nbytes, flops)[1],
          "max_abs_err": err, "shape": [l_, i_, uc.shape[0]]}
    return {"fused_kron_scatter": k1, "ttm": k2}


def phase10_table5(dev, card: str) -> None:
    from repro_torch import tucker
    from repro_torch.core.hooi import sweep_call_counts
    from repro_torch.core.reconstruct import relative_error_dense
    from repro_torch.sparse.datasets import PAPER_DATASETS

    tf32_off()
    log("phase 10: the paper's Table V tensors at their published shapes, ranks and sweeps, "
        "householder")
    for name, ds in PAPER_DATASETS.items():
        release_memory()
        t0 = time.perf_counter()
        coo = ds.build(device=dev)  # drawn in numpy as the reference draws it
        t_build = time.perf_counter() - t0
        spec = tucker.spec_for(coo, ds.ranks, n_iter=ds.n_iter, method="householder")
        n, n_iter = coo.ndim, ds.n_iter
        expect = {"fused_kron_scatter": n * n_iter, "ttm": n_iter}
        label = f"{name} {ds.shape}, {coo.nnz} nnz, ranks {spec.ranks}, {n_iter} sweeps"
        cu, _ = card_vs_cpu(label, coo, spec=spec, expect=expect,
                            align="basis" if name == "matmul" else "sign")

        # quality: the fit against an error that does not use the projection
        # identity, the dense one where the tensor can be densified
        at_nnz = error_at_nonzeros(coo, cu.core, cu.factors)
        dense = None
        if math.prod(ds.shape) <= TABLE5_DENSE_MAX:
            dense = float(relative_error_dense(coo.to_dense(), cu.core, cu.factors))
        indep = dense if dense is not None else at_nnz
        log(f"  {name}: rel_error {cu.rel_error:.7f}, dense error {dense}, error at the "
            f"nonzeros (f64) {at_nnz:.7f}; |rel_error - independent| "
            f"{abs(cu.rel_error - indep):.3e} <= 1e-4")
        check(abs(cu.rel_error - indep) <= 1e-4,
              f"{name}: rel_error {cu.rel_error} against the independent error {indep}")

        # the tensor's main path on the card: cold (schedules) and warm
        release_memory()
        plan = tucker.plan(spec, device=dev)
        torch.cuda.reset_peak_memory_stats()
        resident = torch.cuda.memory_allocated()
        reset_launches()
        t0 = time.perf_counter()
        res = plan(coo)
        torch.cuda.synchronize()
        t_cold = time.perf_counter() - t0
        launches = {k: v for k, v in read_launches().items() if v}
        peak = torch.cuda.max_memory_allocated()
        check(launches == expect, f"{name}: launches {launches}, want {expect}")
        check(res.n_sweeps == n_iter and bool(np.all(np.isfinite(res.fit_history))),
              f"{name}: fit history {res.fit_history}")
        runs = [ms / n_iter for ms in warm_ms(lambda: plan(coo))]
        kernels = table5_kernels(name, coo, plan.engine, [f.contiguous() for f in res.factors])
        counts = sweep_call_counts(ds.shape, spec.ranks, coo.nnz, n_iter)
        summary = {
            "phase": "10 Table V", "card": card, "dataset": name, "shape": ds.shape,
            "nnz": coo.nnz, "ranks": spec.ranks, "n_iter": n_iter, "exact": ds.exact,
            "build_s": t_build, "cold_decompose_incl_schedules_s": t_cold,
            "sweep_ms": float(np.median(runs)), "sweep_ms_warm_runs": runs,
            "peak_memory_gb": peak / 1e9, "above_resident_gb": (peak - resident) / 1e9,
            "launches": launches, "sweep_call_counts": counts,
            "qrp_calls_run": n * n_iter,
            # the quality of the card's run from card_vs_cpu's factors; the
            # timed runs start from the plan's default draw
            "fit_history": cu.fit_history.tolist(), "rel_error": cu.rel_error,
            "dense_error": dense, "error_at_nonzeros": at_nnz,
            "timed_run_fit_history": res.fit_history.tolist(), "kernels": kernels,
        }
        log(f"  {name}: {summary['sweep_ms']:.3f} ms per sweep (warm runs "
            + ", ".join(f"{m:.3f}" for m in runs) + f"), peak {peak / 1e9:.3f} GB, "
            f"call counts {counts}")
        print(json.dumps(summary), flush=True)
        del coo, cu, res, plan
    release_memory()


# -- phase 11: dense HOOI (Table II, Fig. 6) and completion -----------------------

TABLE2_SIZE = 800  # the paper's largest Table II size, 2.05 GB in f32
TABLE2_RANK = 16
METHODS = ("svd", "householder", "gram")


def table2_tensor(size: int, dev, rank: int = TABLE2_RANK):
    """``benchmarks/table2_accuracy.py``'s tensor in f32: a random
    rank-(16, 16, 16) tensor, factors and core from ``default_rng(size)``,
    the product taken as a TTM chain in f64 on ``dev``, plus noise of 1e-9;
    the noise from that numpy generator on the CPU (as the benchmark and the
    CPU test at 200^3 draw it), from a torch generator seeded with ``size``
    on the card (512 M numpy draws would take the host ~10 s)."""
    from repro_torch.core.reconstruct import reconstruct_dense

    rng = np.random.default_rng(size)
    us = [np.linalg.qr(rng.standard_normal((size, rank)))[0] for _ in range(3)]
    g = rng.standard_normal((rank,) * 3)
    x = reconstruct_dense(torch.from_numpy(g).to(dev), [torch.from_numpy(u).to(dev) for u in us])
    if x.device.type == "cpu":
        x += 1e-9 * torch.from_numpy(rng.standard_normal(x.shape))
    else:
        gen = torch.Generator(device=x.device).manual_seed(size)
        x += 1e-9 * torch.randn(x.shape, generator=gen, dtype=x.dtype, device=x.device)
    return x.to(torch.float32)


def phase11_dense(dev, card: str) -> None:
    from repro_torch import tucker
    from repro_torch.core.reconstruct import reconstruct_dense, relative_error_dense
    from repro_torch.sparse.generators import low_rank_sparse_tensor, random_sparse_tensor

    tf32_off()
    log(f"phase 11: dense HOOI (Table II at {TABLE2_SIZE}^3, Fig. 6) and completion")
    summary = {"phase": "11 dense HOOI and completion", "card": card}

    # Table II: the card against the CPU at 200^3, then the paper's 800^3.
    # The fit here sits at the f32 floor of the projection identity (ROADMAP
    # queue 3): sqrt(||X||^2 - ||G||^2) cancels to 0 or to a few 1e-4 by
    # rounding alone, so the fit histories are held to 1e-3; the dense
    # errors, which do not cancel, are printed beside them.
    x200 = table2_tensor(200, torch.device("cpu"))
    for method in METHODS:
        cu, cp = card_vs_cpu(
            f"Table II 200^3, rank 16, {method}", x200, fit_tol=1e-3,
            spec=tucker.TuckerSpec(x200.shape, (TABLE2_RANK,) * 3, algorithm="dense",
                                   method=method, n_iter=3))
        e_card = relative_error_dense(x200, cu.core.cpu(), [f.cpu() for f in cu.factors])
        e_cpu = relative_error_dense(x200, cp.core, cp.factors)
        log(f"  dense error card {float(e_card):.3e}, CPU {float(e_cpu):.3e}")
    del x200, cu, cp
    t0 = time.perf_counter()
    x = table2_tensor(TABLE2_SIZE, dev)
    torch.cuda.synchronize()
    table2 = {"size": TABLE2_SIZE, "build_s": time.perf_counter() - t0}
    for method in METHODS:
        plan = tucker.plan(tucker.spec_for(x, (TABLE2_RANK,) * 3, n_iter=3, method=method),
                           device=dev)
        torch.cuda.reset_peak_memory_stats()
        resident = torch.cuda.memory_allocated()
        reset_launches()
        t0 = time.perf_counter()
        res = plan(x)
        torch.cuda.synchronize()
        cold = time.perf_counter() - t0
        launches = {k: v for k, v in read_launches().items() if v}
        peak = torch.cuda.max_memory_allocated()
        check(not launches and res.engine == "torch" and res.dispatches == 0
              and res.launches == 0, f"Table II {method}: launches {launches}, engine "
              f"{res.engine}, dispatches {res.dispatches}")
        runs = [ms / 3 for ms in warm_ms(lambda: plan(x))]
        err = float(relative_error_dense(x, res.core, res.factors))
        table2[method] = {"rel_error_dense": err, "rel_error": res.rel_error,
                          "fit_history": res.fit_history.tolist(),
                          "sweep_ms": float(np.median(runs)), "sweep_ms_warm_runs": runs,
                          "cold_s": cold, "peak_memory_gb": peak / 1e9,
                          "above_resident_gb": (peak - resident) / 1e9}
        log(f"  Table II {TABLE2_SIZE}^3 {method}: relative_error_dense {err:.3e} <= 1e-5, "
            f"{table2[method]['sweep_ms']:.2f} ms per sweep, peak {peak / 1e9:.2f} GB "
            f"({(peak - resident) / 1e9:.2f} above the tensor)")
        check(err <= 1e-5, f"Table II {method}: relative_error_dense {err}")
    # the claim: QRP loses no accuracy against SVD, to 1e-6. One-sided: in
    # f32 the SVD update's own error grows with the size while QRP's does
    # not (on the CPU: svd 0.98e-6 at 200^3, 2.0e-6 at 400^3 and 600^3;
    # householder 0.79e-6, 0.78e-6, 0.94e-6), so |qrp - svd| <= 1e-6 would
    # fail for SVD's rounding, not for a loss of QRP's
    for method in ("householder", "gram"):
        gap = table2[method]["rel_error_dense"] - table2["svd"]["rel_error_dense"]
        log(f"  Table II: {method} - svd = {gap:.3e} (<= 1e-6)")
        check(gap <= 1e-6, f"Table II: {method} loses {gap} against svd")
    summary["table2"] = table2
    del x, plan, res
    release_memory()

    # Fig. 6: sparse HOOI (gram) against dense HOOI (svd) at 200^3, 2 sweeps;
    # warm times of whole decompositions, nothing gated on speed
    fig6 = []
    for sp in (1e-5, 1e-4, 1e-3):
        coo = random_sparse_tensor((200,) * 3, sp, seed=int(sp * 1e7) % 997).to(dev)
        sparse_plan = tucker.plan(tucker.spec_for(coo, (16,) * 3, n_iter=2, method="gram"),
                                  device=dev)
        reset_launches()
        rs = sparse_plan(coo)
        torch.cuda.synchronize()
        launches = {k: v for k, v in read_launches().items() if v}
        check(launches == {"fused_kron_scatter": 6, "ttm": 2},
              f"Fig. 6 sparse {sp}: launches {launches}")
        dense = coo.to_dense()
        dense_plan = tucker.plan(tucker.spec_for(dense, (16,) * 3, n_iter=2, method="svd"),
                                 device=dev)
        reset_launches()
        rd = dense_plan(dense)
        torch.cuda.synchronize()
        check(not any(read_launches().values()), f"Fig. 6 dense {sp} launched kernels")
        for r in (rs, rd):
            check(bool(np.all(np.isfinite(r.fit_history)))
                  and bool(np.all((r.fit_history >= 0) & (r.fit_history <= 1))),
                  f"Fig. 6 {sp}: fit history {r.fit_history}")
        sparse_ms = time_ms(lambda: sparse_plan(coo), reps=3)
        dense_ms = time_ms(lambda: dense_plan(dense), reps=3)
        fig6.append({"sparsity": sp, "nnz": coo.nnz, "sparse_gram_ms": sparse_ms,
                     "dense_svd_ms": dense_ms, "speedup": dense_ms / sparse_ms,
                     "sparse_fit": rs.fit_history.tolist(), "dense_fit": rd.fit_history.tolist()})
        log(f"  Fig. 6 200^3 at {sp:g} ({coo.nnz} nnz): sparse gram {sparse_ms:.2f} ms, "
            f"dense svd {dense_ms:.2f} ms (2 sweeps, warm)")
    summary["fig6"] = fig6
    release_memory()

    # completion: the card against the CPU at 64x64x32, then an MRI-sized
    # 256x256x128 volume observed at 20% of its entries
    ranks, kw = (16, 16, 16), dict(algorithm="complete", method="gram", n_iter=2, n_rounds=10)
    small, _ = low_rank_sparse_tensor((64, 64, 32), ranks, 0.2, seed=SEED)
    card_vs_cpu("completion 64x64x32, 20% observed, ranks 16", small,
                spec=tucker.TuckerSpec(small.shape, ranks, **kw))
    t0 = time.perf_counter()
    coo, truth = low_rank_sparse_tensor((256, 256, 128), ranks, 0.2, seed=SEED)
    t_gen = time.perf_counter() - t0
    coo = coo.to(dev)
    plan = tucker.plan(tucker.spec_for(coo, ranks, **kw), device=dev)
    reset_launches()
    t0 = time.perf_counter()
    res = plan(coo)
    torch.cuda.synchronize()
    cold = time.perf_counter() - t0
    check(not any(read_launches().values()), "completion launched kernels")
    runs = [ms / kw["n_rounds"] for ms in warm_ms(lambda: plan(coo), runs=1)]
    x_true = reconstruct_dense(torch.from_numpy(truth["core"]).to(dev),
                               [torch.from_numpy(f).to(dev) for f in truth["factors"]]).float()
    seen = torch.zeros(coo.shape, dtype=torch.bool, device=dev)
    seen[tuple(coo.indices.long().T)] = True
    diff = reconstruct_dense(res.core, res.factors) - x_true
    unobserved = float(diff[~seen].norm() / x_true[~seen].norm())
    observed = float(diff[seen].norm() / x_true[seen].norm())
    check(np.isfinite(unobserved) and bool(np.all(np.isfinite(res.fit_history))),
          f"completion: error {unobserved}, fit {res.fit_history}")
    summary["completion"] = {
        "shape": coo.shape, "ranks": ranks, "observed": coo.nnz, **kw,
        "generate_s": t_gen, "cold_s": cold, "ms_per_em_round": runs[0],
        "error_unobserved": unobserved, "error_observed": observed,
        "fit_history_last_round": res.fit_history.tolist()}
    log(f"  completion 256x256x128, {coo.nnz} observed: error on the unobserved entries "
        f"{unobserved:.4e} (observed {observed:.4e}), {runs[0]:.2f} ms per EM round, "
        f"generated in {t_gen:.1f} s")
    print(json.dumps(summary), flush=True)
    del coo, plan, res, x_true, seen, diff
    release_memory()


# -- phase 7: the LM kernels at odd shapes ------------------------------------

# (b, H, KVH, S, T, D, causal, what the case covers)
FLASH_CASES = [
    (2, 4, 2, 128, 128, 64, True, "GQA G=2"),
    (1, 8, 4, 64, 256, 32, True, "T > S"),
    (2, 2, 2, 100, 100, 64, True, "S not a block multiple"),
    (1, 4, 1, 128, 128, 128, True, "MQA, D 128"),
    (2, 3, 3, 77, 77, 80, True, "D 80, S 77"),
    (1, 6, 2, 33, 200, 16, True, "D 16, G 3, T > S"),
    (2, 2, 1, 1, 300, 80, True, "one query row, as in decode"),
    (1, 4, 2, 70, 130, 48, False, "non-causal, T not a block multiple"),
    (4, 32, 32, 1024, 1024, 80, True, "the Zamba2 serving shape at S 1,024"),
    (1, 4, 2, 300, 300, 80, True, "S 300, not a multiple of the 128-row q block"),
    (1, 6, 2, 200, 520, 64, True, "T > S, G 3, T not a multiple of the 128-key block"),
]
# the model's layout, (b, s, heads, hd) projections passed as (b, heads, s,
# hd) views: (b, s, t, H, KVH, D, causal, what the case covers); D 28 (the
# qwen2-7b SMOKE head dim) breaks TMA's 16-byte rules and takes the tensor-core
# kernel's ordinary-load staging
VIEW_CASES = [
    (2, 90, 90, 6, 3, 80, True, "D 80, G 2"),
    (2, 130, 130, 4, 4, 16, True, "D 16"),
    (1, 200, 200, 6, 2, 64, True, "D 64, G 3"),
    (2, 129, 129, 2, 1, 128, True, "D 128, MQA"),
    (2, 100, 100, 4, 2, 28, True, "D 28: ordinary-load staging"),
    (1, 64, 192, 4, 2, 80, True, "D 80, T > S"),
    (2, 77, 150, 4, 2, 80, False, "D 80, non-causal"),
]
# (BH, C, L, P, N, decay rate, what the case covers); the log decays are
# cumulative sums of -rate * |N(0, 1)|. Each case runs with B and C in bf16
# and in f32.
SSD_CASES = [
    (2, 3, 64, 32, 16, 0.1, "the reference kernel test's first shape"),
    (1, 1, 128, 64, 32, 0.1, "the reference kernel test's second shape"),
    (2, 2, 32, 16, 16, 0.1, "L 32"),
    (3, 2, 256, 64, 64, 0.1, "L 256, N = P 64 (the Zamba2 path's chunk)"),
    (1, 3, 100, 48, 80, 0.1, "L, N, P not multiples of 16 or 64"),
    (2, 1, 200, 128, 128, 0.1, "N = P 128"),
    (1, 2, 256, 16, 128, 0.1, "P 16, N 128"),
    (2, 2, 256, 64, 64, 8.0, "steep decay: exp above the diagonal overflows"),
    (3, 2, 1, 17, 1, 0.1, "L 1, N 1, P 17"),
    (2, 2, 63, 1, 17, 0.1, "L 63, P 1, N 17"),
    (2, 1, 64, 80, 64, 0.1, "L 64, P 80"),
    (1, 3, 255, 64, 80, 0.1, "L 255, N 80"),
    (1, 2, 255, 17, 64, 8.0, "L 255, P 17, steep decay"),
    (2, 1, 256, 128, 1, 0.1, "N 1, P 128"),
    (1, 2, 256, 1, 128, 8.0, "P 1, N 128, steep decay"),
]


def phase7_lm_kernels(dev) -> None:
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ssd_scan

    log("phase 7: kernels 6 and 7 against their plain versions, odd shapes")
    g = torch.Generator(device=dev).manual_seed(SEED)

    def randn(*shape):
        return torch.randn(shape, generator=g, device=dev)

    def attend(label, q, k, v, causal, n_terms):
        """One call against the plain version; bf16 must take the wgmma
        route and f32 the simt route, once each."""
        prec = "bf16" if q.dtype == torch.bfloat16 else "fp32"
        route = "wgmma" if prec == "bf16" else "simt"
        staging = fa.launch_plan(q.dtype, (q.shape, k.shape, v.shape),
                                 (q.stride(), k.stride(), v.stride()),
                                 (q.data_ptr(), k.data_ptr(), v.data_ptr()), causal=causal)[1]
        before = dict(fa.flash_attention.launches_by_route)
        got = synced(fa.flash_attention(q, k, v, causal=causal))
        taken = {r: n - before[r] for r, n in fa.flash_attention.launches_by_route.items()}
        check(taken == {"wgmma": int(route == "wgmma"), "simt": int(route == "simt")},
              f"flash_attention {label} [{prec}] took routes {taken}, want {route}")
        want = synced(fa.flash_attention_plain(q, k, v, causal=causal))
        check(got.dtype == q.dtype and got.shape == want.shape and got.stride() == q.stride(),
              f"flash_attention {label}: {got.dtype} {tuple(got.shape)} {got.stride()}")
        compare(f"flash_attention {label} ({route}{', ' + staging if staging else ''})", prec,
                got.float(), want.float(), n_terms)
        return staging

    for b, h, kvh, s, t, d, causal, label in FLASH_CASES:
        q32, k32, v32 = randn(b, h, s, d), randn(b, kvh, t, d), randn(b, kvh, t, d)
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v = (x.to(dtype) for x in (q32, k32, v32))
            attend(f"{label} {(b, h, kvh, s, t, d)}", q, k, v, causal, t * d)
    # the model's layout: views read through their strides, the output in q's
    for b, s, t, h, kvh, d, causal, label in VIEW_CASES:
        qm, km, vm = randn(b, s, h, d), randn(b, t, kvh, d), randn(b, t, kvh, d)
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v = (x.to(dtype).transpose(1, 2) for x in (qm, km, vm))
            staging = attend(f"(b, s, heads, hd) views {label} {(b, h, kvh, s, t, d)}",
                             q, k, v, causal, t * d)
            if dtype == torch.bfloat16:
                check(staging == ("threads" if (2 * d) % 16 else "tma"),
                      f"flash_attention views {label}: staging {staging}")

    for bh, c, n_l, p, n, rate, label in SSD_CASES:
        x, bm, cm = randn(bh, c, n_l, p), randn(bh, c, n_l, n), randn(bh, c, n_l, n)
        acs = torch.cumsum(-rate * randn(bh, c, n_l).abs(), dim=-1)
        for dtype in (torch.bfloat16, torch.float32):
            b_, c_ = bm.to(dtype), cm.to(dtype)
            y, st = synced(ssd_scan.ssd_chunk(x, acs, b_, c_))
            y_want, st_want = synced(ssd_scan.ssd_chunk_plain(x, acs, b_, c_))
            tag = f"ssd_chunk {label} {(bh, c, n_l, p, n)} B, C {str(dtype)[6:]}"
            compare(f"{tag} y", "fp32", y, y_want, n_l * n)
            compare(f"{tag} state", "fp32", st, st_want, n_l)


# -- phase 8: Zamba2 SMOKE, card against CPU -----------------------------------

# Card against CPU for the SMOKE model, as a fraction of max|CPU logit|.
# float32: both devices compute in f32 (no TF32), but the bf16 K/V cache,
#   conv states and inter-chunk SSD states are rounded from f32 values that
#   differ in their last bits between the devices, so a rounded entry can
#   land one bf16 ulp (2^-8 relative) away; on the CPU the port against the
#   JAX reference shows up to 1.7e-3 from that alone (3 chunks, 8 steps).
# bfloat16: every activation is rounded to bf16 after each op on both sides,
#   at places where the two devices' f32 sums differ; on the CPU the port
#   against the JAX reference differs by up to 5e-2 for that reason.
LM_TOL = {"float32": 5e-3, "bfloat16": 1e-1}
SMOKE_B, SMOKE_P, SMOKE_NEW = 3, 40, 8  # batch, prompt (two SSD chunks), new tokens


def tree_to(tree, dev):
    if isinstance(tree, dict):
        return {k: tree_to(v, dev) for k, v in tree.items()}
    return tree.to(dev)


def param_leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from param_leaves(v)
    else:
        yield tree


def greedy_agrees(got, want, ref_logits, tol: float, vocab: int, label: str) -> int:
    """``got`` and ``want`` (B, P + n) greedy tokens must agree up to a step
    where the reference's two best logits are within ``tol`` x max|logit|
    (a near tie, which either side may break); ``ref_logits[i]`` (B, V) are
    the logits that chose token i of ``want``. Returns the steps that
    agreed."""
    n = len(ref_logits)
    p = want.shape[1] - n
    for i in range(n):
        if np.array_equal(got[:, p + i], want[:, p + i]):
            continue
        lg = ref_logits[i][:, :vocab].float()
        top2 = torch.topk(lg, 2, dim=-1).values
        gap = float((top2[:, 0] - top2[:, 1]).min())
        limit = tol * float(lg.abs().max())
        log(f"  {label}: tokens differ at step {i}; the reference's smallest top-2 gap there "
            f"{gap:.3e}, limit {limit:.3e}")
        check(gap <= limit, f"{label}: greedy tokens differ at step {i} where the reference's "
              f"top-2 gap {gap:.3e} exceeds {limit:.3e}")
        return i
    return n


def teacher_forced(eng, tokens, p: int, n: int):
    """Prefill ``tokens[:, :p]``, then ``n - 1`` decode steps fed with
    ``tokens[:, p + i]``: the n logits that choose tokens p .. p + n - 1, and
    the prefill cache."""
    dev = eng.device
    t = torch.as_tensor(tokens, dtype=torch.long, device=dev)
    logits, cache = eng.prefill(eng.params, {"tokens": t[:, :p]})
    prefill_cache = cache
    cache = eng._pad_cache(cache, p)
    out = [logits]
    for i in range(n - 1):
        logits, cache = eng.decode(eng.params, cache, {"token": t[:, p + i:p + i + 1],
                                                       "pos": p + i})
        out.append(logits)
    return out, prefill_cache


def phase8_smoke_card_vs_cpu(dev) -> None:
    from repro_torch.configs import get_config
    from repro_torch.models.model import init_params
    from repro_torch.serve.engine import Engine, ServeConfig

    log(f"phase 8: zamba2-2.7b SMOKE, card against CPU from the same weights "
        f"(batch {SMOKE_B}, prompt {SMOKE_P}, {SMOKE_NEW} new tokens)")
    rng = np.random.default_rng(SEED)
    for dtype, tol in LM_TOL.items():
        cfg = dataclasses.replace(get_config("zamba2-2.7b", smoke=True), dtype=dtype)
        params = init_params(cfg, torch.Generator().manual_seed(SEED), "cpu")
        scfg = ServeConfig(max_seq_len=SMOKE_P + SMOKE_NEW, batch_size=SMOKE_B)
        eng = {"cpu": Engine(cfg, params, scfg, device="cpu"),
               "cuda": Engine(cfg, tree_to(params, dev), scfg, device=dev)}
        prompts = rng.integers(0, cfg.vocab_size, (SMOKE_B, SMOKE_P))
        # greedy tokens on each device, then both devices teacher-forced on
        # the CPU's tokens: prefill logits and every decode step's logits
        out = {d: e.generate(prompts, SMOKE_NEW) for d, e in eng.items()}
        reset_launches()
        logits = {}
        for d, e in eng.items():
            logits[d], cache = teacher_forced(e, out["cpu"], SMOKE_P, SMOKE_NEW)
            if d == "cuda":
                launches = {k: v for k, v in read_launches().items() if v}
                n_sb = cfg.n_layers // cfg.hybrid_period
                check(launches == {"flash_attention": n_sb, "ssd_chunk": cfg.n_layers},
                      f"SMOKE card prefill launches {launches}")
        torch.cuda.synchronize()
        for i, (a, b) in enumerate(zip(logits["cuda"], logits["cpu"])):
            a = a.float().cpu()
            b = b.float()
            err = float((a - b).abs().max())
            scale = float(b.abs().max())
            what = "prefill" if i == 0 else f"decode step {i}"
            log(f"  {dtype} {what}: max_abs_err {err:.3e} <= {tol * scale:.3e} "
                f"(tol {tol} x max|cpu logit| {scale:.3e})")
            check(bool(torch.isfinite(a).all()) and err <= tol * scale,
                  f"SMOKE {dtype} {what}: card and CPU logits disagree")
        agreed = greedy_agrees(out["cuda"], out["cpu"], logits["cpu"], tol, cfg.vocab_size,
                               f"SMOKE {dtype} greedy")
        log(f"  {dtype} greedy tokens: {agreed} of {SMOKE_NEW} steps equal")
        check(out["cuda"].shape == (SMOKE_B, SMOKE_P + SMOKE_NEW)
              and np.array_equal(out["cuda"][:, :SMOKE_P], prompts), "SMOKE generate shape")


# -- phase 9: the slice's path, Zamba2-2.7B served at full width ---------------

SERVE_B, SERVE_P, SERVE_NEW, SERVE_MAX = 4, 4096, 64, 4224
# The last-token prefill logits with the kernels against a prefill that runs
# the plain versions on the card: a guard against gross faults (wrong wiring,
# a lost chunk, NaN), not a check of rounding. The mixer rounds y_diag +
# y_inter to bf16 (models/mamba2.py), so one f32 ulp of kernel 7's outputs
# flips bf16 roundings, and random weights carry that chaotically through 54
# layers to a few % of max|logit| (PERF.md section 6: kernel 7 in f64 and
# correctly rounded moved them 5.21%, noise of 1e-7 on y 4.81%, one TF32
# pass 8.13%). So the limit is measured in the same run: the movement the
# f64 control (a prefill of the plain versions with the SSD chunk in f64)
# causes, times SERVE_LOGIT_MARGIN. A correctly rounded kernel 7 moves the
# logits as the f64 control does, and kernel 6 adds its own rounding beside
# it; 3x leaves room for both, while a gross fault moves the logits by the
# order of max|logit|. This guard alone does not separate the TF32 control
# from a correct kernel 7 (8.13% is within 3 x 5.21%): the per-layer fp32
# check of kernel 7 (``ssd_per_layer_gate``) does, and its TF32 control must
# fail it in every run.
SERVE_LOGIT_MARGIN = 3.0


def capture_inputs(fn) -> dict:
    """Run ``fn`` with ``ops.flash_attention`` and ``ops.ssd_chunk`` wrapped
    so that the arguments of each one's first call are kept (cloned, strides
    included): one layer's real inputs at the path's shapes."""
    from repro_torch.kernels import ops

    kept, orig = {}, {n: getattr(ops, n) for n in ("flash_attention", "ssd_chunk")}

    def keeper(name):
        def call(*args, **kwargs):
            kept.setdefault(name, ([a.clone() for a in args], dict(kwargs)))
            return orig[name](*args, **kwargs)
        return call

    try:
        for n in orig:
            setattr(ops, n, keeper(n))
        fn()
    finally:
        for n, f in orig.items():
            setattr(ops, n, f)
    return kept


def with_plain_kernels(fn, ssd=None):
    """``fn()`` with the model's two LM kernel calls sent to their plain
    versions (the reference prefill on the card); ``ssd`` replaces the plain
    SSD chunk when given."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops, ssd_scan

    orig = ops.flash_attention, ops.ssd_chunk
    ops.flash_attention, ops.ssd_chunk = fa.flash_attention_plain, ssd or ssd_scan.ssd_chunk_plain
    try:
        return fn()
    finally:
        ops.flash_attention, ops.ssd_chunk = orig


def serving_setup(dev):
    """Zamba2-2.7B as registered, weights from the seed on the card, its
    serving engine and the seeded prompts; and the seconds the weights took."""
    from repro_torch.configs import get_config
    from repro_torch.models.model import init_params
    from repro_torch.serve.engine import Engine, ServeConfig

    cfg = get_config("zamba2-2.7b")
    t0 = time.perf_counter()
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(SEED), dev)
    torch.cuda.synchronize()
    t_init = time.perf_counter() - t0
    eng = Engine(cfg, params, ServeConfig(max_seq_len=SERVE_MAX, batch_size=SERVE_B), device=dev)
    prompts = np.random.default_rng(SEED).integers(0, cfg.vocab_size, (SERVE_B, SERVE_P))
    return cfg, params, eng, prompts, t_init


def ssd_chunk_f64(x, a, b, c):
    """Kernel 7's function in f64 on the card, rounded to f32: the function
    correctly rounded, the control that the fp32 rule must pass."""
    x, a, bm, cm = (t.double() for t in (x, a, b, c))
    causal = torch.ones((x.shape[2], x.shape[2]), dtype=torch.bool, device=x.device).tril()
    decay = torch.where(causal, torch.exp(a[..., :, None] - a[..., None, :]), 0.0)
    y = ((cm @ bm.transpose(-1, -2)) * decay) @ x
    st = (bm * torch.exp(a[..., -1:] - a)[..., None]).transpose(-1, -2) @ x
    return y.float(), st.float()


def ssd_chunk_tf32(x, a, b, c):
    """``ssd_chunk_plain`` with its f32 products on one TF32 pass (cuBLAS
    with TF32 allowed): the control that the fp32 rule must fail."""
    from repro_torch.kernels import ssd_scan

    allowed = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        return ssd_scan.ssd_chunk_plain(x, a, b, c)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = allowed


def ssd_rule(got, want, n_l: int, n_state: int) -> dict:
    """Kernel 7's outputs (y, state) against the plain version's at the fp32
    rule, n = L N terms for y and L for the state: each one's error over
    its limit, and whether both are within."""
    out = {}
    for what, g, w, n_terms in (("y", got[0], want[0], n_l * n_state),
                                ("state", got[1], want[1], n_l)):
        err, limit, _, _, ok = against_plain(g, w, "fp32", n_terms)
        out[what] = {"max_abs_err": err, "limit": limit, "over_limit": err / limit, "ok": ok}
    out["ok"] = out["y"]["ok"] and out["state"]["ok"]
    return out


def ssd_per_layer_gate(fn, n_calls: int):
    """Run ``fn`` (a prefill that runs the kernels) with ``ops.ssd_chunk``
    wrapped: each call launches kernel 7, runs ``ssd_chunk_plain`` on the
    same inputs, holds y and the state to the fp32 rule (``ssd_rule``) and
    passes the kernel's own outputs on, so that each layer is judged on the
    inputs it really receives and nothing is kept beyond the call. Fails at
    the first call outside the rule or if there were not ``n_calls`` calls;
    returns the worst call and ``fn``'s result."""
    from repro_torch.kernels import ops, ssd_scan

    orig, worst, calls = ops.ssd_chunk, {"over_limit": -1.0}, [0]

    def gated(x, a, b, c):
        got = orig(x, a, b, c)
        layer = calls[0]
        calls[0] += 1
        r = ssd_rule(got, ssd_scan.ssd_chunk_plain(x, a, b, c), x.shape[2], b.shape[3])
        check(r["ok"], f"kernel 7 at layer {layer} is outside the fp32 rule: {json.dumps(r)}")
        for what in ("y", "state"):
            if r[what]["over_limit"] > worst["over_limit"]:
                worst.update(r[what], layer=layer, output=what)
        return got

    ops.ssd_chunk = gated
    try:
        out = fn()
    finally:
        ops.ssd_chunk = orig
    check(calls[0] == n_calls, f"the gated prefill made {calls[0]} SSD chunk calls, want {n_calls}")
    worst.pop("ok")
    return dict(worst, calls=calls[0]), out


def phase9_zamba2(dev, card: str):
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ssd_scan

    cfg, params, eng, prompts, t_init = serving_setup(dev)
    n_sb = cfg.n_layers // cfg.hybrid_period
    log(f"phase 9: {cfg.name} as registered ({cfg.n_layers} Mamba-2 layers, d {cfg.d_model}, "
        f"{n_sb} shared-attention calls), batch {SERVE_B}, prompts of {SERVE_P}, "
        f"{SERVE_NEW} new tokens, max_seq_len {SERVE_MAX}")
    n_params = sum(t.numel() for t in param_leaves(params))

    # the main path: every count starts at 0 here and is read right after.
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t0 = time.perf_counter()
    out = eng.generate(prompts, SERVE_NEW)
    torch.cuda.synchronize()
    t_gen = time.perf_counter() - t0
    launches = read_launches()
    fa_routes = dict(fa.flash_attention.launches_by_route)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    log(f"  generate (cold): {t_gen:.3f} s, launches {launches}, flash_attention routes "
        f"{fa_routes}, peak {peak_gb:.2f} GB, {n_params / 1e9:.3f} B parameters "
        f"(init {t_init:.2f} s)")
    check(launches == {"fused_kron_scatter": 0, "ttm": 0, "kron_contrib": 0, "scatter_rows": 0,
                       "fused_kron_scatter_ttm": 0, "flash_attention": n_sb,
                       "ssd_chunk": cfg.n_layers},
          f"serving launches {launches}, want {n_sb} and {cfg.n_layers} (one prefill)")
    check(fa_routes == {"wgmma": n_sb, "simt": 0},
          f"prefill attention routes {fa_routes}, want all {n_sb} on the tensor-core kernel")
    check(out.shape == (SERVE_B, SERVE_P + SERVE_NEW) and np.array_equal(out[:, :SERVE_P], prompts)
          and bool(((out >= 0) & (out < cfg.vocab_size)).all()), f"generate output {out.shape}")

    # warm timings: prefill and decode steps by CUDA events, generate by the
    # host clock; device busy time of one prefill and of 8 decode steps by the
    # profiler, over the same work's time without the profiler
    tokens = torch.as_tensor(prompts, dtype=torch.long, device=dev)
    prefill_ms = time_ms(lambda: eng.prefill(params, {"tokens": tokens}), reps=3)
    logits, cache = eng.prefill(params, {"tokens": tokens})
    check(bool(torch.isfinite(logits.float()).all()), "non-finite prefill logits")
    step = {"cache": eng._pad_cache(cache, SERVE_P), "token": eng._sample(logits)[:, None],
            "pos": SERVE_P}
    del cache

    def decode_steps(n):
        for _ in range(n):
            lg, step["cache"] = eng.decode(params, step["cache"],
                                           {"token": step["token"], "pos": step["pos"]})
            step["token"] = eng._sample(lg)[:, None]
            step["pos"] += 1
        return lg

    n_steps = 16
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    step_logits = decode_steps(n_steps)
    end.record()
    end.synchronize()
    decode_ms = start.elapsed_time(end) / n_steps
    check(bool(torch.isfinite(step_logits.float()).all()), "non-finite decode logits")
    prof_decode = profile_run(lambda: decode_steps(8))
    del step, step_logits
    prof_prefill = profile_run(lambda: eng.prefill(params, {"tokens": tokens}))
    t0 = time.perf_counter()
    eng.generate(prompts, SERVE_NEW)
    torch.cuda.synchronize()
    t_gen_warm = time.perf_counter() - t0
    busy = {"prefill": prof_prefill["device_busy_ms"] / prefill_ms,
            "decode": prof_decode["device_busy_ms"] / (8 * decode_ms),
            "generate": (prof_prefill["device_busy_ms"] + (SERVE_NEW - 1)
                         * prof_decode["device_busy_ms"] / 8) / (t_gen_warm * 1e3)}
    log(f"  warm: prefill {prefill_ms:.1f} ms, decode {decode_ms:.2f} ms per step, generate "
        f"{t_gen_warm:.3f} s ({SERVE_B * SERVE_NEW / t_gen_warm:.1f} generated tokens/s); "
        f"device busy share " + ", ".join(f"{k} {v:.3f}" for k, v in busy.items()))

    # each kernel on one layer's real inputs at the path's shapes
    kept = capture_inputs(lambda: eng.prefill(params, {"tokens": tokens}))
    (q, k, v), kw = kept["flash_attention"]
    fa_kern = partial(fa.flash_attention, q, k, v, **kw)
    fa_plain = partial(fa.flash_attention_plain, q, k, v, **kw)
    fa_err = compare(f"flash_attention Zamba2 layer 0 q {tuple(q.shape)} {q.dtype}", "bf16",
                     synced(fa_kern()).float(), synced(fa_plain()).float(), q.shape[2] * q.shape[3])
    b_, h_, s_, d_ = q.shape
    t_ = k.shape[2]
    fa_flops = 4 * b_ * h_ * d_ * sum(min(t_, i + 1 + t_ - s_) for i in range(s_))
    fa_bytes = nbytes_of(q, k, v, q)
    # the CUDA-core kernel on f32 operands at the same shape (its earlier
    # time on this path, when it served bf16 too)
    qf, kf, vf = q.float(), k.float(), v.float()
    simt_ms = time_ms(partial(fa.flash_attention, qf, kf, vf, **kw), reps=3)
    del qf, kf, vf
    fa_row = {"ms": time_ms(fa_kern), "plain_ms": time_ms(fa_plain, reps=3),
              "library_ms": time_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
                  q, k, v, is_causal=True)),
              "bound_ms": max(fa_bytes / PEAK_BYTES_PER_S, fa_flops / PEAK_BF16_FLOPS) * 1e3,
              "bound_by": ("bytes" if fa_bytes / PEAK_BYTES_PER_S >= fa_flops / PEAK_BF16_FLOPS
                           else "operations"),
              # p @ v twice (p_hi, p_lo): 1.5x the minimum tensor-core work
              "bound_split_ms": max(fa_bytes / PEAK_BYTES_PER_S,
                                    1.5 * fa_flops / PEAK_BF16_FLOPS) * 1e3,
              "f32_core_bound_ms": fa_flops / PEAK_F32_FLOPS * 1e3,
              "simt_f32_ms": simt_ms,
              "flops": fa_flops, "bytes": fa_bytes, "max_abs_err": fa_err}
    log(f"    flash_attention: {json.dumps(fa_row)}")
    (x, acs, bm, cm), _ = kept["ssd_chunk"]
    del kept
    ssd_kern = partial(ssd_scan.ssd_chunk, x, acs, bm, cm)
    ssd_plain = partial(ssd_scan.ssd_chunk_plain, x, acs, bm, cm)
    bh_, c_, l_, p_ = x.shape
    n_ = bm.shape[-1]
    # kernel 7 on every call of a warm prefill, each on its layer's inputs
    per_layer, gated_logits = ssd_per_layer_gate(
        lambda: eng.prefill(params, {"tokens": tokens})[0], cfg.n_layers)
    log(f"  ssd_chunk on all {per_layer['calls']} calls of a warm prefill, fp32 rule "
        f"(y: {l_ * n_} terms, state: {l_}): worst at layer {per_layer['layer']} "
        f"{per_layer['output']}, max_abs_err {per_layer['max_abs_err']:.3e} <= "
        f"{per_layer['limit']:.3e} ({per_layer['over_limit']:.4f} of the limit); the gated "
        f"prefill's logits equal the kernels' prefill's: {torch.equal(gated_logits, logits)}")
    del gated_logits
    # the rule's controls on layer 0's inputs: the correctly rounded function
    # must pass it and one TF32 pass must fail it, or it cannot judge kernel 7
    want = synced(ssd_plain())
    controls = {}
    for name, ctrl, must_pass in (("f64", ssd_chunk_f64, True),
                                  ("one TF32 pass", ssd_chunk_tf32, False)):
        r = ssd_rule(synced(ctrl(x, acs, bm, cm)), want, l_, n_)
        controls[name] = {k: r[k]["over_limit"] for k in ("y", "state")}
        log(f"  ssd_chunk control on layer 0, {name}: y {r['y']['max_abs_err']:.3e} and state "
            f"{r['state']['max_abs_err']:.3e}, {controls[name]['y']:.4g} and "
            f"{controls[name]['state']:.4g} of their limits: "
            f"{'passes' if r['ok'] else 'fails'} the fp32 rule (must "
            f"{'pass' if must_pass else 'fail'})")
        check(r["ok"] == must_pass, f"the {name} control {'fails' if must_pass else 'passes'} "
              f"the fp32 rule on layer 0: the rule cannot judge kernel 7")
    y, st = synced(ssd_kern())
    ssd_err = max(compare(f"ssd_chunk Zamba2 layer 0 y {tuple(x.shape)}", "fp32", y, want[0],
                          l_ * n_),
                  compare(f"ssd_chunk Zamba2 layer 0 state {tuple(st.shape)}", "fp32", st,
                          want[1], l_))
    del y, st, want
    # the guard against gross faults: last-token logits against a prefill
    # with the plain versions on the card, within SERVE_LOGIT_MARGIN x the
    # f64 control's movement of them (see SERVE_LOGIT_MARGIN)
    got = logits.float()
    want = with_plain_kernels(lambda: eng.prefill(params, {"tokens": tokens})[0]).float()
    f64_moved = float((with_plain_kernels(lambda: eng.prefill(params, {"tokens": tokens})[0],
                                          ssd_chunk_f64).float() - want).abs().max())
    scale = float(want.abs().max())
    logit_err = float((got - want).abs().max())
    logit_limit = SERVE_LOGIT_MARGIN * f64_moved
    same_top = float((got.argmax(-1) == want.argmax(-1)).float().mean())
    log(f"  last-token logits, kernels against plain versions: max_abs_err {logit_err:.3e} "
        f"({logit_err / scale:.4f} of max|plain| {scale:.3e}) <= {logit_limit:.3e} "
        f"({SERVE_LOGIT_MARGIN} x the f64 control's {f64_moved:.3e}, {f64_moved / scale:.4f} "
        f"of max|plain|); argmax equal in {same_top:.2f} of rows")
    check(bool(torch.isfinite(got).all()) and logit_err <= logit_limit,
          "prefill logits with the kernels are further from the plain versions' than the "
          "guard allows")
    del logits, got, want
    # the least time: the bytes once, or C B^T (bf16 operands) at the bf16
    # rate and the 3xTF32 products as three TF32 products each; the f32
    # CUDA-core reckoning of the earlier kernel beside it
    tri = bh_ * c_ * l_ * (l_ + 1) // 2
    score_flops, y_flops, st_flops = tri * 2 * n_, tri * 2 * p_, bh_ * c_ * 2 * l_ * n_ * p_
    ssd_flops = score_flops + y_flops + st_flops
    ssd_bytes = nbytes_of(x, acs, bm, cm, x) + bh_ * c_ * n_ * p_ * 4
    t_bytes = ssd_bytes / PEAK_BYTES_PER_S
    t_ops = score_flops / PEAK_BF16_FLOPS + 3 * (y_flops + st_flops) / PEAK_TF32_FLOPS
    ssd_bound, ssd_bound_by = max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                                          else "operations")
    # the same call with B and C widened to f32 (all three products 3xTF32)
    bmf, cmf = bm.float(), cm.float()
    y32, st32 = synced(ssd_scan.ssd_chunk(x, acs, bmf, cmf))
    y_want, st_want = synced(ssd_scan.ssd_chunk_plain(x, acs, bmf, cmf))
    ssd_err = max(ssd_err, compare(f"ssd_chunk Zamba2 layer 0 y, B and C widened to f32",
                                   "fp32", y32, y_want, l_ * n_),
                  compare(f"ssd_chunk Zamba2 layer 0 state, B and C widened to f32", "fp32",
                          st32, st_want, l_))
    del y32, st32, y_want, st_want
    f32_bytes = nbytes_of(x, acs, bmf, cmf, x) + bh_ * c_ * n_ * p_ * 4
    ssd_row = {"ms": time_ms(ssd_kern), "plain_ms": time_ms(ssd_plain, reps=3),
               "bound_ms": ssd_bound, "bound_by": ssd_bound_by,
               "f32_core_bound_ms": bound(ssd_bytes, ssd_flops)[0],
               "b_c_dtype": str(bm.dtype), "per_layer": per_layer, "controls": controls,
               "f32_b_c_ms": time_ms(partial(ssd_scan.ssd_chunk, x, acs, bmf, cmf)),
               "f32_b_c_bound_ms": bound(f32_bytes, 3 * ssd_flops, PEAK_TF32_FLOPS)[0],
               "flops": ssd_flops, "bytes": ssd_bytes, "max_abs_err": ssd_err}
    del bmf, cmf
    log(f"    ssd_chunk: {json.dumps(ssd_row)}")

    kms = prof_prefill["kernel_ms"]
    summary = {
        "phase": "9 Zamba2-2.7B serving", "card": card, "config": cfg.name,
        "params": n_params, "batch": SERVE_B, "prompt": SERVE_P, "new_tokens": SERVE_NEW,
        "max_seq_len": SERVE_MAX,
        "setup_s": {"init_params_on_card": t_init, "cold_generate": t_gen},
        "prefill_ms": prefill_ms, "decode_ms_per_step": decode_ms,
        "generate_s": t_gen_warm, "generated_tokens_per_s": SERVE_B * SERVE_NEW / t_gen_warm,
        "decode_tokens_per_s": SERVE_B * 1e3 / decode_ms,
        "launches_per_generate": {k: v for k, v in launches.items() if v},
        "peak_memory_gb": peak_gb,
        "last_logit_max_abs_err_vs_plain": logit_err, "last_logit_scale": scale,
        "last_logit_limit": logit_limit, "last_logit_f64_control_moved": f64_moved,
        "flash_attention": fa_row, "ssd_chunk": ssd_row,
        "device_busy_share": busy, "profile_prefill": prof_prefill,
        "profile_8_decode_steps": prof_decode,
    }
    print(json.dumps(summary), flush=True)
    return {
        "flash_attention": {
            "name": "flash_attention", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/flash_attention_wgmma.cu",
            "replaces": "src/repro/kernels/flash_attention.py:78",
            "launches": launches["flash_attention"], "max_abs_err": fa_err, "ms": fa_row["ms"],
            "plain_ms": fa_row["plain_ms"], "device_ms": kms["flash_attention"] / n_sb,
            "bound_ms": fa_row["bound_ms"], "bound_by": fa_row["bound_by"],
            "bound_split_ms": fa_row["bound_split_ms"], "simt_f32_ms": fa_row["simt_f32_ms"],
            "library_ms": fa_row["library_ms"]},
        "ssd_chunk": {
            "name": "ssd_chunk", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/ssd_chunk.cu",
            "replaces": "src/repro/kernels/ssd_scan.py:48",
            "launches": launches["ssd_chunk"], "max_abs_err": ssd_err, "ms": ssd_row["ms"],
            "plain_ms": ssd_row["plain_ms"], "device_ms": kms["ssd_chunk"] / cfg.n_layers,
            "bound_ms": ssd_row["bound_ms"], "bound_by": ssd_row["bound_by"],
            "f32_core_bound_ms": ssd_row["f32_core_bound_ms"],
            "b_c_dtype": ssd_row["b_c_dtype"], "f32_b_c_ms": ssd_row["f32_b_c_ms"],
            "f32_b_c_bound_ms": ssd_row["f32_b_c_bound_ms"],
            # no single PyTorch call builds the masked decay and both products
            "library_ms": None},
    }


# -- phase 12: the Tucker decomposition service ------------------------------------

# (name, shape, ranks, method, sweeps, requests, nnz range) of each tenant:
# the NELL-2 portion of Table V, Amazon's shape of Table V, and a 4-way
# tensor (kernels 3 and 4); uniform coordinates, values uniform in [0.1, 10)
SERVICE_TENANTS = (
    ("A", (1000, 1000, 1000), (16, 16, 16), "householder", 5, 64, (12_000, 36_000)),
    ("B", (20000, 20000, 20000), (32, 32, 32), "gram", 2, 32, (600, 1_200)),
    ("C", (200, 200, 200, 20), (8, 8, 8, 8), "gram", 3, 16, (20_000, 80_000)),
)
SERVICE_MAX_BATCH = 16
SERVICE_THREADS = 4


def projector_gap(u, v, rows: int = 2048) -> float:
    """max |U U^T - V V^T| over row blocks, never the whole (I, I) at once."""
    gap = 0.0
    for s in range(0, u.shape[0], rows):
        gap = max(gap, float((u[s:s + rows] @ u.T - v[s:s + rows] @ v.T).abs().max()))
    return gap


def core_gap(got, want):
    """(max |core difference|, max |want's core|) once ``got``'s factor
    columns are matched to ``want``'s by sign."""
    core = got.core
    for n, (a, b) in enumerate(zip(got.factors, want.factors)):
        sign = torch.sign((a * b).sum(0))
        core = core * sign.reshape([-1 if t == n else 1 for t in range(core.dim())])
    return float((core - want.core).abs().max()), float(want.core.abs().max())


def single_run_launches(order: int) -> dict:
    """Launches of one per-tensor sweep of an ``order``-way tensor: kernel 1
    a mode, or two kron_contrib links and one scatter_rows a mode above
    order 3; kernel 2 once."""
    if order <= 3:
        return {"fused_kron_scatter": order, "ttm": 1}
    return {"kron_contrib": 2 * order, "scatter_rows": order, "ttm": 1}


def stacked_kernel_checks(name, stacked, fs, k: int, shape) -> dict:
    """Kernels 1-4 at one flush's stacked shapes against their plain
    versions (fp32 rule), from the flush's final factors: kernel 1 on every
    mode (or the kernel 3 + 4 chain for the 4-way tenant) over the stack,
    kernel 2 on each member's row views of the last unfolding, as the
    batched sweeps call it. Times and bounds as phases 4, 6 and 10."""
    from repro_torch.core.engine import make_engine
    from repro_torch.kernels import kron_kernel, ops, ttm_kernel
    from repro_torch.sparse.layout import slot_rows

    eng = make_engine("cuda", stacked.device)
    n = stacked.ndim
    out = {}
    if n <= 3:
        rows3 = table5_kernels(f"{name} stacked", stacked, eng, fs)
        out["fused_kron_scatter"] = rows3["fused_kron_scatter"]
        out["ttm_whole_stack"] = rows3["ttm"]
        y_last = kron_kernel.fused_kron_scatter(*kron_factors(fs, n - 1),
                                                eng.device_schedule(stacked, n - 1),
                                                stacked.shape[n - 1])
    else:
        tot = {nm: {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0, "bound_ms": 0.0,
                    "max_abs_err": 0.0, "bytes": 0, "flops": 0}
               for nm in ("kron_contrib", "scatter_rows")}
        for mode in range(n):
            sched = eng.device_schedule(stacked, mode)
            n_rows = stacked.shape[mode]
            rows, v = ops._gathered_block_rows(stacked.indices, stacked.values, fs, mode,
                                               sched, n)
            ones = torch.ones_like(v)
            c1 = synced(kron_kernel.kron_contrib(rows[0], rows[1], v))
            e1 = compare(f"kron_contrib {name} stacked mode {mode} link 1", "fp32", c1,
                         synced(kron_kernel.kron_contrib_plain(rows[0], rows[1], v)), 1)
            c2 = synced(kron_kernel.kron_contrib(c1, rows[2], ones))
            e2 = compare(f"kron_contrib {name} stacked mode {mode} link 2", "fp32", c2,
                         synced(kron_kernel.kron_contrib_plain(c1, rows[2], ones)), 1)
            y = synced(kron_kernel.scatter_rows(c2, sched, n_rows))
            terms = max_row_count(stacked, mode)
            es = compare(f"scatter_rows {name} stacked mode {mode}", "fp32", y,
                         synced(kron_kernel.scatter_rows_plain(c2, sched, n_rows)), terms)
            compare(f"Y_({mode}) {name} stacked, kernels against the plain chain", "fp32", y,
                    synced(chain_plain(rows, v, sched, n_rows, "fp32")), terms)
            kk = c2.shape[1]
            slots = slot_rows(sched)
            # one PyTorch call each for the same functions (as phase 6):
            # torch.einsum for both links, index_add_ for the scatter
            c_lib = (time_ms(lambda: torch.einsum("ti,tj->tij", rows[0] * v[:, None], rows[1]))
                     + time_ms(lambda: torch.einsum("ti,tj->tij", c1 * ones[:, None], rows[2])))
            s_lib = time_ms(lambda: torch.zeros((n_rows, kk), device=c2.device)
                            .index_add_(0, slots, c2))
            for nm, ms, pl, lib, nb, fl, err in (
                    ("kron_contrib",
                     time_ms(partial(kron_kernel.kron_contrib, rows[0], rows[1], v))
                     + time_ms(partial(kron_kernel.kron_contrib, c1, rows[2], ones)),
                     time_ms(partial(kron_kernel.kron_contrib_plain, rows[0], rows[1], v))
                     + time_ms(partial(kron_kernel.kron_contrib_plain, c1, rows[2], ones)),
                     c_lib,
                     nbytes_of(rows[0], rows[1], v, c1, c1, rows[2], ones) + c2.numel() * 4,
                     2 * v.shape[0] * c1.shape[1] + 2 * v.shape[0] * kk, max(e1, e2)),
                    ("scatter_rows", time_ms(partial(kron_kernel.scatter_rows, c2, sched, n_rows)),
                     time_ms(partial(kron_kernel.scatter_rows_plain, c2, sched, n_rows)),
                     s_lib,
                     nbytes_of(c2, sched.rel_row, sched.blkmap, sched.parts) + n_rows * kk * 4,
                     int(stacked.nnz) * kk, es)):
                t = tot[nm]
                t["ms"] += ms
                t["plain_ms"] += pl
                t["library_ms"] += lib
                t["bound_ms"] += bound(nb, fl)[0]
                t["bytes"] += nb
                t["flops"] += fl
                t["max_abs_err"] = max(t["max_abs_err"], err)
            if mode == n - 1:
                y_last = y
            del c1, c2, rows, v, ones
        for nm, t in tot.items():
            t["bound_by"] = bound(t["bytes"], t["flops"])[1]
            out[nm] = t
    # kernel 2 as the batched sweeps call it: on member i's rows of Y_(N)
    # and U_N, transposed views (no copy)
    rows_n = shape[n - 1]
    err = 0.0
    for i in range(k):
        yv, uv = y_last[i * rows_n:(i + 1) * rows_n].T, fs[n - 1][i * rows_n:(i + 1) * rows_n].T
        err = max(err, compare(f"ttm {name} member {i} view y {tuple(yv.shape)} u "
                               f"{tuple(uv.shape)}", "fp32", check_ttm_call(name, yv, uv, "fp32"),
                               synced(ttm_kernel.ttm_plain(yv, uv)), rows_n))
    yv, uv = y_last[:rows_n].T, fs[n - 1][:rows_n].T
    l_, i_ = yv.shape
    nb, fl = (l_ * i_ + uv.shape[0] * i_) * 4 + l_ * uv.shape[0] * 4, 2 * l_ * i_ * uv.shape[0]
    out["ttm"] = {"ms": time_ms(partial(ttm_kernel.ttm, yv, uv), reps=20, flush_l2=True),
                  "plain_ms": time_ms(partial(ttm_kernel.ttm_plain, yv, uv), reps=20,
                                      flush_l2=True),
                  "library_ms": time_ms(partial(torch.matmul, yv, uv.T), reps=20, flush_l2=True),
                  "bound_ms": bound(nb, fl)[0], "bound_by": bound(nb, fl)[1],
                  "max_abs_err": err, "shape": [l_, i_, uv.shape[0]], "calls_per_sweep": k}
    return out


def phase12_service(dev, card: str) -> None:
    import threading

    import repro_torch.obs as obs
    from repro_torch import tucker
    from repro_torch.core.coo import SparseCOO
    from repro_torch.serve import ServiceConfig, TuckerService
    from repro_torch.sparse.layout import stack_coo_batch

    tf32_off()
    release_memory()
    log(f"phase 12: TuckerService(max_batch {SERVICE_MAX_BATCH}, max_wait_ms 5, 2 executors), "
        f"{SERVICE_THREADS} submitting threads, tenants "
        + "; ".join(f"{t[0]} {t[5]} x {t[1]} ranks {t[2]} {t[3]} {t[4]} sweeps nnz {t[6]}"
                    for t in SERVICE_TENANTS))
    specs = [tucker.TuckerSpec(shape, ranks, method=method, n_iter=sweeps)
             for _, shape, ranks, method, sweeps, _, _ in SERVICE_TENANTS]
    t0 = time.perf_counter()
    reqs = []  # (tenant, coo, generator seed), tenant by tenant
    for t, (_, shape, _, _, _, n_req, (lo, hi)) in enumerate(SERVICE_TENANTS):
        rng = np.random.default_rng(1200 + t)
        for i in range(n_req):
            seed = 12_000 + 1000 * t + i
            idx, vals = synthetic(dev, shape, int(rng.integers(lo, hi + 1)), seed, "uniform")
            reqs.append((t, SparseCOO.from_parts(idx, vals, shape), seed))
    torch.cuda.synchronize()
    t_gen = time.perf_counter() - t0

    def gen(seed):
        return torch.Generator().manual_seed(seed)

    # the sequential loop: each request served alone, per-tensor, one after
    # another (each call ends in its history's read); the reference results
    seq, seq_s = [], [0.0] * len(SERVICE_TENANTS)
    for t, coo, seed in reqs:
        plan = tucker.plan(specs[t], device=dev)
        t0 = time.perf_counter()
        seq.append(plan(coo, generator=gen(seed)))
        seq_s[t] += time.perf_counter() - t0
    for (t, coo, _), res in zip(reqs, seq):
        want = sum(single_run_launches(coo.ndim).values()) * specs[t].n_iter
        check(res.launches == want and res.n_sweeps == specs[t].n_iter,
              f"tenant {SERVICE_TENANTS[t][0]} per-tensor run: {res.launches} launches, "
              f"{res.n_sweeps} sweeps; want {want}, {specs[t].n_iter}")

    # the service: every count starts at 0 here and is read right after
    groups = []  # runs of 16 requests of one tenant, handed to the threads in turn
    for t in range(len(SERVICE_TENANTS)):
        mine = [i for i, r in enumerate(reqs) if r[0] == t]
        groups += [mine[s:s + SERVICE_MAX_BATCH] for s in range(0, len(mine), SERVICE_MAX_BATCH)]
    per_thread = [[i for g in groups[th::SERVICE_THREADS] for i in g]
                  for th in range(SERVICE_THREADS)]
    tickets, sub_t, errors = [None] * len(reqs), [0.0] * len(reqs), []
    obs.tracer.clear()
    obs.configure(enabled=True)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    resident = torch.cuda.memory_allocated()
    reset_launches()
    svc = TuckerService(ServiceConfig(max_batch=SERVICE_MAX_BATCH, max_wait_ms=5.0,
                                      max_inflight_flushes=2))
    barrier = threading.Barrier(SERVICE_THREADS + 1)

    def submitter(th):
        barrier.wait(60)
        try:
            for i in per_thread[th]:
                t, coo, seed = reqs[i]
                sub_t[i] = time.perf_counter()
                tickets[i] = svc.submit_coo(coo, specs[t], generator=gen(seed))
        except Exception as exc:  # reported below: the phase fails
            errors.append(exc)

    threads = [threading.Thread(target=submitter, args=(th,)) for th in range(SERVICE_THREADS)]
    for th in threads:
        th.start()
    barrier.wait(60)
    t0 = time.perf_counter()
    for th in threads:
        th.join(600)
    try:
        check(not errors and not any(th.is_alive() for th in threads),
              f"submitting threads failed: {errors}")
        failed = [(i, tk.exception(timeout=600)) for i, tk in enumerate(tickets)]
        failed = [(i, e) for i, e in failed if e is not None]
        check(not failed, f"{len(failed)} tickets failed, the first: {failed[:1]}")
        results = [tk.result() for tk in tickets]
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        svc.close()
        obs.configure(enabled=False)
    launches = read_launches()
    peak = torch.cuda.max_memory_allocated()
    spans = [e for e in obs.tracer.events()
             if e.name == "sweep.dispatch" and e.attrs.get("program") == "batched"]
    snap = svc.metrics.snapshot()
    log(f"  service: {len(reqs)} requests in {wall:.3f} s, launches {launches}, "
        f"{len(spans)} batched dispatch spans, metrics dispatches {snap['dispatches']}")

    # every kernel of the path ran, and the flushes' own counts add up to them
    path_kernels = ("fused_kron_scatter", "kron_contrib", "scatter_rows", "ttm")
    for name in path_kernels:
        check(launches[name] > 0, f"phase 12 launched {name} no time")
    check(launches["fused_kron_scatter_ttm"] == 0 and not any(launches[k] for k in NO_LM_LAUNCHES),
          f"phase 12 launched kernels off its path: {launches}")
    from_spans = {name: sum(e.attrs["launches"].get(name, 0) for e in spans)
                  for name in path_kernels}
    check(from_spans == {k: launches[k] for k in path_kernels},
          f"the flushes' launches {from_spans} do not add up to the run's {launches}")

    tenants = []
    for t, (name, shape, ranks, method, sweeps, n_req, _) in enumerate(SERVICE_TENANTS):
        ids = [i for i, r in enumerate(reqs) if r[0] == t]
        res_t = [results[i] for i in ids]
        dispatches = sum(r.dispatches for r in res_t)
        t_spans = [e for e in spans if tuple(e.attrs["shape"]) == tuple(shape)]
        check(dispatches <= -(-n_req // SERVICE_MAX_BATCH),
              f"tenant {name}: {dispatches} dispatches for {n_req} requests")
        check(len(t_spans) >= dispatches >= 1,
              f"tenant {name}: {len(t_spans)} dispatch spans for {dispatches} flushes")
        per_flush = []
        for e in t_spans:
            k, s_run = e.attrs["batch"], e.attrs["sweeps_run"]
            want = {kk: v * s_run for kk, v in single_run_launches(len(shape)).items()}
            want["ttm"] = k * s_run
            check(e.attrs["launches"] == want,
                  f"tenant {name} flush of {k}: launches {e.attrs['launches']}, want {want}")
            per_flush.append({"batch": k, "sweeps": s_run, "launches": e.attrs["launches"],
                              "ms": e.duration_ms})
        fit_gap = proj = core = core_scale = 0.0
        for i in ids:
            got, want = results[i], seq[i]
            check(got.n_sweeps == want.n_sweeps == sweeps,
                  f"tenant {name} request {i}: {got.n_sweeps} sweeps, alone {want.n_sweeps}")
            check(bool(np.all(np.isfinite(got.fit_history))), f"request {i}: {got.fit_history}")
            fit_gap = max(fit_gap, float(np.abs(got.fit_history - want.fit_history).max()))
            proj = max(proj, max(projector_gap(a, b) for a, b in zip(got.factors, want.factors)))
            gap, scale = core_gap(got, want)
            check(gap <= 1e-3 * scale, f"tenant {name} request {i}: core gap {gap} > 1e-3 x "
                                       f"{scale}")
            core, core_scale = max(core, gap / scale), max(core_scale, scale)
        check(fit_gap <= 1e-4, f"tenant {name}: fit history gap {fit_gap} > 1e-4")
        check(proj <= 1e-3, f"tenant {name}: projector gap {proj} > 1e-3")
        lat = np.asarray([r.timing.total_ms for r in res_t])
        span_s = max(sub_t[i] + results[i].timing.total_ms / 1e3 for i in ids) - min(
            sub_t[i] for i in ids)
        row = {"tenant": name, "shape": shape, "ranks": specs[t].ranks, "method": method,
               "sweeps": sweeps, "requests": n_req,
               "nnz": [min(reqs[i][1].nnz for i in ids), max(reqs[i][1].nnz for i in ids)],
               "dispatches": dispatches, "flushes": per_flush,
               "requests_per_s": n_req / span_s, "p50_ms": float(np.percentile(lat, 50)),
               "p99_ms": float(np.percentile(lat, 99)),
               "sequential_requests_per_s": n_req / seq_s[t],
               "sequential_ms_per_request": seq_s[t] * 1e3 / n_req,
               "ratio_to_sequential": (n_req / span_s) / (n_req / seq_s[t]),
               "fit_gap": fit_gap, "projector_gap": proj, "core_gap_over_scale": core}
        log(f"  tenant {name}: {json.dumps(row)}")
        tenants.append(row)

    # one flush of each tenant alone: its wall time beside one request served
    # alone, the device's busy share (tenant A), and kernels 1-4 at the
    # flush's stacked shapes, from the flush's final factors
    flush_ms, flush_stages, kernels = {}, {}, {}
    for t, (name, shape, *_rest) in enumerate(SERVICE_TENANTS):
        ids = [i for i, r in enumerate(reqs) if r[0] == t][:SERVICE_MAX_BATCH]
        plan = tucker.plan(specs[t], device=dev)
        members = [reqs[i][1] for i in ids]
        flush_ms[name] = []
        obs.configure(enabled=True)  # the stages: factor draws and stacking, sweeps
        try:
            for _ in range(2):  # the first allocates the flush's memory anew
                t0 = time.perf_counter()
                batch = plan.batch(members, generators=[gen(reqs[i][2]) for i in ids])
                flush_ms[name].append((time.perf_counter() - t0) * 1e3)
        finally:
            obs.configure(enabled=False)
        flush_stages[name] = batch[0].trace_summary
        if t == 0:
            prof = profile_run(lambda: plan.batch(members,
                                                  generators=[gen(reqs[i][2]) for i in ids]))
        stacked, _ = stack_coo_batch(members)
        fs = [torch.cat([r.factors[m] for r in batch]).contiguous() for m in range(len(shape))]
        kernels[name] = stacked_kernel_checks(name, stacked, fs, len(members), shape)
        del stacked, fs, batch
        release_memory()
    summary = {
        "phase": "12 Tucker service", "card": card,
        "config": {"max_batch": SERVICE_MAX_BATCH, "max_wait_ms": 5.0, "max_inflight_flushes": 2,
                   "submitting_threads": SERVICE_THREADS},
        "generate_s": t_gen, "wall_s": wall, "requests": len(reqs),
        "requests_per_s": len(reqs) / wall, "sequential_s": sum(seq_s),
        "sequential_requests_per_s": len(reqs) / sum(seq_s),
        "ratio_to_sequential": sum(seq_s) / wall,
        "peak_above_resident_gb": (peak - resident) / 1e9, "resident_gb": resident / 1e9,
        "launches": {k: v for k, v in launches.items() if v},
        "metrics": {k: snap[k] for k in ("dispatches", "flushes", "requests_per_dispatch",
                                         "batch_size_mean", "completed", "failed")},
        "tenants": tenants,
        "flush_alone_ms": flush_ms, "flush_alone_stages_ms": flush_stages,
        # a warm flush of 16 alone against its 16 requests served alone
        "flush_alone_amortization": {
            row["tenant"]: SERVICE_MAX_BATCH * row["sequential_ms_per_request"]
            / flush_ms[row["tenant"]][-1] for row in tenants},
        "flush_a_profile": {k: prof[k] for k in ("wall_ms", "device_busy_ms", "busy_share",
                                                 "device_kernels", "kernel_ms")},
        "kernels_at_stacked_shapes": kernels,
    }
    print(json.dumps(summary), flush=True)
    del reqs, seq, results
    release_memory()

# -- phase 13: autotuning and snapshot/resume ------------------------------------------

AUTOTUNE_MAX_TRIALS = 4  # autotune()'s default: the default config and three more
SNAP_EVERY = 2  # sweeps per segment: 5 sweeps write steps 0, 2, 4 and 5
SNAP_KILL_AT = 4  # the injected kill, at a segment boundary
SNAP_RETRY_AT = 2  # the injected transient failure, retried in place
OVERHEAD_TURNS = 7  # turns of (no snapshot, every sweep, every 5 sweeps)
TENANT_C = ((200, 200, 200, 20), 80_000, (8, 8, 8, 8), "gram")  # phase 12's 4-way tenant


def same_bits(res, fit, factors, core) -> bool:
    """``res``'s fit history, factors and core are exactly the given ones
    (host copies)."""
    return (np.array_equal(res.fit_history, fit) and torch.equal(res.core.cpu(), core)
            and all(torch.equal(a.cpu(), b) for a, b in zip(res.factors, factors)))


def host_copy(res):
    return res.fit_history.copy(), [f.cpu() for f in res.factors], res.core.cpu()


def coo_checksum(coo) -> tuple:
    """Sums of a tensor's coordinates and values (int64 and f64): phase 13
    draws phase 4's tensor anew and checks it is the same one."""
    return (int(coo.indices.long().sum()), float(coo.values.double().sum()))


def within_phase3_tolerances(label: str, got, fit, factors, core) -> dict:
    """``got`` against a run held on the host: fit 1e-4, projectors 1e-3,
    core 1e-3 x max|core| with factor signs matched (phase 3's rule)."""
    fit_gap = float(np.abs(got.fit_history - fit).max())
    proj = max(projector_gap(a, b.to(a.device)) for a, b in zip(got.factors, factors))
    c = got.core.cpu()
    for n, (a, b) in enumerate(zip(got.factors, factors)):
        sign = torch.sign((a.cpu() * b).sum(0))
        c = c * sign.reshape([-1 if t == n else 1 for t in range(c.dim())])
    scale = float(core.abs().max())
    core_gap = float((c - core).abs().max())
    log(f"  {label}: fit {fit_gap:.3e} <= 1e-4, projectors {proj:.3e} <= 1e-3, core "
        f"{core_gap:.3e} <= {1e-3 * scale:.3e}")
    check(got.fit_history.shape == fit.shape and fit_gap <= 1e-4 and proj <= 1e-3
          and core_gap <= 1e-3 * scale, f"{label}: outside phase 3's tolerances")
    return {"fit_gap": fit_gap, "projector_gap": proj, "core_gap_over_scale": core_gap / scale}


def snapshot_bytes(directory: str) -> int:
    """Bytes of the newest snapshot in ``directory`` (its npz and manifest)."""
    from repro_torch.checkpoint.manager import CheckpointManager

    step = CheckpointManager(directory).latest_step()
    d = Path(directory) / f"step_{step:08d}"
    return sum(f.stat().st_size for f in d.iterdir())


def phase13_autotune_snapshots(dev, card: str, ref4: dict) -> None:
    """Autotuning and snapshot/resume on phase 4's tensor (drawn anew from
    its seed; ``ref4`` holds phase 4's fit history, factors, core and the
    tensor's checksum), then the 4-way kill and resume at tenant C's
    shape. The tuning table and the snapshots go to a temporary directory
    that is removed at the end."""
    import shutil
    import tempfile

    import repro_torch.obs as obs
    from repro_torch.kernels import autotune as at

    tf32_off()
    release_memory()
    tmp = tempfile.mkdtemp(prefix="chip_smoke_phase13_")
    saved_env = os.environ.get(at.TABLE_ENV)
    os.environ[at.TABLE_ENV] = os.path.join(tmp, "autotune.json")
    try:
        _phase13(dev, card, ref4, tmp)
    finally:
        obs.configure(enabled=False)
        if saved_env is None:
            os.environ.pop(at.TABLE_ENV, None)
        else:
            os.environ[at.TABLE_ENV] = saved_env
        shutil.rmtree(tmp, ignore_errors=True)
        release_memory()


def _phase13(dev, card: str, ref4: dict, tmp: str) -> None:
    import repro_torch.obs as obs
    from repro_torch import tucker
    from repro_torch.checkpoint.manager import CheckpointManager
    from repro_torch.core.coo import SparseCOO
    from repro_torch.kernels import autotune as at
    from repro_torch.kernels import kron_kernel
    from repro_torch.runtime.fault_tolerance import FailureInjector

    log(f"phase 13: autotuning and snapshot/resume at NELL-2 size {NELL2_SHAPE}, "
        f"{NELL2_NNZ} nnz, ranks {NELL2_RANKS}, {N_ITER} sweeps; 4-way kill and resume at "
        f"{TENANT_C[0]}")
    t0 = time.perf_counter()
    idx, vals = synthetic(dev, NELL2_SHAPE, NELL2_NNZ, SEED, "uniform")
    coo = SparseCOO.from_parts(idx, vals, NELL2_SHAPE)
    del idx, vals
    check(coo_checksum(coo) == ref4["checksum"], "phase 13's NELL-2 tensor is not phase 4's")
    fit4, factors4, core4 = ref4["fit"], ref4["factors"], ref4["core"]
    log(f"  phase 4's tensor drawn anew in {time.perf_counter() - t0:.2f} s (checksum equal)")
    out = {"phase": "13 autotuning and snapshot/resume", "card": card}

    # 13a: the cold autotuned plan: every count starts at 0 here
    spec_t = tucker.TuckerSpec(NELL2_SHAPE, NELL2_RANKS, n_iter=N_ITER, autotune=True)
    obs.tracer.clear()
    obs.configure(enabled=True)
    at.reset_counters()
    reset_launches()
    t0 = time.perf_counter()
    tuned = tucker.plan(spec_t, device=dev)(coo)
    torch.cuda.synchronize()
    t_cold = time.perf_counter() - t0
    launches = read_launches()
    counters = dict(at.COUNTERS)
    events = obs.tracer.events()
    obs.configure(enabled=False)
    search = [e for e in events if e.name == "autotune.search"]
    trials = [e for e in events if e.name == "autotune.trial"]
    check(len(search) == 1, f"{len(search)} autotune.search spans")
    n_cands = search[0].attrs["candidates"]
    pick = tuned.tuned_blocks
    rows = [{"config": at.BlockConfig(e.attrs["bn"], e.attrs["bi"], e.attrs["slots_per_part"],
                                      e.attrs["layout"])._asdict(),
             "ms": e.attrs.get("best_ms"), "error": e.attrs.get("error"), "nnz": e.attrs["nnz"]}
            for e in trials]
    for r in rows:
        log(f"  trial {r['config']}: {r['ms']} ms on {r['nnz']} nonzeros"
            + (f", raised {r['error']}" if r["error"] else ""))
    log(f"  cold autotuned run: {t_cold:.2f} s, counters {counters}, {n_cands} candidates, "
        f"pick {pick}, launches {launches}")
    check(counters["searches"] == 1 and counters["table_hits"] == 0
          and counters["trials"] == min(AUTOTUNE_MAX_TRIALS, n_cands) == len(trials),
          f"cold search: counters {counters}, {len(trials)} trial spans, {n_cands} candidates")
    check(any(r["config"] == at.DEFAULT_CONFIG._asdict() for r in rows),
          "the default config was not among the trials")
    check(not any(r["error"] for r in rows), f"a trial raised: {rows}")
    check(pick is not None and pick._asdict() in [r["config"] for r in rows],
          f"the pick {pick} is not a trial's config")
    check(launches["fused_kron_scatter"] > 0 and launches["ttm"] + launches[
        "fused_kron_scatter_ttm"] > 0, f"the tuned run launched {launches}")
    if pick == at.DEFAULT_CONFIG:
        check(same_bits(tuned, fit4, factors4, core4),
              "the default pick differs from phase 4's bits")
        out["tuned_vs_phase4"] = "same bits"
    else:
        out["tuned_vs_phase4"] = within_phase3_tolerances("tuned against phase 4", tuned, fit4,
                                                          factors4, core4)
    tuned_bits = host_copy(tuned)
    # kernel 1 (and kernel 5 for a fused pick) on the tuned schedules,
    # against their plain versions
    eng = tucker.plan(spec_t, device=dev).engine
    fs = [f.contiguous() for f in tuned.factors]
    for mode in range(3):
        sched = eng.device_schedule(coo, mode)
        fa, fb = kron_factors(fs, mode)
        compare(f"fused_kron_scatter NELL-2 mode {mode}, tuned schedule (bn {sched.bn}, bi "
                f"{sched.bi}, {int(sched.parts.numel()) - 1} ranges)", "fp32",
                synced(kron_kernel.fused_kron_scatter(fa, fb, sched, NELL2_SHAPE[mode])),
                synced(kron_kernel.fused_kron_scatter_plain(fa, fb, sched, NELL2_SHAPE[mode])),
                max_row_count(coo, mode))
        if mode == 2 and pick.layout == "fused":
            compare("fused_kron_scatter_ttm NELL-2, tuned schedule", "fp32",
                    synced(kron_kernel.fused_kron_scatter_ttm(fa, fb, fs[2], sched,
                                                              NELL2_SHAPE[2])),
                    synced(kron_kernel.fused_kron_scatter_ttm_plain(fa, fb, fs[2], sched,
                                                                    NELL2_SHAPE[2])),
                    NELL2_NNZ)

    # the warm plan: the table answers, no search
    tucker.clear_plan_cache()
    at.reset_counters()
    reset_launches()
    warm = tucker.plan(spec_t, device=dev)(coo)
    counters_warm = dict(at.COUNTERS)
    log(f"  warm autotuned plan: counters {counters_warm}, pick {warm.tuned_blocks}")
    check(counters_warm == {"searches": 0, "trials": 0, "table_hits": 1},
          f"warm plan: counters {counters_warm}")
    check(warm.tuned_blocks == pick and same_bits(warm, *tuned_bits),
          "the warm plan differs from the cold one")

    # one forced fused trial: it runs kernel 5 (and no kernel 2)
    reset_launches()
    fused_ms = at.trial_time_ms(at.BlockConfig(layout="fused"), NELL2_SHAPE, NELL2_RANKS,
                                NELL2_NNZ, device=dev)
    fused_launches = read_launches()
    log(f"  forced fused trial: {fused_ms:.3f} ms, launches {fused_launches}")
    check(fused_launches["fused_kron_scatter_ttm"] > 0 and fused_launches["ttm"] == 0,
          f"the fused trial launched {fused_launches}")

    # warm sweep ms, tuned against the split path of phase 4, in turns
    plan_t = tucker.plan(spec_t, device=dev)
    plan_d = tucker.plan(tucker.TuckerSpec(NELL2_SHAPE, NELL2_RANKS, n_iter=N_ITER), device=dev)
    first_d = plan_d(coo)
    check(same_bits(first_d, fit4, factors4, core4), "the split path differs from phase 4's")
    runs_t, runs_d = [], []
    for _ in range(WARM_RUNS):
        runs_d += [ms / N_ITER for ms in warm_ms(lambda: plan_d(coo), runs=1)]
        runs_t += [ms / N_ITER for ms in warm_ms(lambda: plan_t(coo), runs=1)]
    tuned_ms, default_ms = float(np.median(runs_t)), float(np.median(runs_d))
    log(f"  warm ms per sweep: tuned {tuned_ms:.2f} (" + ", ".join(f"{m:.2f}" for m in runs_t)
        + f"), phase 4's split path {default_ms:.2f} ("
        + ", ".join(f"{m:.2f}" for m in runs_d) + ")")
    out["autotune"] = {"candidates": n_cands, "trials": rows, "pick": pick._asdict(),
                       "cold_run_s": t_cold, "counters_cold": counters,
                       "counters_warm": counters_warm, "forced_fused_trial_ms": fused_ms,
                       "forced_fused_trial_launches": {k: v for k, v in fused_launches.items()
                                                       if v},
                       "tuned_sweep_ms": tuned_ms, "tuned_sweep_ms_runs": runs_t,
                       "split_sweep_ms": default_ms, "split_sweep_ms_runs": runs_d}
    del plan_t, warm, tuned, first_d, eng, fs
    tucker.clear_plan_cache()

    # 13b: snapshots from phase 4's initial factors (the plan's default draw)
    def snap_spec(name, every=SNAP_EVERY, **kw):
        return tucker.TuckerSpec(NELL2_SHAPE, NELL2_RANKS, n_iter=N_ITER,
                                 snapshot=tucker.SnapshotSpec(every_n_sweeps=every,
                                                              directory=os.path.join(tmp, name),
                                                              **kw))

    spec_a = snap_spec("uninterrupted")
    obs.tracer.clear()
    obs.configure(enabled=True)
    reset_launches()
    res_a = tucker.plan(spec_a, device=dev)(coo)
    torch.cuda.synchronize()
    launches_a = read_launches()
    segs = [e for e in obs.tracer.events()
            if e.name == "sweep.dispatch" and e.attrs.get("program") == "segment"]
    obs.configure(enabled=False)
    steps = CheckpointManager(spec_a.snapshot.directory).all_steps()
    seg_builds = [e.attrs["schedule_builds"] for e in segs]
    log(f"  uninterrupted snapshot run: {res_a.dispatches} segments, "
        f"{res_a.snapshots_written} snapshots, steps kept {steps}, builds by segment "
        f"{seg_builds}, launches {launches_a}")
    check(same_bits(res_a, fit4, factors4, core4), "the snapshot run differs from phase 4's")
    check(res_a.snapshots_written == 4 and steps == [2, 4, 5] and res_a.dispatches == 3,
          f"snapshot run: {res_a.snapshots_written} written, steps {steps}")
    check(seg_builds == [3, 0, 0], f"schedule builds by segment {seg_builds}")
    want = {"fused_kron_scatter": 3 * N_ITER, "ttm": N_ITER, "kron_contrib": 0,
            "scatter_rows": 0, "fused_kron_scatter_ttm": 0, **NO_LM_LAUNCHES}
    check(launches_a == want, f"snapshot run launches {launches_a}, want {want}")

    spec_k = snap_spec("killed")
    reset_launches()
    try:
        tucker.plan(spec_k, device=dev)(coo, injector=FailureInjector([SNAP_KILL_AT]))
        killed = False
    except RuntimeError as exc:
        killed = "injected failure" in str(exc)
    check(killed, "the injected kill did not raise")
    resumed = tucker.resume(spec_k, coo, device=dev)
    torch.cuda.synchronize()
    launches_k = read_launches()
    log(f"  killed at sweep {SNAP_KILL_AT}, resumed from {resumed.resumed_from_sweep}: "
        f"{resumed.dispatches} segment, {resumed.schedule_builds} builds, launches over both "
        f"{launches_k}")
    check(resumed.resumed_from_sweep == SNAP_KILL_AT and resumed.schedule_builds == 0,
          f"resume: from {resumed.resumed_from_sweep}, {resumed.schedule_builds} builds")
    check(same_bits(resumed, fit4, factors4, core4), "the resumed run differs from phase 4's")
    check(launches_k == want, f"kill and resume launched {launches_k}, want {want}")

    # the runs below share the split plan's engine (its schedules of coo)
    spec_r = snap_spec("retried", max_retries=1, retry_backoff_s=0.0)
    retried = tucker.plan(spec_r, device=dev, engine=plan_d.engine)(
        coo, injector=FailureInjector([SNAP_RETRY_AT]))
    log(f"  retried at sweep {SNAP_RETRY_AT}: retries {retried.retries}")
    check(retried.retries == 1 and same_bits(retried, fit4, factors4, core4),
          f"the retried run: {retried.retries} retries, or other bits")

    # the overhead: warm ms per sweep at 1 and 5 sweeps a segment against no
    # snapshot, in turns, each timed call writing its snapshots; and each
    # write's own time, from its snapshot.spill span (the sweep time of this
    # host-bound path moves by more than a write costs from run to run)
    spec_1, spec_5 = snap_spec("every1", every=1), snap_spec("every5", every=5)
    plans = {"none": plan_d, "every_1": tucker.plan(spec_1, device=dev, engine=plan_d.engine),
             "every_5": tucker.plan(spec_5, device=dev, engine=plan_d.engine)}
    for p in plans.values():
        p(coo)  # warm: schedules built
    runs = {k: [] for k in plans}
    obs.tracer.clear()
    obs.configure(enabled=True)
    gc.collect()
    for _ in range(OVERHEAD_TURNS):
        for k, p in plans.items():
            runs[k] += [ms / N_ITER for ms in warm_ms(lambda p=p: p(coo), runs=1)]
    spills = [e.duration_ms for e in obs.tracer.events() if e.name == "snapshot.spill"]
    obs.configure(enabled=False)
    med = {k: float(np.median(v)) for k, v in runs.items()}
    spill_ms = float(np.median(spills))
    per_run = {"every_1": N_ITER + 1, "every_5": 2}  # the step-0 snapshot and each boundary
    check(len(spills) == OVERHEAD_TURNS * sum(per_run.values()),
          f"{len(spills)} snapshot.spill spans in the overhead runs")
    spill = snapshot_bytes(spec_1.snapshot.directory)
    log(f"  overhead, ms per sweep (medians of {OVERHEAD_TURNS} turns): none {med['none']:.2f}, "
        f"every 1 {med['every_1']:.2f} ({med['every_1'] - med['none']:+.2f}), every 5 "
        f"{med['every_5']:.2f} ({med['every_5'] - med['none']:+.2f}); a write {spill_ms:.2f} ms "
        f"(median of {len(spills)}), so +{per_run['every_1'] * spill_ms / N_ITER:.2f} and "
        f"+{per_run['every_5'] * spill_ms / N_ITER:.2f} ms a sweep; {spill} bytes a snapshot")
    out["snapshots"] = {"every_n_sweeps": SNAP_EVERY, "written": res_a.snapshots_written,
                        "steps_kept": steps, "builds_by_segment": seg_builds,
                        "launches": {k: v for k, v in launches_a.items() if v},
                        "kill_at": SNAP_KILL_AT, "resumed_from": resumed.resumed_from_sweep,
                        "retries": retried.retries, "sweep_ms": med, "sweep_ms_runs": runs,
                        "spill_ms_median": spill_ms, "spills_timed": len(spills),
                        "spill_ms_range": [min(spills), max(spills)],
                        "spill_ms_per_sweep": {k: n * spill_ms / N_ITER
                                               for k, n in per_run.items()},
                        "bytes_per_snapshot": spill}
    del plans, plan_d, res_a, resumed, retried
    del coo
    release_memory()

    # 13c: the 4-way path (kernels 3, 4, 2) under segments
    shape_c, nnz_c, ranks_c, method_c = TENANT_C
    idx, vals = synthetic(dev, shape_c, nnz_c, 13, "uniform")
    coo_c = SparseCOO.from_parts(idx, vals, shape_c)
    reset_launches()
    base_c = tucker.plan(tucker.TuckerSpec(shape_c, ranks_c, method=method_c, n_iter=N_ITER),
                         device=dev)(coo_c)
    torch.cuda.synchronize()
    want_c = read_launches()
    spec_c = tucker.TuckerSpec(shape_c, ranks_c, method=method_c, n_iter=N_ITER,
                               snapshot=tucker.SnapshotSpec(
                                   every_n_sweeps=SNAP_EVERY,
                                   directory=os.path.join(tmp, "four_way")))
    reset_launches()
    try:
        tucker.plan(spec_c, device=dev)(coo_c, injector=FailureInjector([SNAP_KILL_AT]))
        killed = False
    except RuntimeError as exc:
        killed = "injected failure" in str(exc)
    resumed_c = tucker.resume(spec_c, coo_c, device=dev)
    torch.cuda.synchronize()
    launches_c = read_launches()
    log(f"  4-way: killed {killed}, resumed from {resumed_c.resumed_from_sweep}, launches over "
        f"both {launches_c} (uninterrupted {want_c})")
    check(killed and resumed_c.resumed_from_sweep == SNAP_KILL_AT,
          "the 4-way kill and resume did not run")
    check(want_c["kron_contrib"] == 8 * N_ITER and want_c["scatter_rows"] == 4 * N_ITER
          and launches_c == want_c, f"4-way launches {launches_c}, want {want_c}")
    check(same_bits(resumed_c, *host_copy(base_c)),
          "the 4-way resumed run differs from its uninterrupted run")
    check(bool(np.all(np.isfinite(resumed_c.fit_history))), "4-way fit not finite")
    out["four_way"] = {"shape": shape_c, "nnz": nnz_c, "ranks": ranks_c, "method": method_c,
                       "resumed_from": resumed_c.resumed_from_sweep,
                       "launches": {k: v for k, v in launches_c.items() if v},
                       "fit_history": resumed_c.fit_history.tolist()}
    print(json.dumps(out), flush=True)


# -- phase 14: sharded sparse HOOI over torch.distributed ----------------------------

SHARD_WORLD = 4  # 14b-14d: ranks sharing the one card over gloo
SHARD_RESUME_WORLD = 2  # 14d: the elastic resume
SHARD_WARM_RUNS = 3
SHARD_TIMEOUT_S = 300  # each group's collective timeout, and each spawn's deadline


def shard_imbalance_of(nnz: int, world: int) -> float:
    """``1 - min/max`` of the shards' real nonzeros when ``nnz`` nonzeros
    are padded to a multiple of ``world`` and cut into contiguous slices,
    worked out here apart from the port."""
    per = -(-nnz // world)
    counts = [min(max(nnz - r * per, 0), per) for r in range(world)]
    return 1.0 - min(counts) / max(counts)


def shard_child(rank: int, world: int, backend: str, store: str, tmp: str, job: str,
                cfg: dict) -> None:
    """One rank of phase 14, in a spawned process: joins the group, draws
    the tensor on its device from phase 4's seed, runs ``job`` and saves
    its results to ``tmp``. The parent built the kernels; this process
    loads them."""
    import datetime

    import torch.distributed as dist

    sys.path.insert(0, str(ROOT / "src"))
    on_card = cfg["device"] != "cpu"
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if on_card:
        torch.cuda.set_device(0)  # every rank's card: the one of this machine
        torch.cuda.reset_peak_memory_stats()
    # NCCL binds its communicator to the rank's card at once
    bind = {"device_id": torch.device("cuda", 0)} if backend == "nccl" else {}
    dist.init_process_group(backend, store=dist.FileStore(store, world), rank=rank,
                            world_size=world,
                            timeout=datetime.timedelta(seconds=SHARD_TIMEOUT_S), **bind)
    try:
        out = SHARD_JOBS[job](rank, world, torch.device(cfg["device"]), tmp, cfg)
        if on_card:
            out["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
        torch.save(out, os.path.join(tmp, f"{job}-r{rank}.pt"))
    finally:
        dist.destroy_process_group()


def _shard_sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize()


def _shard_tensor(dev, cfg: dict, which: str = "nell2"):
    from repro_torch.core.coo import SparseCOO

    if which == "nell2":
        idx, vals = synthetic(dev, cfg["shape"], cfg["nnz"], SEED, "uniform")
        return SparseCOO.from_parts(idx, vals, cfg["shape"])
    shape_c, nnz_c = cfg["tenant_c"][:2]
    idx, vals = synthetic(dev, shape_c, nnz_c, 13, "uniform")
    return SparseCOO.from_parts(idx, vals, shape_c)


def _shard_result(res, launches: dict) -> dict:
    return {"fit": res.fit_history.copy(), "factors": [f.cpu() for f in res.factors],
            "core": res.core.cpu(), "launches": {k: v for k, v in launches.items() if v},
            "dispatches": res.dispatches, "collective_bytes": res.collective_bytes_per_sweep,
            "imbalance": res.shard_imbalance, "resumed_from": res.resumed_from_sweep,
            "world": res.spec.shard.num_devices if res.spec.shard else None}


def _shard_warm(plan, coo, dev, runs: int) -> dict:
    """Warm sweep ms (host clock around each call, which ends in a
    synchronize), the ranks lined up at a barrier before each; then the
    all-reduce ms a sweep, from one more call with each collective timed
    between two synchronizes."""
    import torch.distributed as dist

    from repro_torch.core.engine import ShardedSweepEngine

    n_iter = plan.spec.n_iter
    sweep_ms = []
    for _ in range(runs):
        dist.barrier()
        t0 = time.perf_counter()
        plan(coo)
        _shard_sync(dev)
        sweep_ms.append((time.perf_counter() - t0) * 1e3 / n_iter)
    spent = []
    real = ShardedSweepEngine.all_reduce

    def timed(self, y):
        _shard_sync(dev)
        t0 = time.perf_counter()
        out = real(self, y)
        _shard_sync(dev)
        spent.append((time.perf_counter() - t0) * 1e3)
        return out

    ShardedSweepEngine.all_reduce = timed
    try:
        dist.barrier()
        plan(coo)
    finally:
        ShardedSweepEngine.all_reduce = real
    return {"sweep_ms": float(np.median(sweep_ms)), "sweep_ms_runs": sweep_ms,
            "allreduce_ms_per_sweep": sum(spent) / n_iter, "allreduces": len(spent)}


def _shard_job_one(rank, world, dev, tmp, cfg) -> dict:
    """14a: phase 4's tensor and factors on a world of one."""
    from repro_torch import tucker

    coo = _shard_tensor(dev, cfg)
    spec = tucker.TuckerSpec(cfg["shape"], cfg["ranks"], n_iter=N_ITER,
                             shard=tucker.ShardSpec(world))
    plan = tucker.plan(spec, device=dev)
    reset_launches()
    res = plan(coo)
    _shard_sync(dev)
    out = _shard_result(res, read_launches())
    out["checksum"] = coo_checksum(coo)
    out["fingerprint"] = tucker.mesh_fingerprint(plan.mesh)
    out.update(_shard_warm(plan, coo, dev, SHARD_WARM_RUNS))
    return out


def _shard_kernel1_on_slice(plan, coo, res, shape) -> dict:
    """Kernel 1 on this rank's slice, mode by mode, at the schedules the
    sharded sweep gave it: against its plain version (fp32), both timed,
    and its bound for the slice's real nonzeros."""
    from repro_torch.kernels import kron_kernel

    sched = plan.engine.shard_schedule(coo, plan.mesh)
    local = sched.coo
    real_nnz = int(sched.shard_counts[sched.rank])
    fs = [f.contiguous() for f in res.factors]
    row = {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0, "max_abs_err": 0.0, "per_mode": []}
    nbytes_all, flops_all = 0, 0
    for mode in range(3):
        ds = plan.engine.device_schedule(local, mode)
        fa, fb = kron_factors(fs, mode)
        kern = partial(kron_kernel.fused_kron_scatter, fa, fb, ds, shape[mode])
        plain = partial(kron_kernel.fused_kron_scatter_plain, fa, fb, ds, shape[mode])
        err = compare(f"fused_kron_scatter rank 0's slice mode {mode} ({real_nnz} nnz)", "fp32",
                      synced(kern()), synced(plain()), max_row_count(local, mode))
        ms, p_ms = time_ms(kern), time_ms(plain, reps=1)
        k = fa.shape[1] * fb.shape[1]
        nbytes = (nbytes_of(ds.idx, ds.vals, ds.rel_row, ds.blkmap, ds.parts,
                            *kron_kernel._cast_operands("fp32", fa, fb)) + shape[mode] * k * 4)
        flops = 3 * real_nnz * k
        b_ms, _ = bound(nbytes, flops, PEAK_TF32_FLOPS)
        nbytes_all, flops_all = nbytes_all + nbytes, flops_all + flops
        for key, v in (("ms", ms), ("plain_ms", p_ms), ("bound_ms", b_ms)):
            row[key] += v
        row["max_abs_err"] = max(row["max_abs_err"], err)
        row["per_mode"].append({"mode": mode, "ms": ms, "plain_ms": p_ms, "bound_ms": b_ms,
                                "max_abs_err": err})
    row["bound_by"] = bound(nbytes_all, flops_all, PEAK_TF32_FLOPS)[1]
    return {"kernel1": row, "kernel1_ms_per_sweep": row["ms"], "slice_nnz": real_nnz}


def _shard_kernels34_on_slice(plan, coo, res, shape) -> dict:
    """Kernels 3 and 4 on this rank's slice of a 4-way tensor, mode by mode,
    at the schedules the sharded sweep gave them: each against its plain
    version (fp32), both timed, and each kernel's bound."""
    from repro_torch.kernels import kron_kernel, ops

    sched = plan.engine.shard_schedule(coo, plan.mesh)
    local = sched.coo
    real_nnz = int(sched.shard_counts[sched.rank])
    fs = [f.contiguous() for f in res.factors]
    tot = {name: {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0, "max_abs_err": 0.0,
                  "bytes": 0, "flops": 0} for name in ("kron_contrib", "scatter_rows")}
    for mode in range(4):
        ds = plan.engine.device_schedule(local, mode)
        rows, v = ops._gathered_block_rows(local.indices, local.values, fs, mode, ds, 4)
        ones = torch.ones_like(v)
        nnzp = v.shape[0]
        label = f"rank 0's slice mode {mode} ({real_nnz} nnz)"
        link1 = partial(kron_kernel.kron_contrib, rows[0], rows[1], v)
        link1_plain = partial(kron_kernel.kron_contrib_plain, rows[0], rows[1], v)
        c1 = synced(link1())
        err1 = compare(f"kron_contrib {label} link 1", "fp32", c1, synced(link1_plain()), 1)
        link2 = partial(kron_kernel.kron_contrib, c1, rows[2], ones)
        link2_plain = partial(kron_kernel.kron_contrib_plain, c1, rows[2], ones)
        c2 = synced(link2())
        err2 = compare(f"kron_contrib {label} link 2", "fp32", c2, synced(link2_plain()), 1)
        scat = partial(kron_kernel.scatter_rows, c2, ds, shape[mode])
        scat_plain = partial(kron_kernel.scatter_rows_plain, c2, ds, shape[mode])
        err_s = compare(f"scatter_rows {label}", "fp32", synced(scat()), synced(scat_plain()),
                        max_row_count(local, mode))
        k1, k = c1.shape[1], c2.shape[1]
        for name, ms, p_ms, nb, fl, err in (
                ("kron_contrib", time_ms(link1) + time_ms(link2),
                 time_ms(link1_plain) + time_ms(link2_plain),
                 # link 1 writes c1 and link 2 reads it; link 2 writes c2
                 nbytes_of(rows[0], rows[1], v, c1, c1, rows[2], ones) + nnzp * k * 4,
                 2 * nnzp * k1 + 2 * nnzp * k, max(err1, err2)),
                ("scatter_rows", time_ms(scat), time_ms(scat_plain),
                 nbytes_of(c2, ds.rel_row, ds.blkmap, ds.parts) + shape[mode] * k * 4,
                 real_nnz * k, err_s)):
            t = tot[name]
            t["ms"] += ms
            t["plain_ms"] += p_ms
            t["bound_ms"] += bound(nb, fl)[0]
            t["bytes"] += nb
            t["flops"] += fl
            t["max_abs_err"] = max(t["max_abs_err"], err)
    for t in tot.values():
        t["bound_by"] = bound(t["bytes"], t["flops"])[1]
    return {"slice_nnz": real_nnz, **tot}


def _count_checkpoint_saves() -> list:
    """Steps this process writes through ``CheckpointManager.save``."""
    from repro_torch.checkpoint.manager import CheckpointManager

    saves, real = [], CheckpointManager.save

    def save(self, step, state, extra=None):
        saves.append(int(step))
        return real(self, step, state, extra=extra)

    CheckpointManager.save = save
    return saves


def _shard_snap_spec(cfg, tmp, name, world):
    from repro_torch import tucker

    return tucker.TuckerSpec(cfg["shape"], cfg["ranks"], n_iter=N_ITER,
                             shard=tucker.ShardSpec(world),
                             snapshot=tucker.SnapshotSpec(every_n_sweeps=SNAP_EVERY,
                                                          directory=os.path.join(tmp, name)))


def _shard_job_four(rank, world, dev, tmp, cfg) -> dict:
    """14b-14d on ``world`` ranks sharing the card."""
    import torch.distributed as dist

    from repro_torch import tucker
    from repro_torch.checkpoint.manager import CheckpointManager
    from repro_torch.kernels import kron_kernel
    from repro_torch.runtime.fault_tolerance import FailureInjector

    saves = _count_checkpoint_saves()
    coo = _shard_tensor(dev, cfg)
    out = {"checksum": coo_checksum(coo)}
    # 14b: the main path of this phase; the counts start at 0 here
    spec = tucker.TuckerSpec(cfg["shape"], cfg["ranks"], n_iter=N_ITER,
                             shard=tucker.ShardSpec(world))
    plan = tucker.plan(spec, device=dev)
    dist.barrier()
    reset_launches()
    res = plan(coo)
    _shard_sync(dev)
    out["b"] = _shard_result(res, read_launches())
    out["b"].update(_shard_warm(plan, coo, dev, SHARD_WARM_RUNS))
    out["fingerprint"] = tucker.mesh_fingerprint(plan.mesh)
    if dev.type == "cuda":  # kernel 1 on this rank's slice, the other ranks idle
        dist.barrier()
        if rank == 0:
            out["b"].update(_shard_kernel1_on_slice(plan, coo, res, cfg["shape"]))
        dist.barrier()
    del plan
    tucker.clear_plan_cache()

    # 14c: tenant C's 4-way shape, sharded, and unsharded on rank 0
    coo_c = _shard_tensor(dev, cfg, "tenant_c")
    shape_c, _, ranks_c, method_c = cfg["tenant_c"]
    spec_c = tucker.TuckerSpec(shape_c, ranks_c, method=method_c, n_iter=N_ITER,
                               shard=tucker.ShardSpec(world))
    plan_c = tucker.plan(spec_c, device=dev)
    dist.barrier()
    reset_launches()
    res_c = plan_c(coo_c)
    _shard_sync(dev)
    out["c"] = _shard_result(res_c, read_launches())
    if rank == 0:
        base = tucker.plan(tucker.TuckerSpec(shape_c, ranks_c, method=method_c,
                                             n_iter=N_ITER), device=dev)(coo_c)
        out["c_unsharded"] = _shard_result(base, {})
        if dev.type == "cuda":  # kernels 3 and 4 on this rank's slice
            out["c_kernels"] = _shard_kernels34_on_slice(plan_c, coo_c, res_c, shape_c)
    dist.barrier()
    del coo_c, plan_c
    tucker.clear_plan_cache()

    # 14d: kill at a segment boundary; resume on this world; a second job
    # is left for fewer ranks
    killed = []
    for name in ("same_world", "fewer_ranks"):
        try:
            tucker.plan(_shard_snap_spec(cfg, tmp, name, world), device=dev)(
                coo, injector=FailureInjector([SNAP_KILL_AT]))
            killed.append(False)
        except RuntimeError as exc:
            killed.append("injected failure" in str(exc))
    dist.barrier()
    out["killed"] = killed
    if rank == 0:
        mgr = CheckpointManager(os.path.join(tmp, "fewer_ranks"))
        out["manifest_mesh"] = mgr.read_manifest()["extra"]["mesh"]
        out["steps_on_disk"] = mgr.all_steps()
    reset_launches()
    resumed = tucker.resume(_shard_snap_spec(cfg, tmp, "same_world", world), coo, device=dev)
    _shard_sync(dev)
    out["d"] = _shard_result(resumed, read_launches())
    out["saves"] = list(saves)
    return out


def _shard_job_fewer(rank, world, dev, tmp, cfg) -> dict:
    """14d: the job killed on ``SHARD_WORLD`` ranks, resumed on these."""
    import warnings

    from repro_torch import tucker

    saves = _count_checkpoint_saves()
    coo = _shard_tensor(dev, cfg)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        res = tucker.resume(_shard_snap_spec(cfg, tmp, "fewer_ranks", SHARD_WORLD), coo,
                            device=dev)
    _shard_sync(dev)
    out = _shard_result(res, {})
    out["warned"] = [str(w.message) for w in caught if issubclass(w.category, RuntimeWarning)]
    out["saves"] = list(saves)
    return out


SHARD_JOBS = {"one": _shard_job_one, "four": _shard_job_four, "fewer": _shard_job_fewer}


def run_ranks(job: str, world: int, backend: str, tmp: str, cfg: dict) -> list:
    """Spawn ``world`` ranks of ``job`` and return each rank's saved result;
    a rank that fails fails the phase, and none outlives it."""
    import torch.multiprocessing as mp

    store = os.path.join(tmp, f"store-{job}")
    ctx = mp.start_processes(shard_child, args=(world, backend, store, tmp, job, cfg),
                             nprocs=world, join=False, start_method="spawn")
    deadline = time.monotonic() + SHARD_TIMEOUT_S
    try:
        while not ctx.join(timeout=1.0):
            check(time.monotonic() < deadline,
                  f"phase 14 {job}: ranks still running after {SHARD_TIMEOUT_S} s")
    finally:
        for proc in ctx.processes:
            if proc.is_alive():
                proc.terminate()
                proc.join(10)
    return [torch.load(os.path.join(tmp, f"{job}-r{r}.pt"), weights_only=False)
            for r in range(world)]


def _as_run(r: dict, dev):
    """A rank's saved result as ``within_phase3_tolerances`` reads one."""
    from types import SimpleNamespace

    return SimpleNamespace(fit_history=r["fit"], factors=[f.to(dev) for f in r["factors"]],
                           core=r["core"])


def _same_bits(a: dict, b: dict) -> bool:
    return (np.array_equal(a["fit"], b["fit"]) and torch.equal(a["core"], b["core"])
            and all(torch.equal(x, y) for x, y in zip(a["factors"], b["factors"])))


def phase14_sharded(dev, card: str, ref4: dict, cfg: Optional[dict] = None) -> None:
    """Sharded sparse HOOI (``TuckerSpec.shard``) in spawned ranks: 14a
    phase 4's run over NCCL in a world of one (its bits); 14b the same on 4
    ranks over gloo sharing the card (every rank the same bits, phase 3's
    tolerances of phase 4); 14c tenant C's 4-way shape on 4 ranks against
    its unsharded run; 14d a kill and resume on 4 ranks (14b's bits) and
    on 2 (the clamp warning, phase 3's tolerances). ``cfg`` shrinks the
    shapes for a rehearsal on the CPU (``{"device": "cpu", ...}``)."""
    import shutil
    import tempfile

    cfg = {"device": "cuda", "shape": NELL2_SHAPE, "nnz": NELL2_NNZ, "ranks": NELL2_RANKS,
           "tenant_c": TENANT_C, "backend_a": "nccl", **(cfg or {})}
    on_card = cfg["device"] != "cpu"
    shape, nnz, ranks = cfg["shape"], cfg["nnz"], cfg["ranks"]
    log(f"phase 14: sharded sparse HOOI, {shape}, {nnz} nnz, ranks {ranks}, {N_ITER} sweeps: "
        f"a world of one over {cfg['backend_a']}, {SHARD_WORLD} and {SHARD_RESUME_WORLD} "
        f"ranks over gloo sharing the card; tenant C {cfg['tenant_c'][0]}")
    if on_card:
        release_memory()
    tmp = tempfile.mkdtemp(prefix="chip_smoke_phase14_")
    out = {"phase": "14 sharded sparse HOOI", "card": card}
    # N all-reduces a sweep, of I_n x prod_{t != n} R_t f32 each
    want_bytes = sum(dim * math.prod(r for t, r in enumerate(ranks) if t != m) * 4
                     for m, dim in enumerate(shape))
    launches3 = {"fused_kron_scatter": 3 * N_ITER, "ttm": N_ITER}
    try:
        # 14a
        t0 = time.perf_counter()
        a = run_ranks("one", 1, cfg["backend_a"], tmp, cfg)[0]
        t_a = time.perf_counter() - t0
        log(f"  14a: world of one over {cfg['backend_a']} ({a['fingerprint']}), {t_a:.1f} s: "
            f"launches {a['launches']}, {a['collective_bytes']} B a sweep, warm "
            f"{a['sweep_ms']:.2f} ms a sweep (all-reduce {a['allreduce_ms_per_sweep']:.3f})")
        check(a["checksum"] == ref4["checksum"], "14a: the tensor is not phase 4's")
        check(_same_bits(a, ref4), "14a: not phase 4's bits")
        check(a["collective_bytes"] == want_bytes,
              f"14a: {a['collective_bytes']} B a sweep, want {want_bytes}")
        check(a["dispatches"] == 1 and a["imbalance"] == 0.0, "14a: dispatches or imbalance")
        if on_card:
            check(a["launches"] == launches3, f"14a: launches {a['launches']}")
        out["14a"] = {key: a.get(key) for key in (
            "launches", "collective_bytes", "sweep_ms", "sweep_ms_runs",
            "allreduce_ms_per_sweep", "fingerprint", "peak_gb")}
        out["14a"]["seconds"] = t_a

        # 14b-14d
        t0 = time.perf_counter()
        four = run_ranks("four", SHARD_WORLD, "gloo", tmp, cfg)
        t_four = time.perf_counter() - t0
        r0 = four[0]
        fp4 = r0["fingerprint"]
        for r, o in enumerate(four):
            check(o["checksum"] == ref4["checksum"], f"rank {r}: the tensor is not phase 4's")
            for part in ("b", "c", "d"):
                check(_same_bits(o[part], r0[part]), f"14{part}: rank {r}'s bits are not rank 0's")
            if on_card:
                check(o["b"]["launches"] == launches3, f"14b rank {r}: launches "
                      f"{o['b']['launches']}")
                want_c = {"kron_contrib": 8 * N_ITER, "scatter_rows": 4 * N_ITER, "ttm": N_ITER}
                check(o["c"]["launches"] == want_c, f"14c rank {r}: launches "
                      f"{o['c']['launches']}")
            check(o["killed"] == [True, True], f"14d rank {r}: the kills {o['killed']}")
            check(o["saves"] == ([0, 2, 4] * 2 + [5] if r == 0 else []),
                  f"14d rank {r} wrote steps {o['saves']}")
        b = r0["b"]
        want_imb = shard_imbalance_of(nnz, SHARD_WORLD)
        log(f"  14b: {SHARD_WORLD} ranks over gloo ({fp4}), {t_four:.1f} s for 14b-14d; "
            f"imbalance {b['imbalance']!r} (want {want_imb!r}); every rank the same bits")
        check(b["imbalance"] == want_imb and b["collective_bytes"] == want_bytes,
              "14b: imbalance or collective bytes")
        out["14b"] = {"vs_phase4": within_phase3_tolerances(
            "14b against phase 4", _as_run(b, dev), ref4["fit"], ref4["factors"], ref4["core"])}
        for r, o in enumerate(four):
            log(f"  14b rank {r}: warm {o['b']['sweep_ms']:.2f} ms a sweep ("
                + ", ".join(f"{m:.2f}" for m in o["b"]["sweep_ms_runs"])
                + f"), all-reduce {o['b']['allreduce_ms_per_sweep']:.2f} ms a sweep over "
                f"{o['b']['allreduces']} calls, peak {o.get('peak_gb', 0.0):.2f} GB")
        out["14b"].update(
            imbalance=b["imbalance"], collective_bytes=b["collective_bytes"],
            sweep_ms_by_rank=[o["b"]["sweep_ms"] for o in four],
            sweep_ms_runs_by_rank=[o["b"]["sweep_ms_runs"] for o in four],
            allreduce_ms_per_sweep_by_rank=[o["b"]["allreduce_ms_per_sweep"] for o in four],
            peak_gb_by_rank=[o.get("peak_gb") for o in four],
            kernel1_ms_per_sweep_rank0=b.get("kernel1_ms_per_sweep"),
            kernel1_rank0=b.get("kernel1"),
            slice_nnz_rank0=b.get("slice_nnz"), launches_rank0=b["launches"])
        if on_card:
            k1 = b["kernel1"]
            check(math.isfinite(k1["max_abs_err"]) and k1["plain_ms"] > 0,
                  "14b: kernel 1 was not held to its plain version on rank 0's slice")
            log(f"  14b kernel 1 on rank 0's slice ({b['slice_nnz']} nnz), 3 modes, CUDA "
                f"events: {k1['ms']:.3f} ms a sweep, plain {k1['plain_ms']:.3f} ms, bound "
                f"{k1['bound_ms']:.3f} ms, max_abs_err {k1['max_abs_err']:.3e}")
        c = r0["c"]
        out["14c"] = {"vs_unsharded": within_phase3_tolerances(
            "14c against its unsharded run", _as_run(c, dev), r0["c_unsharded"]["fit"],
            r0["c_unsharded"]["factors"], r0["c_unsharded"]["core"]),
            "launches_rank0": c["launches"], "imbalance": c["imbalance"],
            "kernels_rank0": r0.get("c_kernels")}
        if on_card:
            for name in ("kron_contrib", "scatter_rows"):
                k = r0["c_kernels"][name]
                check(math.isfinite(k["max_abs_err"]) and k["plain_ms"] > 0,
                      f"14c: {name} was not held to its plain version on rank 0's slice")
                log(f"  14c {name} on rank 0's slice ({r0['c_kernels']['slice_nnz']} nnz), 4 "
                    f"modes: {k['ms']:.3f} ms a sweep, plain {k['plain_ms']:.3f} ms, bound "
                    f"{k['bound_ms']:.4f} ms, max_abs_err {k['max_abs_err']:.3e}")
        check(c["imbalance"] == shard_imbalance_of(cfg["tenant_c"][1], SHARD_WORLD),
              "14c: imbalance")
        d = r0["d"]
        log(f"  14d: killed at sweep {SNAP_KILL_AT} on {SHARD_WORLD} ranks, resumed there from "
            f"{d['resumed_from']}: 14b's bits {_same_bits(d, b)}; manifest mesh "
            f"{r0['manifest_mesh']}, steps on disk {r0['steps_on_disk']}")
        check(d["resumed_from"] == SNAP_KILL_AT and _same_bits(d, b),
              "14d: the resumed run is not the uninterrupted 4-rank run")
        check(r0["manifest_mesh"] == fp4, f"14d: manifest mesh {r0['manifest_mesh']}")

        t0 = time.perf_counter()
        fewer = run_ranks("fewer", SHARD_RESUME_WORLD, "gloo", tmp, cfg)
        t_fewer = time.perf_counter() - t0
        f0 = fewer[0]
        for r, o in enumerate(fewer):
            check(_same_bits(o, f0), f"14d: rank {r} of {SHARD_RESUME_WORLD} differs")
            check(any(w.startswith(f"resuming a {SHARD_WORLD}-device job on "
                                   f"{SHARD_RESUME_WORLD} attached device(s): clamping")
                      for w in o["warned"]), f"14d: rank {r} did not warn: {o['warned']}")
            check(o["saves"] == ([5] if r == 0 else []), f"14d rank {r} wrote {o['saves']}")
        check(f0["world"] == SHARD_RESUME_WORLD and f0["resumed_from"] == SNAP_KILL_AT,
              "14d: the clamp or the resume point")
        log(f"  14d: resumed on {SHARD_RESUME_WORLD} ranks in {t_fewer:.1f} s, warned: "
            f"{f0['warned'][0][:60]}...")
        out["14d"] = {"killed_at": SNAP_KILL_AT, "resumed_same_world": "14b's bits",
                      "manifest_mesh": r0["manifest_mesh"], "steps_on_disk": r0["steps_on_disk"],
                      "fewer_ranks_vs_14b": within_phase3_tolerances(
                          "14d on 2 ranks against 14b", _as_run(f0, dev), b["fit"],
                          b["factors"], b["core"]),
                      "seconds_fewer": t_fewer}
        out["seconds"] = {"14a": t_a, "14b-d": t_four, "14d_fewer": t_fewer}
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    try:
        sys.exit(main())
    except Failure as exc:
        print(f"chip_smoke: FAILED: {exc}", file=sys.stderr)
        sys.exit(1)
