#!/usr/bin/env python3
"""Run the PyTorch/CUDA port (src/repro_torch) on one NVIDIA card and check it.

    python3 chip_smoke.py

Phases, each fatal on failure (the script exits nonzero and prints no
result line):

1. the card's name and power limit, and an ``nvcc`` build of every kernel
   from ``src/repro_torch/kernels/csrc``;
2. each kernel against its plain PyTorch version on the card, at odd small
   shapes and under both precisions;
3. ``tucker.decompose`` of a NELL-2-like tensor (1000^3, 24,000 nonzeros,
   ranks 16, 5 sweeps) on the card and on the CPU from the same factors;
4. the main path at the published size of FROSTT's NELL-2 tensor
   (12,092 x 9,184 x 28,818, 76,879,419 nonzeros; synthetic uniform
   coordinates, values uniform in [0.1, 10)), ranks (16, 16, 16), 5 sweeps:
   launch counts, per-sweep time, each kernel against its plain version at
   the path's own shapes under both precisions, and their times;
5. one JSON line per kernel set, then the device line.

Needs one CUDA card, ``nvcc`` (on PATH or under /usr/local/cuda), and the
checkout's ``src/`` beside this file. Imports nothing of JAX.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from functools import partial
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent

# H100 SXM peaks (NVIDIA data sheet): HBM bandwidth and f32 CUDA-core rate.
# Both kernels do their arithmetic in f32 on the CUDA cores, under either
# precision.
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_FLOPS = 67e12

NELL2_SHAPE = (12092, 9184, 28818)
NELL2_NNZ = 76_879_419
NELL2_RANKS = (16, 16, 16)
N_ITER = 5
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

    t0 = time.perf_counter()
    secs = _build.build_all(force=True)
    log(f"phase 1: built {sorted(secs)} in {time.perf_counter() - t0:.2f} s "
        f"(nvcc in parallel: " + ", ".join(f"{k} {v:.2f} s" for k, v in sorted(secs.items())) + ")")
    for name in _build.SOURCES:
        for line in (_build.BUILD_DIR / f"{name}.ptxas.log").read_text().splitlines():
            if "registers" in line or "spill" in line:
                log(f"  ptxas {name}: {line.strip()}")

    phase2_kernels(dev)
    phase3_mid(dev)
    kernels = phase4_nell2(dev, card)
    print(json.dumps({"kernels": kernels}), flush=True)
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


def compare(name: str, precision: str, got, want, n_terms: int) -> float:
    """Max abs error of ``got`` against ``want``, checked against TOL (see
    there); ``n_terms`` is the most terms summed into one output."""
    torch.cuda.synchronize()
    scale = float(want.abs().max()) if want.numel() else 0.0
    err = float((got - want).abs().max()) if want.numel() else 0.0
    tol = TOL[precision]
    if precision == "fp32":
        tol = max(tol, 4 * n_terms ** 0.5 * 2.0 ** -24)
    limit = tol * max(scale, 1e-30)
    ok = bool(torch.isfinite(got).all()) and err <= limit
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
           "busy_share": busy_ms / wall_ms if wall_ms else None,
           "top": [{"kernel": k[:90], "ms": ms, "count": n} for k, (ms, n) in top],
           "kernel_ms": {
               "fused_kron_scatter": sum(ms for k, (ms, _) in by_name.items()
                                         if "kron_scatter_kernel" in k),
               "ttm": sum(ms for k, (ms, _) in by_name.items()
                          if "ttm_partial_kernel" in k or "ttm_reduce_kernel" in k)}}
    log(f"  profile of a warm run: wall {wall_ms:.1f} ms, device busy {busy_ms:.1f} ms"
        + ("" if by_name else " (the profiler saw no device events)"))
    for row in out["top"]:
        log(f"    {row['ms']:9.3f} ms {row['count']:5d}x  {row['kernel']}")
    return out


def max_row_count(coo, mode) -> int:
    """The most nonzeros that share one mode-``mode`` coordinate: the most
    terms the unfolding sums into one output."""
    return int(torch.bincount(coo.indices[:, mode].long()).max()) if coo.nnz else 0


def schedule_of(coo, mode):
    from repro_torch.sparse.layout import DeviceSchedule, build_mode_layout

    return DeviceSchedule.from_layout(build_mode_layout(coo, mode))


# -- phase 2 -----------------------------------------------------------------


def phase2_kernels(dev) -> None:
    from repro_torch.core.coo import SparseCOO
    from repro_torch.kernels import kron_kernel, ops, ttm_kernel

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
    cases.append(("ranks 33x40, K over two CTAs", coo_of(
        shape, idx, rng.standard_normal(1000)), (4, 40, 33)))
    two = np.stack([rng.integers(0, 300, 900), rng.integers(0, 200, 900)], 1)
    cases.append(("2-way tensor", coo_of((300, 200), two, rng.standard_normal(900)), (6, 4)))
    for label, coo, ranks in cases:
        fs = [torch.randn(s, r, device=dev) for s, r in zip(coo.shape, ranks)]
        for mode in range(coo.ndim):
            sched = schedule_of(coo, mode)
            rows, vals = ops._gathered_block_rows(coo.indices, coo.values, fs, mode,
                                                  sched, coo.ndim)
            n_terms = max_row_count(coo, mode)
            for prec in ("fp32", "bf16_fp32acc"):
                got = synced(kron_kernel.fused_kron_scatter(
                    rows[0], rows[1], vals, sched, coo.shape[mode], precision=prec))
                want = synced(kron_kernel.fused_kron_scatter_plain(
                    rows[0], rows[1], vals, sched, coo.shape[mode], precision=prec))
                compare(f"fused_kron_scatter {label} mode {mode} "
                        f"({rows[0].shape[1]}x{rows[1].shape[1]})", prec, got, want, n_terms)
    for l_, i_, r_, transposed in ((15, 1000, 3, True), (256, 28818, 16, True),
                                   (100, 300, 17, False), (8, 8, 8, False)):
        if transposed:  # the path's views: y = Y_(N)^T, u = U_N^T
            y = torch.randn(i_, l_, device=dev).T
            u = torch.randn(i_, r_, device=dev).T
        else:
            y = torch.randn(l_, i_, device=dev)
            u = torch.randn(r_, i_, device=dev)
        for prec in ("fp32", "bf16_fp32acc"):
            compare(f"ttm y ({l_}, {i_}){' transposed' if transposed else ''} "
                    f"u ({r_}, {i_})", prec, synced(ttm_kernel.ttm(y, u, precision=prec)),
                    synced(ttm_kernel.ttm_plain(y, u, precision=prec)), i_)


# -- phase 3 -----------------------------------------------------------------


def phase3_mid(dev) -> None:
    from repro_torch import tucker
    from repro_torch.sparse.generators import random_sparse_tensor

    log("phase 3: card against CPU, NELL-2-like 1000^3, 24,000 nnz, ranks 16, 5 sweeps")
    coo = random_sparse_tensor((1000, 1000, 1000), 2.4e-5, seed=11, value_dist="uniform")
    rng = np.random.default_rng(SEED)
    f0 = [np.linalg.qr(rng.standard_normal((1000, 16)))[0].astype(np.float32)
          for _ in range(3)]
    res = {}
    for d in ("cuda", "cpu"):
        res[d] = tucker.decompose(coo, (16, 16, 16), n_iter=N_ITER, device=d,
                                  factors_init=[torch.from_numpy(f) for f in f0])
    cu, cp = res["cuda"], res["cpu"]
    torch.cuda.synchronize()
    check(cu.engine == "cuda" and cp.engine == "torch", f"engines {cu.engine}, {cp.engine}")
    hist_err = float(np.abs(cu.fit_history - cp.fit_history).max())
    proj_err = max(
        float((a.cpu() @ a.cpu().T - b @ b.T).abs().max())
        for a, b in zip(cu.factors, cp.factors)
    )
    log(f"  fit card {cu.fit_history.tolist()}")
    log(f"  fit cpu  {cp.fit_history.tolist()}")
    log(f"  fit history max diff {hist_err:.3e} <= 1e-4; projector UU^T max diff "
        f"{proj_err:.3e} <= 1e-3; card launches {cu.dispatches}")
    check(cu.fit_history.shape == cp.fit_history.shape and hist_err <= 1e-4,
          "card and CPU fit histories disagree")
    check(proj_err <= 1e-3, "card and CPU factor subspaces disagree")


# -- phase 4 -----------------------------------------------------------------


def synthetic_nell2(dev, seed: int):
    """Unique uniform coordinates at NELL-2's shape and nonzero count, values
    uniform in [0.1, 10) like ``repro.sparse.datasets.nell2_like``, drawn on
    the card from a seeded generator: sort-based dedup, no loop over the
    nonzeros. (The same steps in host numpy took 202 s on the shared host
    CPU of an H100 node.)"""
    g = torch.Generator(device=dev).manual_seed(seed)
    total = 1
    for s in NELL2_SHAPE:
        total *= s
    lin = torch.empty(0, dtype=torch.int64, device=dev)
    while lin.numel() < NELL2_NNZ:
        more = torch.randint(0, total, (NELL2_NNZ - lin.numel() + NELL2_NNZ // 1000 + 1024,),
                             generator=g, device=dev, dtype=torch.int64)
        lin = torch.unique(torch.cat([lin, more]))
    lin = lin[torch.randperm(lin.numel(), generator=g, device=dev)[:NELL2_NNZ]]
    idx = torch.empty((NELL2_NNZ, 3), dtype=torch.int32, device=dev)
    for k in (2, 1, 0):
        idx[:, k] = lin % NELL2_SHAPE[k]
        lin = lin // NELL2_SHAPE[k]
    vals = torch.rand(NELL2_NNZ, generator=g, device=dev) * 9.9 + 0.1
    return idx, vals


def phase4_nell2(dev, card: str):
    from repro_torch import tucker
    from repro_torch.core.coo import SparseCOO
    from repro_torch.kernels import kron_kernel, ops, ttm_kernel

    log(f"phase 4: NELL-2 size {NELL2_SHAPE}, {NELL2_NNZ} nnz, ranks {NELL2_RANKS}, "
        f"{N_ITER} sweeps")
    t0 = time.perf_counter()
    idx, vals = synthetic_nell2(dev, SEED)
    coo = SparseCOO.from_parts(idx, vals, NELL2_SHAPE)
    torch.cuda.synchronize()
    t_gen = time.perf_counter() - t0
    ix = coo.indices.long()
    lin = (ix[:, 0] * NELL2_SHAPE[1] + ix[:, 1]) * NELL2_SHAPE[2] + ix[:, 2]
    check(int(torch.unique(lin).numel()) == NELL2_NNZ, "synthetic coordinates are not unique")
    del ix, lin, idx, vals
    spec = tucker.TuckerSpec(shape=NELL2_SHAPE, ranks=NELL2_RANKS, n_iter=N_ITER)
    plan = tucker.plan(spec, device=dev)

    # the main path, cold: every count starts at 0 here and is read right after.
    torch.cuda.reset_peak_memory_stats()
    kron_kernel.fused_kron_scatter.launches = 0
    ttm_kernel.ttm.launches = 0
    t0 = time.perf_counter()
    res = tucker.decompose(coo, NELL2_RANKS, n_iter=N_ITER, device=dev)
    torch.cuda.synchronize()
    t_cold = time.perf_counter() - t0
    launches = {"fused_kron_scatter": kron_kernel.fused_kron_scatter.launches,
                "ttm": ttm_kernel.ttm.launches}
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    hist = res.fit_history
    log(f"  cold run: {t_cold:.3f} s, launches {launches}, schedule builds "
        f"{res.schedule_builds}, fit {hist.tolist()}")
    check(res.engine == "cuda", f"engine {res.engine}")
    check(launches["fused_kron_scatter"] == 3 * N_ITER and launches["ttm"] == N_ITER,
          f"main path launches {launches}, want {3 * N_ITER} and {N_ITER}")
    check(hist.shape == (N_ITER,) and bool(np.all(np.isfinite(hist)))
          and bool(np.all((hist >= 0) & (hist <= 1))), f"fit history {hist}")
    check(all(bool(torch.isfinite(f).all()) for f in res.factors)
          and bool(torch.isfinite(res.core).all()), "non-finite factors or core")
    check(tuple(res.core.shape) == NELL2_RANKS, f"core shape {tuple(res.core.shape)}")

    # warm run (schedules cached on the plan's engine): per-sweep time.
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    start.record()
    warm = plan(coo)
    end.record()
    end.synchronize()
    t_warm = time.perf_counter() - t0
    sweep_ms = start.elapsed_time(end) / N_ITER
    check(warm.schedule_builds == 0, "warm run rebuilt schedules")
    check(np.array_equal(warm.fit_history, hist), "warm run differs from the cold run")
    profile = profile_run(lambda: plan(coo))

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
        rows, v = ops._gathered_block_rows(coo.indices, coo.values, fs, mode, sched, 3)
        a, b = rows
        nnz_real = NELL2_NNZ
        n_terms = max_row_count(coo, mode)
        for p in TOL:
            ac, bc = kron_kernel._cast_operands(p, a, b)
            kern = partial(kron_kernel.fused_kron_scatter, ac, bc, v, sched, n_rows,
                           precision=p)
            plain = partial(kron_kernel.fused_kron_scatter_plain, ac, bc, v, sched, n_rows,
                            precision=p)
            got, want = synced(kern()), synced(plain())
            kron_err[p] = max(kron_err[p], compare(
                f"fused_kron_scatter NELL-2 mode {mode} ({a.shape[1]}x{b.shape[1]}, "
                f"{a.shape[0]} slots)", p, got, want, n_terms))
            if p == "fp32" and mode == 2:
                y_last = got
            k_ms, p_ms = time_ms(kern), time_ms(plain, reps=1)
            k = a.shape[1] * b.shape[1]
            nbytes = (ac.numel() * ac.element_size() + bc.numel() * bc.element_size()
                      + v.numel() * 4 + sched.rel_row.numel() * 4 + sched.blkmap.numel() * 4
                      + sched.parts.numel() * 8 + n_rows * k * 4)
            flops = 3 * nnz_real * k
            bound = max(nbytes / PEAK_BYTES_PER_S, flops / PEAK_F32_FLOPS) * 1e3
            kron_ms[p] += k_ms
            kron_plain_ms[p] += p_ms
            kron_bound[p] += bound
            if p == "fp32":
                kron_bytes, kron_flops = kron_bytes + nbytes, kron_flops + flops
            per_mode.append({"mode": mode, "precision": p, "ms": k_ms, "plain_ms": p_ms,
                             "bound_ms": bound, "bytes": nbytes, "flops": flops,
                             "parts": int(sched.parts.numel()) - 1})
            log(f"    mode {mode} [{p}]: kernel {k_ms:.3f} ms, plain {p_ms:.3f} ms, "
                f"bound {bound:.3f} ms ({nbytes / 1e9:.2f} GB, {flops / 1e9:.1f} GFLOP), "
                f"{int(sched.parts.numel()) - 1} CTAs")
        del a, b, rows, v, ac, bc

    u = fs[2]
    ttm_row = {}
    for p in TOL:
        yc, uc = y_last.T, u.T
        kern = partial(ttm_kernel.ttm, yc, uc, precision=p)
        plain = partial(ttm_kernel.ttm_plain, yc, uc, precision=p)
        err = compare(f"ttm NELL-2 y {tuple(yc.shape)} (transposed view) u "
                      f"{tuple(uc.shape)}", p, synced(kern()), synced(plain()), yc.shape[1])
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
            "bound_ms": max(nbytes / PEAK_BYTES_PER_S, flops / PEAK_F32_FLOPS) * 1e3,
            "bound_by": "bytes" if nbytes / PEAK_BYTES_PER_S >= flops / PEAK_F32_FLOPS
            else "operations",
            "max_abs_err": err,
        }
        log(f"    ttm [{p}]: {json.dumps(ttm_row[p])}")

    summary = {
        "card": card,
        "shape": NELL2_SHAPE, "nnz": NELL2_NNZ, "ranks": NELL2_RANKS, "n_iter": N_ITER,
        "setup_s": {"generate_on_card": t_gen,
                    "cold_decompose_incl_schedules": t_cold, "warm_decompose": t_warm},
        "sweep_ms": sweep_ms,
        "launches_per_sweep": {k: v / N_ITER for k, v in launches.items()},
        "kron_ms_per_sweep": kron_ms, "kron_plain_ms_per_sweep": kron_plain_ms,
        "kron_bound_ms_per_sweep": kron_bound, "kron_per_mode": per_mode,
        "ttm": ttm_row,
        "profile_warm_run": profile,
        "peak_memory_gb": peak_gb,
        "fit_history": hist.tolist(),
    }
    print(json.dumps(summary), flush=True)
    return [
        {"name": "fused_kron_scatter", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/kron_scatter.cu",
         "replaces": "src/repro/kernels/kron_kernel.py:306",
         "launches": launches["fused_kron_scatter"], "max_abs_err": kron_err["fp32"],
         "ms": kron_ms["fp32"], "plain_ms": kron_plain_ms["fp32"],
         "device_ms": profile["kernel_ms"]["fused_kron_scatter"] / N_ITER,
         "bound_ms": kron_bound["fp32"],
         "bound_by": ("bytes" if kron_bytes / PEAK_BYTES_PER_S >= kron_flops / PEAK_F32_FLOPS
                      else "operations"),
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


if __name__ == "__main__":
    try:
        sys.exit(main())
    except Failure as exc:
        print(f"chip_smoke: FAILED: {exc}", file=sys.stderr)
        sys.exit(1)
