"""Probe kernels 1 and 2 in float64 on one card.

Checks kernel 1 (``fused_kron_scatter``) and kernel 2 (``ttm``) in f64
against their plain versions at odd shapes (the fp64 rule of
``chip_smoke.py``: max(1e-13, 4 sqrt(n) 2^-53) x max|plain| for n terms an
output; the same bits on two calls), then times them at NELL-2's shapes
(12,092 x 9,184 x 28,818, 76,879,419 uniform nonzeros, ranks 16): kernel 1
a mode, kernel 2 on the last unfolding with and without an L2 flush beside
``torch.matmul``, its device time by the profiler and its host time a call.

    python3 tools/probe_f64.py [--src DIR] [--label NAME] [--ttm-anatomy]

``--src`` picks the ``repro_torch`` tree (default: this checkout's
``src/``), so that two trees can be compared on one card in turns;
``--ttm-anatomy`` adds kernel 2's and ``torch.matmul``'s device time a call
against the contraction length I (L = 256, R = 16: the intercept is what a
call costs besides streaming its bytes) and a ``cProfile`` of the wrapper's
host time. Prints the card's name and power limit, then one JSON line;
exits non-zero when a check fails. Needs a card and ``nvcc``.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys
import time
from pathlib import Path

os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF", "expandable_segments:True")

import numpy as np  # noqa: E402
import torch  # noqa: E402

SHAPE, NNZ, RANKS = (12092, 9184, 28818), 76_879_419, (16, 16, 16)
ODD = [((50, 40, 30), (4, 3, 5), 1000), ((300, 200, 100), (16, 16, 16), 20_000),
       ((100, 80, 60), (13, 22, 10), 5000), ((70, 60, 50), (2, 33, 40), 3000),
       ((60, 50), (7, 5), 700)]
TTM_ODD = [(256, 5000, 16, True), (300, 1000, 20, False), (7, 33, 3, False),
           (256, 28818, 16, True)]


def fp64_ok(got, want, n_terms: int) -> tuple:
    scale = float(want.abs().max())
    err = float((got - want).abs().max())
    limit = max(1e-13, 4 * n_terms ** 0.5 * 2.0 ** -53) * max(scale, 1e-30)
    return err, limit, bool(torch.isfinite(got).all()) and err <= limit


def events_ms(fn, reps: int, flush: bool = False) -> float:
    junk = torch.empty(64 << 20, dtype=torch.uint8, device="cuda") if flush else None
    fn()
    times = []
    for _ in range(reps):
        if junk is not None:
            junk.zero_()
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return sorted(times)[len(times) // 2]


def device_ms(fn, name: str, reps: int = 20, flush: bool = True) -> float:
    """Median profiler time of the device kernels whose name holds ``name``,
    one ``fn`` call at a time (L2 flushed before each)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    junk = torch.empty(64 << 20, dtype=torch.uint8, device="cuda") if flush else None
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            if junk is not None:
                junk.zero_()
            fn()
        torch.cuda.synchronize()
    got = [ev.time_range.elapsed_us() / 1e3 for ev in prof.events()
           if ev.device_type == DeviceType.CUDA and name in ev.name]
    return sorted(got)[len(got) // 2] if got else float("nan")


def device_ms_all(fn, reps: int = 20) -> float:
    """Device time a call of ``fn``, every kernel it launches summed
    (profiler), L2 flushed before each call (the flush's own kernel left
    out)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    junk = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            junk.zero_()
            fn()
        torch.cuda.synchronize()
    return sum(ev.time_range.elapsed_us() / 1e3 for ev in prof.events()
               if ev.device_type == DeviceType.CUDA
               and not any(w in ev.name for w in ("Memset", "fill", "FillFunctor"))) / reps


def ttm_anatomy(dev) -> dict:
    import cProfile
    import io
    import pstats

    from repro_torch.kernels import ttm_kernel

    out = {"by_I": []}
    g = torch.Generator(device=dev).manual_seed(1)
    for n_i in (3600, 7200, 14400, 28818, 57636, 115272):
        y = torch.randn(n_i, 256, generator=g, device=dev, dtype=torch.float64).T
        u = torch.randn(n_i, 16, generator=g, device=dev, dtype=torch.float64).T
        out["by_I"].append({"I": n_i, "bytes": (256 + 16) * n_i * 8,
                            "ttm_device_ms": device_ms_all(lambda: ttm_kernel.ttm(y, u)),
                            "matmul_device_ms": device_ms_all(lambda: torch.matmul(y, u.T)),
                            "ttm_events_ms": events_ms(lambda: ttm_kernel.ttm(y, u), 20, True),
                            "matmul_events_ms": events_ms(lambda: torch.matmul(y, u.T), 20,
                                                          True)})
    y = torch.randn(28818, 256, device=dev, dtype=torch.float64).T
    u = torch.randn(28818, 16, device=dev, dtype=torch.float64).T
    prof = cProfile.Profile()
    prof.enable()
    for _ in range(2000):
        ttm_kernel.ttm(y, u)
    prof.disable()
    torch.cuda.synchronize()
    text = io.StringIO()
    pstats.Stats(prof, stream=text).sort_stats("tottime").print_stats(14)
    out["cprofile_2000_calls"] = text.getvalue().splitlines()[-24:]
    return out


def build() -> dict:
    """Compile kernels 1 and 2 alone (the other sources are not needed) and
    load them; returns seconds and ptxas lines."""
    from repro_torch.kernels import _build

    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs, t0 = {}, time.perf_counter()
    for name in ("kron_scatter", "ttm"):
        path = _build.library_path(name)
        procs[name] = (path, subprocess.Popen(
            [_build.nvcc(), *_build.NVCC_FLAGS, "-o", str(path), str(_build.CSRC / f"{name}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    out = {}
    for name, (path, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            sys.exit(f"probe_f64: nvcc failed for {name}:\n{log}")
        regs = [line.strip() for line in log.splitlines() if "registers" in line]
        out[name] = {"s": time.perf_counter() - t0, "ptxas": regs, "lib": str(path)}
        _build._LIBS[name] = ctypes.CDLL(str(path))
    return out


def sass_counts(lib: str) -> dict:
    from repro_torch.kernels import _build

    tool = Path(_build.nvcc()).parent / "cuobjdump"
    sass = subprocess.run([str(tool), "-sass", lib], capture_output=True, text=True,
                          check=True).stdout
    counts, key = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            key = line.split("Function :", 1)[1].strip()
            counts[key] = {"DMMA": 0, "HMMA": 0, "DFMA": 0}
        elif key:
            for op in counts[key]:
                if f" {op}." in line or f" {op} " in line:
                    counts[key][op] += 1
    return counts


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--src", default=str(Path(__file__).resolve().parents[1] / "src"))
    ap.add_argument("--label", default="")
    ap.add_argument("--ttm-anatomy", action="store_true")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("probe_f64: no card", file=sys.stderr)
        return 1
    sys.path.insert(0, str(Path(args.src).resolve()))
    from repro_torch.core.coo import SparseCOO
    from repro_torch.kernels import kron_kernel, ttm_kernel
    from repro_torch.sparse.layout import DeviceSchedule, build_mode_layout, operand_modes

    torch.backends.cuda.matmul.allow_tf32 = False
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True).stdout
    print(card.strip().splitlines()[0] if card.strip() else "nvidia-smi unavailable")
    dev = torch.device("cuda", 0)
    out = {"label": args.label or args.src, "build": build()}
    out["sass"] = {name: {k: v for k, v in sass_counts(info["lib"]).items()
                          if "IdL" in k or "ttm_kernelId" in k}
                   for name, info in out["build"].items()}
    if hasattr(kron_kernel, "occupancy"):  # trees before the DMMA routes have none
        out["occupancy_kernel1_f64"] = kron_kernel.occupancy(dev, 16, 16, torch.float64)
    if hasattr(ttm_kernel, "occupancy"):
        out["occupancy_kernel2_f64"] = ttm_kernel.occupancy(dev, torch.float64)
    failures = []

    def schedule(coo, mode):
        return DeviceSchedule.from_layout(build_mode_layout(coo, mode), coo)

    def factors(fs, mode):
        m = operand_modes(len(fs), mode)
        return fs[m[0]], (fs[m[1]] if len(m) > 1 else None)

    # odd shapes: kernel 1 f64 against its plain version, twice for its bits
    rng = np.random.default_rng(15)
    worst = 0.0
    for shape, ranks, nnz in ODD:
        idx = np.stack([rng.integers(0, s, nnz) for s in shape], 1)
        idx = np.concatenate([idx, idx[:nnz // 5]])
        coo = SparseCOO.from_parts(idx.astype(np.int32), rng.standard_normal(idx.shape[0]),
                                   shape, device=dev)
        fs = [torch.tensor(np.linalg.qr(rng.standard_normal((s, r)))[0], device=dev)
              for s, r in zip(shape, ranks)]
        for mode in range(len(shape)):
            sched = schedule(coo, mode)
            fa, fb = factors(fs, mode)
            got = kron_kernel.fused_kron_scatter(fa, fb, sched, shape[mode])
            again = kron_kernel.fused_kron_scatter(fa, fb, sched, shape[mode])
            want = kron_kernel.fused_kron_scatter_plain(fa, fb, sched, shape[mode])
            n = int(torch.bincount(coo.indices[:, mode].long()).max())
            err, limit, ok = fp64_ok(got, want, n)
            worst = max(worst, err / limit)
            if not ok or not torch.equal(got, again):
                failures.append(f"kernel 1 {shape} {ranks} mode {mode}: err {err:.3e} "
                                f"limit {limit:.3e} same bits {torch.equal(got, again)}")
    out["kernel1_odd_worst_over_limit"] = worst
    worst = 0.0
    for n_l, n_i, n_r, transposed in TTM_ODD:
        if transposed:
            y = torch.tensor(rng.standard_normal((n_i, n_l)), device=dev).T
            u = torch.tensor(rng.standard_normal((n_i, n_r)), device=dev).T
        else:
            y = torch.tensor(rng.standard_normal((n_l, n_i)), device=dev)
            u = torch.tensor(rng.standard_normal((n_r, n_i)), device=dev)
        got, again = ttm_kernel.ttm(y, u), ttm_kernel.ttm(y, u)
        err, limit, ok = fp64_ok(got, ttm_kernel.ttm_plain(y, u), n_i)
        worst = max(worst, err / limit)
        if not ok or not torch.equal(got, again):
            failures.append(f"kernel 2 ({n_l}, {n_i}, {n_r}) transposed {transposed}: err "
                            f"{err:.3e} limit {limit:.3e} same bits {torch.equal(got, again)}")
    out["kernel2_odd_worst_over_limit"] = worst
    torch.cuda.synchronize()
    if failures:
        out["failures"] = failures
        print(json.dumps(out))
        return 1

    # NELL-2's shapes: uniform coordinates drawn on the card
    g = torch.Generator(device=dev).manual_seed(0)
    total = SHAPE[0] * SHAPE[1] * SHAPE[2]
    lin = torch.unique(torch.randint(0, total, (NNZ + NNZ // 1000 + 1024,), generator=g,
                                     device=dev))
    lin = lin[torch.randperm(lin.numel(), generator=g, device=dev)[:NNZ]]
    idx = torch.empty((lin.numel(), 3), dtype=torch.int32, device=dev)
    for k in (2, 1, 0):
        idx[:, k] = lin % SHAPE[k]
        lin = lin // SHAPE[k]
    coo = SparseCOO(idx, (torch.rand(idx.shape[0], generator=g, device=dev) * 9.9 + 0.1)
                    .double(), SHAPE)
    del lin
    fs = [torch.linalg.qr(torch.randn(s, r, generator=g, device=dev, dtype=torch.float64))[0]
          .contiguous() for s, r in zip(SHAPE, RANKS)]
    k1 = []
    y_last = None
    for mode in range(3):
        sched = schedule(coo, mode)
        fa, fb = factors(fs, mode)
        run = lambda: kron_kernel.fused_kron_scatter(fa, fb, sched, SHAPE[mode])  # noqa: E731
        ms = events_ms(run, 3)
        k1.append(ms)
        if mode == 2:
            y_last = run()
            want = kron_kernel.fused_kron_scatter_plain(fa, fb, sched, SHAPE[mode])
            n = int(torch.bincount(coo.indices[:, mode].long()).max())
            err, limit, ok = fp64_ok(y_last, want, n)
            out["kernel1_nell2_mode2"] = {"err": err, "limit": limit, "ok": ok}
            if not ok:
                failures.append(f"kernel 1 NELL-2 mode 2: err {err:.3e} limit {limit:.3e}")
            del want
        del sched
    out["kernel1_nell2_ms_by_mode"] = k1
    out["kernel1_nell2_ms_sweep"] = sum(k1)
    yc, uc = y_last.T, fs[2].T
    run2 = lambda: ttm_kernel.ttm(yc, uc)  # noqa: E731
    mm = lambda: torch.matmul(yc, uc.T)  # noqa: E731
    k2 = {}
    for label, fn in (("ttm", run2), ("matmul", mm), ("ttm_again", run2), ("matmul_again", mm)):
        k2[label] = {"ms_flushed": events_ms(fn, 20, flush=True),
                     "ms_warm": events_ms(fn, 20)}
    k2["ttm_device_ms_flushed"] = device_ms(run2, "ttm_kernel")
    k2["ttm_device_ms_warm"] = device_ms(run2, "ttm_kernel", flush=False)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(200):
        run2()
    host = (time.perf_counter() - t0) / 200 * 1e3
    torch.cuda.synchronize()
    k2["ttm_host_ms_a_call_enqueued"] = host
    k2["ttm_back_to_back_ms"] = (time.perf_counter() - t0) / 200 * 1e3
    want = ttm_kernel.ttm_plain(yc, uc)
    err, limit, ok = fp64_ok(run2(), want, yc.shape[1])
    k2["err"], k2["limit"] = err, limit
    if not ok:
        failures.append(f"kernel 2 NELL-2: err {err:.3e} limit {limit:.3e}")
    out["kernel2_nell2"] = k2
    if args.ttm_anatomy:
        del coo, fs, y_last, yc, uc, want
        torch.cuda.empty_cache()
        out["ttm_anatomy"] = ttm_anatomy(dev)
    if failures:
        out["failures"] = failures
    print(json.dumps(out))
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
