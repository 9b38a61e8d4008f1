"""Probe kernel 5 (the fused core update) on one card, in every precision.

Checks ``fused_kron_scatter_ttm`` in fp32, bf16_fp32acc and float64 against
its plain version at odd shapes (``chip_smoke.py``'s rules: fp32
max(1e-5, 4 sqrt(n) 2^-24), bf16 2e-2 and no further than the plain version
from the f64 sum of the bf16-operand terms plus 2^-14, fp64 max(1e-13, 4
sqrt(n) 2^-53), each x max|plain| for n terms an output; the same bits on
two calls), then times it at NELL-2's last mode (12,092 x 9,184 x 28,818,
76,879,419 uniform nonzeros, ranks 16) in each precision beside the split
core update (kernel 1, then kernel 2) of the same precision: CUDA events a
call and the profiler's device time a call. Prints the card's name and
power limit, then one JSON line with the launch shape (threads, shared
bytes, registers where the tree reports them, CTAs an SM) and the tensor-core
instructions in each instantiation's SASS; exits non-zero when a check
fails. Needs a card and ``nvcc``.

    python3 tools/probe_kernel5.py [--src DIR] [--label NAME]

``--src`` picks the ``repro_torch`` tree (default: this checkout's
``src/``), so that two trees can be compared on one card in turns. Builds
only kernels 1, 2 and 5 (into the tree's ``build/kernels``).
"""
from __future__ import annotations

import argparse
import json
import os
import re
import subprocess
import sys
import time
from pathlib import Path

os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF", "expandable_segments:True")

import numpy as np  # noqa: E402
import torch  # noqa: E402

SHAPE, NNZ, RANKS = (12092, 9184, 28818), 76_879_419, (16, 16, 16)
ODD = [((50, 40, 30), (4, 3, 5), 1000), ((300, 200, 100), (16, 16, 16), 20_000),
       ((100, 80, 60), (13, 17, 10), 5000), ((70, 60, 50), (2, 1, 17), 3000),
       ((40, 30, 20), (17, 9, 11), 2500), ((60, 50), (7, 5), 700)]
PRECISIONS = (("fp32", torch.float32, "fp32"), ("bf16", torch.float32, "bf16_fp32acc"),
              ("f64", torch.float64, "fp32"))
SOURCES = ("kron_scatter", "ttm", "kron_scatter_ttm")


def rule(label: str, n: int) -> float:
    return {"fp32": max(1e-5, 4 * n ** 0.5 * 2.0 ** -24), "bf16": 2e-2,
            "f64": max(1e-13, 4 * n ** 0.5 * 2.0 ** -53)}[label]


def events_ms(fn, reps: int) -> float:
    fn()
    times = []
    for _ in range(reps):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return sorted(times)[len(times) // 2]


def device_ms(fn, name: str, reps: int = 5) -> float:
    """Profiler time a call of the device kernels whose name holds
    ``name``, summed over ``reps`` calls."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    got = [ev.time_range.elapsed_us() / 1e3 for ev in prof.events()
           if ev.device_type == DeviceType.CUDA and name in ev.name]
    return sum(got) / reps if got else float("nan")


def build() -> dict:
    """Compile kernels 1, 2 and 5 of the tree where missing, all at once."""
    from repro_torch.kernels import _build

    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs, t0 = {}, time.perf_counter()
    for name in SOURCES:
        path = _build.library_path(name)
        if not path.exists():
            procs[name] = subprocess.Popen(
                [_build.nvcc(), *_build.NVCC_FLAGS, "-o", str(path),
                 str(_build.CSRC / f"{name}.cu")],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    out = {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            sys.exit(f"probe_kernel5: nvcc failed for {name}:\n{log}")
        out[name] = {"s": time.perf_counter() - t0,
                     "ptxas": [line.strip() for line in log.splitlines()
                               if "registers" in line or "spill" in line]}
    return out


def sass_counts() -> dict:
    """Tensor-core instructions of kernel 5's first pass, by element type."""
    from repro_torch.kernels import _build

    tool = Path(_build.nvcc()).parent / "cuobjdump"
    sass = subprocess.run([str(tool), "-sass", str(_build.library_path("kron_scatter_ttm"))],
                          capture_output=True, text=True, check=True).stdout
    counts, key = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            m = re.search(r"kron_scatter_ttm_kernelI(d|f|13__nv_bfloat16)", line)
            key = {"d": "f64", "f": "fp32", "13__nv_bfloat16": "bf16"}[m.group(1)] if m else None
            if key:
                counts[key] = {"DMMA": 0, "HMMA.TF32": 0, "HMMA.BF16": 0}
        elif key:
            op = re.search(r"\s(DMMA|HMMA)(\.\S*)?", line)
            if op and op.group(1) == "DMMA":
                counts[key]["DMMA"] += 1
            elif op:
                for kind in ("TF32", "BF16"):
                    if f".{kind}" in (op.group(2) or ""):
                        counts[key][f"HMMA.{kind}"] += 1
    return counts


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--src", default=str(Path(__file__).resolve().parents[1] / "src"))
    ap.add_argument("--label", default="")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("probe_kernel5: no card", file=sys.stderr)
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
    out = {"label": args.label or args.src, "build": build(), "sass": sass_counts()}
    failures = []

    def factors(fs, mode):
        m = operand_modes(len(fs), mode)
        return fs[m[0]], (fs[m[1]] if len(m) > 1 else None)

    def check(name, label, got, again, want, n, exact=None):
        scale = float(want.abs().max())
        err = float((got.double() - want.double()).abs().max())
        ok = bool(torch.isfinite(got).all()) and err <= rule(label, n) * scale
        ok = ok and torch.equal(got, again)
        if exact is not None:  # bf16: no further from the exact sum than the plain version
            d_got = float((got.double() - exact).abs().max())
            d_plain = float((want.double() - exact).abs().max())
            ok = ok and d_got <= d_plain + 2.0 ** -14 * float(exact.abs().max())
        if not ok:
            failures.append(f"{name} [{label}]: err {err:.3e} of max|plain| {scale:.3e}")
        return err / (rule(label, n) * max(scale, 1e-30))

    def exact_of(fa, fb, u, sched, n_rows):
        y = kron_kernel.fused_kron_scatter_plain(
            fa.bfloat16().double(), None if fb is None else fb.bfloat16().double(), sched,
            n_rows)
        return u.bfloat16().double().T @ y

    rng = np.random.default_rng(35)
    worst = {label: 0.0 for label, _, _ in PRECISIONS}
    for shape, ranks, nnz in ODD:
        idx = np.stack([rng.integers(0, s, nnz) for s in shape], 1)
        idx = np.concatenate([idx, idx[:nnz // 5]]).astype(np.int32)
        vals = rng.standard_normal(idx.shape[0])
        f64 = [np.linalg.qr(rng.standard_normal((s, r)))[0] for s, r in zip(shape, ranks)]
        for label, dtype, precision in PRECISIONS:
            coo = SparseCOO.from_parts(idx, vals.astype(np.float64 if label == "f64" else
                                                        np.float32), shape, device=dev)
            fs = [torch.tensor(f, dtype=dtype, device=dev) for f in f64]
            for mode in range(len(shape)):
                sched = DeviceSchedule.from_layout(build_mode_layout(coo, mode), coo)
                fa, fb = factors(fs, mode)
                call = lambda: kron_kernel.fused_kron_scatter_ttm(  # noqa: E731
                    fa, fb, fs[mode], sched, shape[mode], precision=precision)
                got, again = call(), call()
                want = kron_kernel.fused_kron_scatter_ttm_plain(fa, fb, fs[mode], sched,
                                                                shape[mode], precision=precision)
                exact = exact_of(fa, fb, fs[mode], sched, shape[mode]) if label == "bf16" else None
                worst[label] = max(worst[label], check(f"kernel 5 {shape} {ranks} mode {mode}",
                                                       label, got, again, want, coo.nnz, exact))
    out["odd_worst_over_limit"] = worst
    torch.cuda.synchronize()
    if failures:
        out["failures"] = failures
        print(json.dumps(out))
        return 1

    # NELL-2's shapes: uniform coordinates drawn on the card, its last mode
    g = torch.Generator(device=dev).manual_seed(0)
    total = SHAPE[0] * SHAPE[1] * SHAPE[2]
    lin = torch.unique(torch.randint(0, total, (NNZ + NNZ // 1000 + 1024,), generator=g,
                                     device=dev))
    lin = lin[torch.randperm(lin.numel(), generator=g, device=dev)[:NNZ]]
    idx = torch.empty((lin.numel(), 3), dtype=torch.int32, device=dev)
    for k in (2, 1, 0):
        idx[:, k] = lin % SHAPE[k]
        lin = lin // SHAPE[k]
    del lin
    vals = torch.rand(idx.shape[0], generator=g, device=dev) * 9.9 + 0.1
    f64 = [torch.linalg.qr(torch.randn(s, r, generator=g, device=dev, dtype=torch.float64))[0]
           for s, r in zip(SHAPE, RANKS)]
    mode, nell = 2, {}
    for label, dtype, precision in PRECISIONS:
        coo = SparseCOO(idx, vals.to(dtype), SHAPE)
        fs = [f.to(dtype).contiguous() for f in f64]
        sched = DeviceSchedule.from_layout(build_mode_layout(coo, mode), coo)
        fa, fb = factors(fs, mode)
        u = fs[mode]
        kind = kron_kernel._kind(torch.bfloat16 if label == "bf16" else dtype)
        per16 = 16 // {0: 4, 1: 2, 2: 8}[kind]
        grid = kron_kernel.mega_grid(dev, 16, 16, -(-16 // per16) * per16,
                                     -(-16 // per16) * per16, 16, kind,
                                     int(sched.parts.numel()) - 1)
        call = lambda: kron_kernel.fused_kron_scatter_ttm(  # noqa: E731
            fa, fb, u, sched, SHAPE[mode], precision=precision)
        split = lambda: ttm_kernel.ttm(  # noqa: E731
            kron_kernel.fused_kron_scatter(fa, fb, sched, SHAPE[mode], precision=precision).T,
            u.T, precision=precision).T
        got, again = call(), call()
        want = kron_kernel.fused_kron_scatter_ttm_plain(fa, fb, u, sched, SHAPE[mode],
                                                        precision=precision)
        exact = exact_of(fa, fb, u, sched, SHAPE[mode]) if label == "bf16" else None
        share = check("kernel 5 NELL-2 mode 2", label, got, again, want, NNZ, exact)
        del want, exact
        row = {"grid": grid, "share_of_limit": share}
        for turn in ("kernel5", "split", "kernel5_again", "split_again"):
            row[f"{turn}_ms"] = events_ms(call if turn.startswith("kernel5") else split, 5)
        row["kernel5_device_ms"] = device_ms(call, "kron_scatter_ttm")  # both passes
        nell[label] = row
        del coo, sched, fs, got, again
        torch.cuda.empty_cache()
    out["nell2_mode2"] = nell
    if failures:
        out["failures"] = failures
    print(json.dumps(out))
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
