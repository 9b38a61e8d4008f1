"""Cross-pod gradient sync, raw against QRP-compressed, over a process group.

Port of ``repro.launch.compress_bench``. The reference lowers both syncs for
a 2x16x16 TPU mesh and reads the pod-crossing collective bytes from the
partitioned HLO. One card has no such mesh and no HLO, so here the "pod"
axis is a ``torch.distributed`` group of ``WORLD`` = 2 ranks (the
reference's pod axis has 2), each holding its own gradients of the
config's layer-stacked weight matrices (:func:`grad_matrices`), and the two
syncs run:

  raw:        every G averaged over the group (``all_reduce_mean``)
  compressed: Q, P = compress_matrix(G, r) (the paper's QRP), Q and P
              averaged over the group, G_hat = Q P^T

Each rank counts the bytes it hands to ``all_reduce``; they must equal the
model exactly: 4 m n a matrix raw, 4 r (m + n) compressed with
r = min(rank, m, n). The reference's ``analytic_reduction`` counts r = rank
for every matrix, as its own model does. Both syncs are timed, with CUDA
events on the card and the host clock on the CPU, each after a barrier:
one untimed warm-up run of each, then ``REPEATS`` timed runs in turns,
reported as the median over every rank's runs beside the runs. Every output must be finite, and every
rank must hold the same bits of each G_hat (a digest of its bits). The
gradients are seeded (:func:`seeded_gradient`): rank ``rank`` plus noise,
full rank, as a gradient's decaying spectrum is.

On the card the two ranks share one card over gloo (NCCL refuses two ranks
on one device), or take one card each over NCCL where there are two. The
result holds the reference's keys (``coll_bytes`` of each sync,
``reduction``, ``analytic_reduction``, ``rank``) with the times and the
checks, written to ``--out``; a failed check exits nonzero.

  python -m repro_torch.launch.compress_bench --rank 64 --arch granite-moe-1b-a400m
  python -m repro_torch.launch.compress_bench --smoke --rank 8 --device cpu
"""
from __future__ import annotations

import argparse
import datetime
import hashlib
import json
import math
import os
import statistics
import tempfile
import time
from pathlib import Path
from typing import Any, List, Sequence, Tuple

import torch
import torch.distributed as dist

from repro_torch.base import resolve_device
from repro_torch.configs import get_config
from repro_torch.models import model as model_lib
from repro_torch.optim.compression import all_reduce_mean, compress_matrix, decompress_matrix

SEED = 20
WORLD = 2  # ranks of the slow group
REPEATS = 1  # timed runs of each sync a rank, after one untimed warm-up
NOISE = 1e-2  # the full-rank noise beside a gradient's rank-r part, per entry
GROUP_TIMEOUT_S = 600
_DIGEST_CHUNK = 1 << 24


def grad_matrices(cfg) -> List[Tuple[str, int, int]]:
    """The layer-stacked weight grads of the config, as (name, m, n) mats
    (leading dims collapsed): what crosses the pod axis every step."""
    shapes = model_lib.param_shapes(cfg)["layers"]
    mats = []
    for name, leaf in shapes.items():
        if leaf.dim() >= 2:
            mats.append((name, math.prod(leaf.shape[:-1]), int(leaf.shape[-1])))
    return mats


def compressed_rank(rank: int, m: int, n: int) -> int:
    return min(rank, m, n)


def model_bytes(mats: Sequence[Tuple[str, int, int]], rank: int) -> dict:
    """The f32 bytes one rank hands to ``all_reduce`` in each sync."""
    return {"raw": 4 * sum(m * n for _, m, n in mats),
            "qrp_compressed": 4 * sum(compressed_rank(rank, m, n) * (m + n) for _, m, n in mats)}


def analytic_reduction(mats: Sequence[Tuple[str, int, int]], rank: int) -> float:
    """The reference's r (m + n) model, r = rank for every matrix."""
    return sum(m * n for _, m, n in mats) / sum(rank * (m + n) for _, m, n in mats)


def seeded_gradient(m: int, n: int, rank: int, seed: int, device) -> torch.Tensor:
    """An (m, n) f32 gradient of rank min(rank, m, n) with entries ~N(0, 1),
    plus ``NOISE`` x N(0, 1) noise (full rank: the QRP's Gram step needs
    it), from a generator on ``device`` seeded with ``seed``."""
    dev = torch.device(device)
    g = torch.Generator(device=dev).manual_seed(seed)
    r = compressed_rank(rank, m, n)
    left = torch.randn((m, r), generator=g, device=dev)
    right = torch.randn((r, n), generator=g, device=dev)
    out = (left @ right).mul_(1.0 / math.sqrt(r))
    del left, right
    return out.add_(torch.randn((m, n), generator=g, device=dev), alpha=NOISE)


def bits_digest(t: torch.Tensor) -> str:
    """A digest of ``t``'s bits, computed on its device: the int32 words in
    chunks, each chunk's sum and position-weighted sum in int64."""
    words = t.detach().contiguous().view(-1).view(torch.int32)
    h = hashlib.sha256()
    for s in range(0, words.numel(), _DIGEST_CHUNK):
        w = words[s:s + _DIGEST_CHUNK].to(torch.int64)
        pos = torch.arange(1, w.numel() + 1, device=w.device, dtype=torch.int64)
        h.update(f"{int(w.sum())},{int((w * pos).sum())};".encode())
    return h.hexdigest()


def _timed(fn, dev: torch.device, group: Any) -> Tuple[Any, float]:
    """``fn()`` and its milliseconds, after a barrier over ``group``."""
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    if dist.is_initialized():
        dist.barrier(group=group)
    if dev.type == "cuda":
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        out = fn()
        end.record()
        end.synchronize()
        return out, start.elapsed_time(end)
    t0 = time.perf_counter()
    out = fn()
    return out, (time.perf_counter() - t0) * 1e3


def raw_sync(grads: Sequence[torch.Tensor], group: Any = None):
    """Every gradient averaged over ``group``: (outputs, bytes handed to
    ``all_reduce``)."""
    sent = sum(g.numel() * g.element_size() for g in grads)
    return [all_reduce_mean(g, group) for g in grads], sent


def compressed_sync(grads: Sequence[torch.Tensor], rank: int, group: Any = None):
    """Each gradient compressed, Q and P averaged over ``group``, then
    decompressed: (outputs, bytes handed to ``all_reduce``)."""
    outs, sent = [], 0
    for g in grads:
        q, p = compress_matrix(g, rank)
        sent += q.numel() * q.element_size() + p.numel() * p.element_size()
        outs.append(decompress_matrix(all_reduce_mean(q, group), all_reduce_mean(p, group)))
    return outs, sent


def run_rank(mats: Sequence[Tuple[str, int, int]], rank: int, device, group: Any = None,
             repeats: int = REPEATS) -> dict:
    """One rank's part of the bench in an initialised group (or alone): its
    seeded gradients, both syncs once untimed, then ``repeats`` times each,
    in turns; the bytes it handed to ``all_reduce``, the ms of each timed
    run, whether every output was finite and the digest of each compressed
    output."""
    dev = resolve_device(device)
    me = dist.get_rank(group) if dist.is_initialized() else 0
    grads = [seeded_gradient(m, n, rank, SEED + 1000 * me + i, dev)
             for i, (_, m, n) in enumerate(mats)]
    out = {"rank_in_group": me, "device": str(dev),
           "device_name": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
           "ms": {"raw": [], "qrp_compressed": []}, "bytes": {}, "finite": True}
    for turn in range(-1, max(1, repeats)):  # turn -1: the warm-up
        for name in ("raw", "qrp_compressed") if turn % 2 == 0 else ("qrp_compressed", "raw"):
            fn = ((lambda: raw_sync(grads, group)) if name == "raw"
                  else (lambda: compressed_sync(grads, rank, group)))
            (outs, sent), ms = _timed(fn, dev, group)
            if turn >= 0:
                out["ms"][name].append(ms)
            out["bytes"][name] = sent
            out["finite"] = out["finite"] and all(bool(torch.isfinite(o).all()) for o in outs)
            if name == "qrp_compressed":
                out["digests"] = [bits_digest(o) for o in outs]
            del outs
    return out


def summarize(reports: Sequence[dict], mats: Sequence[Tuple[str, int, int]], rank: int) -> dict:
    """The bench's result from every rank's :func:`run_rank` report, with
    its checks: every output finite, each rank's bytes the model's exactly,
    every rank the same compressed bits. ``ok`` is their conjunction."""
    want = model_bytes(mats, rank)
    res = {"rank": rank, "world": len(reports), "device": reports[0]["device"],
           "device_name": reports[0]["device_name"],
           "matrices": [{"name": n, "m": m, "n": k, "r": compressed_rank(rank, m, k)}
                        for n, m, k in mats]}
    for name in ("raw", "qrp_compressed"):
        runs = [ms for r in reports for ms in r["ms"][name]]
        res[name] = {"coll_bytes": reports[0]["bytes"][name], "model_bytes": want[name],
                     "ms": statistics.median(runs), "ms_runs": runs}
    res["reduction"] = res["raw"]["coll_bytes"] / max(res["qrp_compressed"]["coll_bytes"], 1)
    res["analytic_reduction"] = analytic_reduction(mats, rank)
    res["checks"] = {
        "finite": all(r["finite"] for r in reports),
        "bytes_match_model": all(r["bytes"] == want for r in reports),
        "same_bits_on_every_rank": all(r["digests"] == reports[0]["digests"] for r in reports),
    }
    res["ok"] = all(res["checks"].values())
    return res


def _rank_main(rank: int, world: int, backend: str, store: str, tmp: str, args: dict) -> None:
    """A spawned rank: join the group, run :func:`run_rank`, write its report."""
    dev = torch.device(args["device"])
    if dev.type == "cuda":
        dev = torch.device("cuda", rank if backend == "nccl" else 0)
        torch.cuda.set_device(dev)
    kw = {"device_id": dev} if backend == "nccl" else {}
    dist.init_process_group(backend, store=dist.FileStore(store, world), rank=rank,
                            world_size=world,
                            timeout=datetime.timedelta(seconds=GROUP_TIMEOUT_S), **kw)
    try:
        mats = grad_matrices(get_config(args["arch"], smoke=args["smoke"]))
        report = run_rank(mats, args["rank"], dev)
        Path(tmp, f"rank{rank}.json").write_text(json.dumps(report))
    finally:
        dist.destroy_process_group()


def bench(arch: str, rank: int, *, device="cuda", smoke: bool = False) -> dict:
    """Spawn ``WORLD`` ranks (gloo, or NCCL where there is a card for each),
    run the bench and return :func:`summarize`'s result."""
    import torch.multiprocessing as mp

    dev = resolve_device(device)
    backend = "nccl" if dev.type == "cuda" and torch.cuda.device_count() >= WORLD else "gloo"
    mats = grad_matrices(get_config(arch, smoke=smoke))
    args = {"arch": arch, "smoke": smoke, "rank": rank, "device": dev.type}
    with tempfile.TemporaryDirectory() as tmp:
        mp.start_processes(_rank_main, args=(WORLD, backend, os.path.join(tmp, "store"), tmp,
                                             args), nprocs=WORLD, start_method="spawn")
        reports = [json.loads(Path(tmp, f"rank{r}.json").read_text()) for r in range(WORLD)]
    res = summarize(reports, mats, rank)
    res.update(arch=arch, smoke=smoke, backend=backend)
    return res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--rank", type=int, default=64)
    ap.add_argument("--arch", default="granite-moe-1b-a400m")
    ap.add_argument("--smoke", action="store_true", help="the arch's SMOKE config")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--out", default="results/compress_bench.json")
    args = ap.parse_args(argv)
    res = bench(args.arch, args.rank, device=args.device, smoke=args.smoke)
    for name in ("raw", "qrp_compressed"):
        r = res[name]
        print(f"{name:16s} coll={r['coll_bytes'] / 2**20:9.2f} MiB/rank "
              f"(model {r['model_bytes'] / 2**20:9.2f}) {r['ms']:10.3f} ms (median) "
              f"on {res['world']} {res['backend']} ranks, {res['device_name']}")
    print(f"measured reduction: {res['reduction']:.3f}x (analytic r*(m+n) model, r = "
          f"{args.rank} for every matrix: {res['analytic_reduction']:.3f}x); checks "
          f"{res['checks']}")
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(json.dumps(res, indent=1))
    return 0 if res["ok"] else 1


if __name__ == "__main__":
    raise SystemExit(main())
