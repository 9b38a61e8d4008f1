"""End-to-end training entry point: the ~100M-parameter dense LM for a
few hundred steps, on the card. The twin of ``examples/train_lm.py``:

    PYTHONPATH=src python -m repro_torch.train --steps 300 [--full-100m]

The default runs the reduced repro-100m-smoke config; ``--full-100m``
trains the real 101M-parameter config (the same code path). The data
pipeline feeds the fault-tolerant Trainer, which checkpoints into
``--ckpt-dir`` and auto-resumes from it (run the same command again to
continue from the last checkpoint). ``--device cpu`` runs the plain
versions on the CPU.

Across ranks, as the reference's example trains on its host mesh:

    PYTHONPATH=src python -m torch.distributed.run --nproc-per-node 2 \
        -m repro_torch.train --full-100m

With ``WORLD_SIZE`` above 1 this entry point initialises the process group
(the library never does) and trains on ``make_host_mesh()``, every rank
a ``(n, 1)`` ``("data", "model")`` mesh coordinate: NCCL when each rank has
a card of its own, gloo when ranks share one (NCCL refuses two ranks on one
device) or run on the CPU. ``--report DIR`` writes each rank's summary
(history, kernel 6's launches by route, peak memory, collective bytes and
their route, a digest of the whole parameters) to ``DIR/rank<r>.json``.
"""
from __future__ import annotations

import argparse
import datetime
import hashlib
import json
import os
import tempfile
from pathlib import Path
from typing import List, Optional

import torch
import torch.distributed as dist

from repro_torch.configs import get_config
from repro_torch.configs.base import ShapeConfig
from repro_torch.launch.mesh import GROUP_TIMEOUT_S, make_host_mesh
from repro_torch.optim import adamw
from repro_torch.train.step import collective_bytes_per_step
from repro_torch.train.trainer import Trainer, TrainerConfig


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.train")
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--full-100m", action="store_true")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--ckpt-dir", default=os.path.join(tempfile.gettempdir(),
                                                       "repro_torch_train_lm"))
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--report", default="", help="a directory for each rank's JSON summary")
    return ap.parse_args(argv)


def init_ranks(device: str):
    """(this rank's device, whether this call initialised the process
    group): the group is initialised when ``torch.distributed.run`` started
    more than one rank and no group exists yet, over NCCL when every local
    rank has a card of its own, else over gloo (ranks sharing a card, or
    the CPU)."""
    world = int(os.environ.get("WORLD_SIZE", "1"))
    dev = torch.device(device)
    if dev.type == "cuda":
        cards = torch.cuda.device_count()
        local = int(os.environ.get("LOCAL_RANK", "0"))
        own = int(os.environ.get("LOCAL_WORLD_SIZE", str(world))) <= cards
        dev = torch.device("cuda", local % cards if cards else 0)
        if cards:
            torch.cuda.set_device(dev)
    else:
        own = False
    started = world > 1 and not dist.is_initialized()
    if started:
        timeout = datetime.timedelta(seconds=GROUP_TIMEOUT_S)
        if own:
            dist.init_process_group("nccl", timeout=timeout, device_id=dev)
        else:
            dist.init_process_group("gloo", timeout=timeout)
    return dev, started


def make_trainer(args: argparse.Namespace, injector=None, mesh=None) -> Trainer:
    """The example's trainer: repro-100m (SMOKE unless ``--full-100m``),
    AdamW at lr 3e-4 with 20 warmup steps, a checkpoint directory; on
    ``mesh`` when one is given."""
    cfg = get_config("repro-100m", smoke=not args.full_100m)
    shape = ShapeConfig("example", args.seq, args.batch, "train")
    tcfg = TrainerConfig(
        total_steps=args.steps,
        log_every=10,
        opt=adamw.AdamWConfig(lr=3e-4, warmup_steps=20, total_steps=args.steps),
        checkpoint_dir=args.ckpt_dir,
    )
    return Trainer(cfg, shape, tcfg, injector=injector, device=args.device, mesh=mesh)


def loss_line(hist) -> str:
    """The closing line: the mean of the first and of the last ten losses."""
    first = sum(h["loss"] for h in hist[:10]) / max(len(hist[:10]), 1)
    last = sum(h["loss"] for h in hist[-10:]) / max(len(hist[-10:]), 1)
    return (f"loss: first10={first:.4f} last10={last:.4f} "
            f"({'improved' if last < first else 'no improvement'})")


def params_digest(params) -> str:
    """sha256 over the bits of every leaf of a whole parameter tree."""
    h = hashlib.sha256()
    for t in adamw.leaves(params):
        t = t.detach().cpu().contiguous()
        h.update(t.view(torch.uint8).numpy().tobytes() if t.numel() else b"")
    return h.hexdigest()


def write_report(trainer: Trainer, hist, directory: str) -> None:
    """This rank's summary as ``directory/rank<r>.json`` (every rank must
    call it: the digest gathers the whole parameters)."""
    from repro_torch.kernels import flash_attention as fa

    whole, _ = trainer.whole_state()
    mesh = trainer.mesh
    rank = mesh.rank if mesh is not None else 0
    dev = trainer.device
    report = {
        "rank": rank, "world": mesh.size if mesh is not None else 1,
        "route": mesh.route if mesh is not None else "none",
        "device": str(dev), "start_step": trainer.start_step, "history": hist,
        "flash_attention": dict(fa.flash_attention.launches_by_route),
        "flash_attention_bwd": dict(fa.flash_attention_bwd.launches_by_route),
        "peak_bytes": torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0,
        "collective_bytes_per_step_model": (
            collective_bytes_per_step(trainer.cfg, mesh, trainer.rules, trainer.shape.global_batch,
                                      trainer.shape.seq_len)
            if mesh is not None else {}),
        "params_digest": params_digest(whole),
    }
    Path(directory).mkdir(parents=True, exist_ok=True)
    Path(directory, f"rank{rank}.json").write_text(json.dumps(report))


def main(argv: Optional[List[str]] = None) -> int:
    args = parse_args(argv)
    dev, started = init_ranks(args.device)
    args.device = str(dev)
    try:
        mesh = make_host_mesh(device=dev) if dist.is_initialized() else None
        trainer = make_trainer(args, mesh=mesh)
        cfg, shape = trainer.cfg, trainer.shape
        if trainer.lead:
            ranks = mesh.size if mesh is not None else 1
            route = f" route={mesh.route}" if mesh is not None else ""
            print(f"arch={cfg.name} params~{cfg.param_count()/1e6:.1f}M "
                  f"tokens/step={shape.tokens} ranks={ranks} device={dev}{route}")
            if trainer.start_step:
                print(f"resumed from checkpoint at step {trainer.start_step}")
        hist = trainer.run()
        if args.report:
            write_report(trainer, hist, args.report)
        if trainer.lead:
            print(loss_line(hist))
    finally:
        if started:
            dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
