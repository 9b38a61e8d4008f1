"""End-to-end training entry point: the ~100M-parameter dense LM for a
few hundred steps, on the card. The twin of ``examples/train_lm.py``:

    PYTHONPATH=src python -m repro_torch.train --steps 300 [--full-100m]

The default runs the reduced repro-100m-smoke config; ``--full-100m``
trains the real 101M-parameter config (the same code path). The data
pipeline feeds the fault-tolerant Trainer, which checkpoints into
``--ckpt-dir`` and auto-resumes from it (run the same command again to
continue from the last checkpoint). ``--device cpu`` runs the plain
versions on the CPU.
"""
from __future__ import annotations

import argparse
import os
import tempfile
from typing import List, Optional

import torch

from repro_torch.configs import get_config
from repro_torch.configs.base import ShapeConfig
from repro_torch.optim import adamw
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
    return ap.parse_args(argv)


def make_trainer(args: argparse.Namespace, injector=None) -> Trainer:
    """The example's trainer: repro-100m (SMOKE unless ``--full-100m``),
    AdamW at lr 3e-4 with 20 warmup steps, a checkpoint directory."""
    cfg = get_config("repro-100m", smoke=not args.full_100m)
    shape = ShapeConfig("example", args.seq, args.batch, "train")
    tcfg = TrainerConfig(
        total_steps=args.steps,
        log_every=10,
        opt=adamw.AdamWConfig(lr=3e-4, warmup_steps=20, total_steps=args.steps),
        checkpoint_dir=args.ckpt_dir,
    )
    return Trainer(cfg, shape, tcfg, injector=injector, device=args.device)


def loss_line(hist) -> str:
    """The closing line: the mean of the first and of the last ten losses."""
    first = sum(h["loss"] for h in hist[:10]) / max(len(hist[:10]), 1)
    last = sum(h["loss"] for h in hist[-10:]) / max(len(hist[-10:]), 1)
    return (f"loss: first10={first:.4f} last10={last:.4f} "
            f"({'improved' if last < first else 'no improvement'})")


def main(argv: Optional[List[str]] = None) -> int:
    args = parse_args(argv)
    trainer = make_trainer(args)
    cfg, shape = trainer.cfg, trainer.shape
    n_dev = torch.cuda.device_count() if trainer.device.type == "cuda" else 1
    print(f"arch={cfg.name} params~{cfg.param_count()/1e6:.1f}M "
          f"tokens/step={shape.tokens} devices={n_dev}")
    if trainer.start_step:
        print(f"resumed from checkpoint at step {trainer.start_step}")
    hist = trainer.run()
    print(loss_line(hist))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
