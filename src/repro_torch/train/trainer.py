"""Fault-tolerant training loop. Port of ``repro.train.trainer`` on one
card.

Wires together: the train step, AdamW, the token pipeline, the checkpoint
manager (save, auto-resume), straggler detection, bounded retries and
failure injection. The reference draws its parameters from
``jax.random.PRNGKey(0)``, which torch cannot replay: the port draws them
from a ``torch.Generator`` seeded 0 on the device, or takes the caller's
``params`` (a test hands the reference's over through
``convert.lm_params_from_numpy``).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.base import resolve_device
from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.data.pipeline import DataConfig, TokenPipeline
from repro_torch.models import model as model_lib
from repro_torch.optim import adamw
from repro_torch.runtime.fault_tolerance import (
    FailureInjector,
    FtConfig,
    StragglerDetector,
    run_with_retries,
)
from repro_torch.train.step import make_train_step

INIT_SEED = 0  # the parameters' generator, as the reference's PRNGKey(0)


@dataclasses.dataclass
class TrainerConfig:
    total_steps: int = 100
    log_every: int = 10
    opt: adamw.AdamWConfig = dataclasses.field(default_factory=adamw.AdamWConfig)
    ft: FtConfig = dataclasses.field(default_factory=FtConfig)
    data: DataConfig = dataclasses.field(default_factory=DataConfig)
    checkpoint_dir: str = ""
    resume: str = "auto"  # auto | never


class Trainer:
    """``Trainer(cfg, shape, tcfg).run()`` takes ``tcfg.total_steps`` steps
    of ``shape.global_batch`` x ``shape.seq_len`` tokens on ``device`` (the
    card unless the caller asks for the CPU), and returns the per-step
    ``history`` dicts (``loss``, ``grad_norm``, ``lr``, ``step_time_s``,
    ``step``, ``straggler``). With a checkpoint directory it saves
    ``(params, OptState)`` every ``tcfg.ft.checkpoint_every`` steps and at
    the end, and with ``resume="auto"`` a new trainer starts from the
    latest checkpoint there."""

    def __init__(
        self,
        cfg: ModelConfig,
        shape: ShapeConfig,
        tcfg: TrainerConfig = TrainerConfig(),
        injector: Optional[FailureInjector] = None,
        device="cuda",
        params=None,
    ):
        self.cfg, self.shape, self.tcfg = cfg, shape, tcfg
        self.injector = injector
        self.device = resolve_device(device)
        self.step_fn = make_train_step(cfg, tcfg.opt)
        self.ckpt = (
            CheckpointManager(tcfg.checkpoint_dir) if tcfg.checkpoint_dir else None
        )
        self.detector = StragglerDetector(tcfg.ft)
        self.history: List[Dict[str, float]] = []
        self.start_step = 0

        if params is None:
            gen = torch.Generator(device=self.device).manual_seed(INIT_SEED)
            params = model_lib.init_params(cfg, gen, self.device)
        opt_state = adamw.init(params)
        if self.ckpt and tcfg.resume == "auto" and self.ckpt.latest_step() is not None:
            (params, opt_state), step, _ = self.ckpt.restore((params, opt_state),
                                                             device=self.device)
            self.start_step = step
        self.params, self.opt_state = params, opt_state

    def _device_batch(self, batch: Dict[str, np.ndarray]) -> Dict[str, torch.Tensor]:
        return {k: torch.from_numpy(v).to(self.device) for k, v in batch.items()}

    def run(self) -> List[Dict[str, float]]:
        embeds = self.cfg.frontend != "none"
        pipe = TokenPipeline(
            self.cfg, self.shape, self.tcfg.data, start_step=self.start_step,
            embeds=embeds,
        )
        try:
            for step in range(self.start_step, self.tcfg.total_steps):
                batch = next(pipe)

                def do_step():
                    if self.injector:
                        self.injector.maybe_fail(step)
                    t0 = time.monotonic()
                    params, opt_state, metrics = self.step_fn(
                        self.params, self.opt_state, self._device_batch(batch)
                    )
                    metrics = {k: float(v) for k, v in metrics.items()}
                    metrics["step_time_s"] = time.monotonic() - t0
                    return params, opt_state, metrics

                self.params, self.opt_state, metrics = run_with_retries(
                    do_step, self.tcfg.ft,
                    on_retry=lambda a, e: print(f"[retry {a}] step {step}: {e}"),
                )
                metrics["step"] = step
                metrics["straggler"] = float(
                    self.detector.observe(step, metrics["step_time_s"])
                )
                self.history.append(metrics)
                if step % self.tcfg.log_every == 0:
                    print(
                        f"step {step:5d} loss {metrics['loss']:.4f} "
                        f"gnorm {metrics['grad_norm']:.3f} "
                        f"{metrics['step_time_s']*1e3:.0f}ms",
                        flush=True,
                    )
                if (
                    self.ckpt
                    and (step + 1) % self.tcfg.ft.checkpoint_every == 0
                ):
                    self.ckpt.save(step + 1, (self.params, self.opt_state))
            if self.ckpt:
                self.ckpt.save(self.tcfg.total_steps, (self.params, self.opt_state))
        finally:
            pipe.close()
        return self.history
