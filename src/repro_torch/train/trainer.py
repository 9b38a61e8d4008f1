"""Fault-tolerant training loop. Port of ``repro.train.trainer``.

Wires together: the train step, AdamW, the token pipeline, the checkpoint
manager (save, auto-resume), straggler detection, bounded retries and
failure injection. The reference draws its parameters from
``jax.random.PRNGKey(0)``, which torch cannot replay: the port draws them
from a ``torch.Generator`` seeded 0 on the device, or takes the caller's
``params`` (a test hands the reference's over through
``convert.lm_params_from_numpy``).

On a mesh of more than one rank (``launch.mesh.make_host_mesh``'s ``(n,
1)``, or any ``("data", "model")`` / ``("pod", "data", "model")`` mesh of
``launch.mesh.make_mesh``) every rank runs the trainer: it draws (or takes)
the whole parameter tree and keeps its blocks under the two-dim specs of
``rules`` (ZeRO over the data axes, tensor-parallel over the model axis),
so the blocks hold the world of one's bits; it takes its rows of each
global batch by its data coordinate (the ranks of one data coordinate take
the same rows); saves gather every leaf whole to rank 0, which writes the
one-file format every world reads; a resume cuts each leaf of the
checkpoint to this rank's block, whatever mesh wrote it.
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
from repro_torch.models.sharding import RULES_TRAIN, ShardingRules, spec_for
from repro_torch.optim import adamw
from repro_torch.runtime.fault_tolerance import (
    FailureInjector,
    FtConfig,
    StragglerDetector,
    run_with_retries,
)
from repro_torch.train.step import make_train_step, train_state_specs

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
    latest checkpoint there.

    With a ``mesh`` of more than one rank (see the module's docstring)
    every rank builds the trainer and runs it; ``params`` and
    ``opt_state`` are then this rank's blocks, and each history dict also
    holds the step's collective payload by kind (``*_bytes``) and the
    host's seconds inside the collectives (``collective_s``)."""

    def __init__(
        self,
        cfg: ModelConfig,
        shape: ShapeConfig,
        tcfg: TrainerConfig = TrainerConfig(),
        injector: Optional[FailureInjector] = None,
        device="cuda",
        params=None,
        mesh=None,
        rules: ShardingRules = RULES_TRAIN,
    ):
        self.cfg, self.shape, self.tcfg = cfg, shape, tcfg
        self.injector = injector
        self.device = resolve_device(device)
        self.mesh = mesh if mesh is not None and mesh.size > 1 else None
        self.rules = rules
        self.step_fn = make_train_step(cfg, tcfg.opt, self.mesh, rules)
        self.ckpt = self._manager() if tcfg.checkpoint_dir else None
        self.detector = StragglerDetector(tcfg.ft)
        self.history: List[Dict[str, float]] = []
        self.start_step = 0

        shardings = self.pspecs = self.zspecs = None
        if self.mesh is not None:
            _, shardings = train_state_specs(cfg, self.mesh, rules)
            self.pspecs = adamw.map_tree(lambda s: s.spec, shardings[0])
            self.zspecs = adamw.map_tree(lambda s: s.spec, shardings[1].master)
        if params is None:
            gen = torch.Generator(device=self.device).manual_seed(INIT_SEED)
            params = model_lib.init_params(cfg, gen, self.device, self.mesh, self.pspecs)
        elif self.mesh is not None:
            params = model_lib.shard_params(params, self.pspecs, self.mesh)
        opt_state = adamw.init(params, self.mesh, self.pspecs, self.zspecs)
        if self.ckpt and tcfg.resume == "auto" and self.ckpt.latest_step() is not None:
            (params, opt_state), step, _ = self.ckpt.restore(
                (params, opt_state), device=self.device, shardings=shardings)
            self.start_step = step
        self.params, self.opt_state = params, opt_state

    @property
    def lead(self) -> bool:
        """Whether this process speaks for the run (prints, writes): rank 0."""
        return self.mesh is None or self.mesh.rank == 0

    def _manager(self) -> CheckpointManager:
        """The manager; across ranks rank 0 builds its own first (the one
        that sweeps stale ``.tmp`` saves), then the others build theirs to
        read from."""
        if self.mesh is None:
            return CheckpointManager(self.tcfg.checkpoint_dir)
        mgr = CheckpointManager(self.tcfg.checkpoint_dir) if self.mesh.rank == 0 else None
        self.mesh.barrier()
        return mgr or CheckpointManager(self.tcfg.checkpoint_dir)

    def _device_batch(self, batch: Dict[str, np.ndarray]) -> Dict[str, torch.Tensor]:
        out = {k: torch.from_numpy(v) for k, v in batch.items()}
        if self.mesh is not None:  # this rank's rows of the global batch, by its data coordinate
            rows = spec_for(("batch",), self.rules, self.mesh, (self.shape.global_batch,))
            out = {k: self.mesh.local_block(v, rows) for k, v in out.items()}
        return {k: v.to(self.device) for k, v in out.items()}

    def whole_state(self):
        """``(params, OptState)`` whole: this rank's blocks gathered over the
        mesh (every rank must call it), or the state itself on one rank."""
        if self.mesh is None:
            return self.params, self.opt_state
        gather = lambda tree, specs: adamw.map_tree(  # noqa: E731
            lambda t, spec: self.mesh.gather_full(t, spec), tree, specs)
        o = self.opt_state
        return gather(self.params, self.pspecs), adamw.OptState(
            gather(o.master, self.zspecs), gather(o.mu, self.zspecs), gather(o.nu, self.zspecs),
            o.count)

    def save(self, step: int) -> None:
        """Checkpoint ``step``: across ranks every leaf is gathered whole,
        rank 0 writes, and every rank waits for the write."""
        if self.mesh is None:
            self.ckpt.save(step, (self.params, self.opt_state))
            return
        state = self.whole_state()
        if self.mesh.rank == 0:
            self.ckpt.save(step, state)
        del state
        self.mesh.barrier()

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
                    if self.mesh is not None:
                        self.mesh.reset_counters()
                    t0 = time.monotonic()
                    params, opt_state, metrics = self.step_fn(
                        self.params, self.opt_state, self._device_batch(batch)
                    )
                    metrics = {k: float(v) for k, v in metrics.items()}
                    metrics["step_time_s"] = time.monotonic() - t0
                    if self.mesh is not None:
                        metrics.update({f"{k}_bytes" if k != "seconds" else "collective_s":
                                        float(v) for k, v in self.mesh.counters.items()})
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
                if self.lead and step % self.tcfg.log_every == 0:
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
                    self.save(step + 1)
            if self.ckpt:
                self.save(self.tcfg.total_steps)
        finally:
            pipe.close()
        return self.history
