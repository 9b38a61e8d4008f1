"""``repro_torch.train.trainer`` on the CPU: the reference's ``_trainer``
cases of ``tests/test_fault_tolerance.py`` ported on repro-100m SMOKE (the
loss falls, an injected failure is retried, a crash restart ends with the
uninterrupted run's parameters bit for bit), a 6-step history against the
reference's ``Trainer`` from the same initial parameters, and
``python -m repro_torch.train``.

The history is compared in f32: the reference's bf16 gradient below the LM
head is zero (ROADMAP.md queue 3), so a bf16 reference run trains the head
alone. Each step's loss within 1e-5 relative and grad norm within 1e-4
relative of the reference's (measured 3.4e-7 and 1.0e-6), and the final
parameters within 5e-4 of each leaf's max|reference| (measured 7.9e-5:
Adam's update divides by sqrt(v), so where a gradient entry is near zero a
last-bit difference moves that entry's step by up to the learning rate).
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.configs.base import ShapeConfig as JShapeConfig
from repro.models import model as jmodel
from repro.optim import adamw as jadamw
from repro.runtime.fault_tolerance import FtConfig as JFtConfig
from repro.train.trainer import Trainer as JTrainer
from repro.train.trainer import TrainerConfig as JTrainerConfig
from repro_torch.configs import get_config
from repro_torch.configs.base import ShapeConfig
from repro_torch.convert import lm_params_from_numpy
from repro_torch.optim import adamw
from repro_torch.runtime.fault_tolerance import FailureInjector
from repro_torch.train import __main__ as train_main
from repro_torch.train.trainer import Trainer, TrainerConfig

SHAPE = ShapeConfig("tiny", 32, 2, "train")
LOSS_TOL, GNORM_TOL, PARAM_TOL = 1e-5, 1e-4, 5e-4


def _trainer(tmp_path, total, injector=None, ckpt_every=4, cfg=None, params=None):
    cfg = cfg or get_config("repro-100m", smoke=True)
    tcfg = TrainerConfig(
        total_steps=total,
        log_every=1000,
        opt=adamw.AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=total),
        checkpoint_dir=str(tmp_path / "ckpt") if tmp_path is not None else "",
    )
    tcfg.ft = dataclasses.replace(tcfg.ft, checkpoint_every=ckpt_every, retry_backoff_s=0.0)
    return Trainer(cfg, SHAPE, tcfg, injector=injector, device="cpu", params=params)


def test_trainer_loss_decreases(tmp_path):
    t = _trainer(tmp_path, total=20)
    hist = t.run()
    first = np.mean([h["loss"] for h in hist[:4]])
    last = np.mean([h["loss"] for h in hist[-4:]])
    assert last < first  # structured synthetic corpus is learnable
    assert sorted(hist[0]) == ["grad_norm", "loss", "lr", "step", "step_time_s", "straggler"]


def test_trainer_retry_on_injected_failure(tmp_path):
    inj = FailureInjector(fail_at=[3])
    t = _trainer(tmp_path, total=6, injector=inj)
    hist = t.run()
    assert len(hist) == 6  # step 3 retried, run completed
    assert [h["step"] for h in hist] == list(range(6))


def test_trainer_crash_restart_is_deterministic(tmp_path):
    """Kill at step 6, restart from the step-4 checkpoint: final params and
    optimizer state equal an uninterrupted run's, bit for bit."""
    ref = _trainer(tmp_path / "a", total=8)
    ref.run()

    class Boom(Exception):
        pass

    inj = FailureInjector(fail_at=[6], exc=Boom)
    t1 = _trainer(tmp_path / "b", total=8, injector=inj)
    with pytest.raises(Boom):
        t1.run()
    # restart: auto-resume from the latest checkpoint (step 4)
    t2 = _trainer(tmp_path / "b", total=8)
    assert t2.start_step == 4
    assert isinstance(t2.opt_state, adamw.OptState) and int(t2.opt_state.count) == 4
    t2.run()
    for a, b in zip(adamw.leaves(ref.params), adamw.leaves(t2.params)):
        assert a.dtype == b.dtype and torch.equal(a, b)
    for part in ("master", "mu", "nu"):
        for a, b in zip(adamw.leaves(getattr(ref.opt_state, part)),
                        adamw.leaves(getattr(t2.opt_state, part))):
            assert torch.equal(a, b)


def test_trainer_without_checkpoints_and_resume_never(tmp_path):
    t = _trainer(None, total=2)
    assert t.ckpt is None and len(t.run()) == 2
    _trainer(tmp_path, total=2).run()
    cfg = get_config("repro-100m", smoke=True)
    tcfg = TrainerConfig(total_steps=2, checkpoint_dir=str(tmp_path / "ckpt"), resume="never")
    assert Trainer(cfg, SHAPE, tcfg, device="cpu").start_step == 0


def test_history_matches_reference_trainer(tmp_path, mesh1):
    """6 steps of both trainers from the reference's initial parameters, f32."""
    jcfg = dataclasses.replace(jget_config("repro-100m", smoke=True), dtype="float32")
    cfg = dataclasses.replace(get_config("repro-100m", smoke=True), dtype="float32")
    jtcfg = JTrainerConfig(total_steps=6, log_every=1000,
                           opt=jadamw.AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=6),
                           ft=JFtConfig(retry_backoff_s=0.0))
    jt = JTrainer(jcfg, JShapeConfig("tiny", 32, 2, "train"), mesh1, jtcfg)
    jhist = jt.run()
    params = lm_params_from_numpy(
        jax.tree_util.tree_map(np.asarray, jmodel.init_params(jcfg, jax.random.PRNGKey(0))), cfg)
    t = _trainer(None, total=6, cfg=cfg, params=params)
    hist = t.run()
    assert [h["step"] for h in hist] == [h["step"] for h in jhist]
    for h, jh in zip(hist, jhist):
        assert h["loss"] == pytest.approx(jh["loss"], rel=LOSS_TOL)
        assert h["grad_norm"] == pytest.approx(jh["grad_norm"], rel=GNORM_TOL)
        assert h["lr"] == pytest.approx(jh["lr"], rel=1e-6)
    want = lm_params_from_numpy(jax.tree_util.tree_map(np.asarray, jt.params), cfg)
    for a, b in zip(adamw.leaves(t.params), adamw.leaves(want)):
        assert float((a - b).abs().max()) <= PARAM_TOL * float(b.abs().max())


def test_train_module_runs_and_resumes(tmp_path, capsys):
    argv = ["--steps", "3", "--batch", "2", "--seq", "16", "--ckpt-dir", str(tmp_path),
            "--device", "cpu"]
    assert train_main.main(argv) == 0
    out = capsys.readouterr().out
    assert "arch=repro-100m-smoke" in out and "loss: first10=" in out
    assert train_main.main(["--steps", "4"] + argv[2:]) == 0
    assert "resumed from checkpoint at step 3" in capsys.readouterr().out
