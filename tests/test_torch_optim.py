"""``repro_torch.optim.adamw`` on the CPU against ``repro.optim.adamw``:
three updates from the same grads in f32, leaf by leaf, and the reference's
four AdamW tests ported (the quadratic, the schedule, the clip, the
bf16/f32 round trip).

Both compute in f32 and in the same order; XLA and torch may round a
transcendental (cos, pow) or fuse a multiply-add differently, so the three
steps are held to 1e-6 of each leaf's max|reference| (measured: 2.8e-7).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.optim import adamw as jadamw
from repro_torch.optim import adamw

TOL = 1e-6
CFG = dict(lr=1e-2, warmup_steps=2, total_steps=10, weight_decay=0.1, grad_clip=1.0)


def _tree(rng):
    """A parameter tree with matrices (decayed) and vectors (not)."""
    return {"a": {"w": rng.standard_normal((5, 3)).astype(np.float32),
                  "b": rng.standard_normal((3,)).astype(np.float32)},
            "stack": rng.standard_normal((2, 4, 3)).astype(np.float32),
            "norm": np.ones((4,), np.float32)}


def _torch(tree):
    return adamw.map_tree(lambda a: torch.from_numpy(np.array(a)), tree)


@pytest.mark.parametrize("clip,scale", [(1.0, 1.0), (1.0, 100.0), (0.0, 1.0)])
def test_three_steps_match_reference(clip, scale):
    rng = np.random.default_rng(0)
    params = _tree(rng)
    cfg = dict(CFG, grad_clip=clip)
    jopt, opt = jadamw.init(jax.tree_util.tree_map(jnp.asarray, params)), adamw.init(_torch(params))
    for step in range(3):
        grads = jax.tree_util.tree_map(lambda a: scale * a, _tree(np.random.default_rng(step + 1)))
        jp, jopt, jm = jadamw.apply(jadamw.AdamWConfig(**cfg),
                                    jax.tree_util.tree_map(jnp.asarray, grads), jopt)
        p, opt, m = adamw.apply(adamw.AdamWConfig(**cfg), _torch(grads), opt)
        assert float(m["grad_norm"]) == pytest.approx(float(jm["grad_norm"]), rel=TOL)
        assert float(m["lr"]) == pytest.approx(float(jm["lr"]), rel=TOL)
        assert int(opt.count) == int(jopt.count) == step + 1
        for part in ("master", "mu", "nu"):
            for got, want in zip(adamw.leaves(getattr(opt, part)),
                                 jax.tree_util.tree_leaves(getattr(jopt, part))):
                want = np.asarray(want)
                assert np.abs(got.numpy() - want).max() <= TOL * max(np.abs(want).max(), 1e-30)
        for got, want in zip(adamw.leaves(p), jax.tree_util.tree_leaves(jp)):
            want = np.asarray(want)
            assert np.abs(got.numpy() - want).max() <= TOL * np.abs(want).max()


def test_adamw_converges_on_quadratic():
    cfg = adamw.AdamWConfig(lr=0.1, warmup_steps=1, total_steps=200,
                            weight_decay=0.0, grad_clip=0.0)
    target = torch.from_numpy(np.random.default_rng(0).standard_normal((4, 4)).astype(np.float32))
    params = {"w": torch.zeros((4, 4), dtype=torch.float32)}
    opt = adamw.init(params)
    for _ in range(150):
        grads = {"w": params["w"] - target}
        params, opt, _ = adamw.apply(cfg, grads, opt)
    assert float((params["w"] - target).abs().max()) < 0.05


def test_schedule_warmup_and_decay():
    cfg = adamw.AdamWConfig(lr=1e-3, warmup_steps=10, total_steps=100, min_lr_frac=0.1)
    lrs = [float(adamw.schedule(cfg, torch.tensor(s, dtype=torch.int32))) for s in (0, 5, 10, 100)]
    assert lrs[0] == 0.0
    assert lrs[1] == pytest.approx(5e-4, rel=1e-3)
    assert lrs[2] == pytest.approx(1e-3, rel=1e-3)
    assert lrs[3] == pytest.approx(1e-4, rel=1e-2)
    jcfg = jadamw.AdamWConfig(lr=1e-3, warmup_steps=10, total_steps=100, min_lr_frac=0.1)
    for s in range(0, 101, 7):
        got = adamw.schedule(cfg, torch.tensor(s, dtype=torch.int32))
        assert got.dtype == torch.float32
        assert float(got) == pytest.approx(float(jadamw.schedule(jcfg, jnp.int32(s))), rel=1e-6)


def test_grad_clip_bounds_update():
    cfg = adamw.AdamWConfig(lr=1.0, grad_clip=1.0, warmup_steps=0)
    params = {"w": torch.zeros((8,), dtype=torch.float32)}
    opt = adamw.init(params)
    huge = {"w": torch.full((8,), 1e6, dtype=torch.float32)}
    _, _, metrics = adamw.apply(cfg, huge, opt)
    assert float(metrics["grad_norm"]) > 1e6  # reported pre-clip


def test_bf16_master_fp32_roundtrip():
    cfg = adamw.AdamWConfig(lr=1e-4, warmup_steps=0)
    params = {"w": torch.ones((4,), dtype=torch.bfloat16)}
    opt = adamw.init(params)
    assert opt.master["w"].dtype == torch.float32
    g = {"w": torch.full((4,), 0.5, dtype=torch.bfloat16)}
    params2, opt2, _ = adamw.apply(cfg, g, opt)
    assert params2["w"].dtype == torch.bfloat16
    assert opt2.master["w"].dtype == torch.float32


def test_new_params_are_copies_of_the_master():
    """An f32 parameter comes back as a copy, not the master itself, which
    the next update writes in place."""
    params = {"w": torch.ones((2, 2), dtype=torch.float32)}
    opt = adamw.init(params)
    p2, opt2, _ = adamw.apply(adamw.AdamWConfig(), {"w": torch.ones((2, 2))}, opt)
    assert torch.equal(p2["w"], opt2.master["w"])
    assert p2["w"].data_ptr() != opt2.master["w"].data_ptr()
