"""The port's training loss, gradients and train step on the CPU against the
JAX package: for each family's SMOKE config (dense, moe, ssm, hybrid,
audio, vlm), from the reference's parameters handed over by
``convert.lm_params_from_numpy``, ``make_loss_fn`` and its gradient against
``jax.value_and_grad(repro.models.model.make_loss_fn(cfg, mesh, rules))``;
the three ``remat`` policies; one ``train_step`` against the reference's
``make_train_step``; and ``forward(mode="train")``.

Two faults of the reference bound what it can be held to (ROADMAP.md queue
3). Its layer scans carry the hidden state as ``pack_bf16`` bit patterns
(uint16) in bf16 configs, and its SSD scan carries the chunk states so in
every config; a cotangent does not pass through an integer bitcast, so
``jax.grad`` gives zero for every leaf below the LM head of a bf16 model,
and drops the inter-chunk path of the SSD gradient when a sequence spans
several chunks. The port's gradient takes both paths. Hence:

- f32, sequences of one SSD chunk: the loss within 1e-5 relative and each
  gradient leaf within 1e-4 of its max|reference| (measured: 7.9e-8 and
  3.7e-6).
- f32, three SSD chunks (ssm, hybrid): the port with its scan's inputs
  detached, as the reference's cotangent sees them, within 5e-4 of the
  reference (measured 8.1e-5: the bf16 states of the forward can round one
  ulp apart); and the port's real gradient within 2e-2 of the same model
  run as one chunk (measured 8.0e-3), the same function but for the bf16
  rounding of the carried states.
- bf16: the loss within 2e-3 relative of the reference's (measured 4.5e-4),
  the LM head's and the final norm's gradients within 5e-2 of their
  max|reference| (measured 1.6e-2: one bf16 rounding of the logits apart),
  and every leaf within 1.5e-1 of the port's own f32 gradient at the same
  parameters (measured 7.3e-2, the hybrid's).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.configs.base import ShapeConfig as JShapeConfig
from repro.data.pipeline import DataConfig as JDataConfig
from repro.data.pipeline import batch_for_step as jbatch_for_step
from repro.models import model as jmodel
from repro.optim import adamw as jadamw
from repro.train.step import make_train_step as jmake_train_step
from repro_torch.configs import get_config
from repro_torch.convert import lm_params_from_numpy, opt_state_from_numpy
from repro_torch.models import mamba2 as tmamba
from repro_torch.models import model as tmodel
from repro_torch.optim import adamw
from repro_torch.train.step import make_train_step, train_state_shapes

FAMILIES = {"dense": "repro-100m", "moe": "granite-moe-1b-a400m", "ssm": "mamba2-1.3b",
            "hybrid": "zamba2-2.7b", "audio": "musicgen-large", "vlm": "internvl2-76b"}
SEQ, SEQ_MULTI, BATCH = 32, 96, 2  # one SSD chunk of the SMOKE configs, and three
LOSS_TIGHT, GRAD_TIGHT = 1e-5, 1e-4
GRAD_SCAN_CUT, GRAD_CHUNKING = 5e-4, 2e-2
BF16_LOSS, BF16_HEAD, BF16_VS_F32 = 2e-3, 5e-2, 1.5e-1


class Pair:
    """The reference's and the port's SMOKE model of ``arch`` in ``dtype`` from
    the same parameters (the reference's init, handed over as numpy)."""

    def __init__(self, arch: str, dtype: str, seed: int = 0):
        self.jcfg = dataclasses.replace(jget_config(arch, smoke=True), dtype=dtype)
        self.cfg = dataclasses.replace(get_config(arch, smoke=True), dtype=dtype)
        self.jparams = jmodel.init_params(self.jcfg, jax.random.PRNGKey(seed))
        self.params = lm_params_from_numpy(jax.tree_util.tree_map(np.asarray, self.jparams),
                                           self.cfg)

    def batch(self, seq: int, step: int = 3):
        return jbatch_for_step(self.jcfg, JShapeConfig("t", seq, BATCH, "train"),
                               JDataConfig(seed=5), step, embeds=self.cfg.frontend != "none")

    def reference(self, batch, mesh, rules):
        loss, grads = jax.value_and_grad(jmodel.make_loss_fn(self.jcfg, mesh, rules))(
            self.jparams, {k: jnp.asarray(v) for k, v in batch.items()})
        leaves = jax.tree_util.tree_flatten_with_path(grads)[0]
        return float(loss), {jax.tree_util.keystr(p): np.asarray(g.astype(jnp.float32))
                             for p, g in leaves}


def _names(tree, prefix=""):
    """Leaf names in jax.tree_util.keystr form, in adamw.leaves order."""
    if isinstance(tree, dict):
        return [n for k in sorted(tree) for n in _names(tree[k], f"{prefix}['{k}']")]
    return [prefix]


def port_grads(cfg, params, batch):
    flat = [p.detach().requires_grad_() for p in adamw.leaves(params)]
    loss = tmodel.make_loss_fn(cfg)(adamw.rebuild(params, flat),
                                    {k: torch.from_numpy(v) for k, v in batch.items()})
    grads = torch.autograd.grad(loss, flat, allow_unused=True, materialize_grads=True)
    return float(loss.detach()), {n: g.float().numpy() for n, g in zip(_names(params), grads)}


def _rel(got, want) -> float:
    return float(np.abs(got - want).max() / max(float(np.abs(want).max()), 1e-30))


def _worst(got: dict, want: dict, names=None):
    names = names if names is not None else sorted(want)
    assert set(names) <= set(got)
    return max((_rel(got[n], want[n]), n) for n in names)


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_f32_loss_and_grads_match_reference(family, mesh1, rules):
    pair = Pair(FAMILIES[family], "float32")
    batch = pair.batch(SEQ)
    jloss, jgrads = pair.reference(batch, mesh1, rules)
    loss, grads = port_grads(pair.cfg, pair.params, batch)
    assert abs(loss - jloss) <= LOSS_TIGHT * abs(jloss), (loss, jloss)
    err, name = _worst(grads, jgrads)
    assert err <= GRAD_TIGHT, (name, err)


@pytest.mark.parametrize("family", ["ssm", "hybrid"])
def test_f32_multi_chunk_grads_match_reference_with_its_scan_cut(family, mesh1, rules,
                                                                 monkeypatch):
    """Three SSD chunks: the reference's gradient does not pass through its
    uint16 state scan; the port's, with the scan's inputs detached, is the
    same gradient but for bf16 roundings of the forward states."""
    pair = Pair(FAMILIES[family], "float32")
    batch = pair.batch(SEQ_MULTI)
    jloss, jgrads = pair.reference(batch, mesh1, rules)
    orig = tmamba.associative_scan
    monkeypatch.setattr(tmamba, "associative_scan",
                        lambda fn, elems, dim: orig(fn, [e.detach() for e in elems], dim))
    loss, grads = port_grads(pair.cfg, pair.params, batch)
    assert abs(loss - jloss) <= LOSS_TIGHT * abs(jloss), (loss, jloss)
    err, name = _worst(grads, jgrads)
    assert err <= GRAD_SCAN_CUT, (name, err)


@pytest.mark.parametrize("family", ["ssm", "hybrid"])
def test_f32_multi_chunk_grads_match_one_chunk(family, monkeypatch):
    """The port's gradient through kernel 7's state output and the scan: the
    model over three chunks against the same model over one chunk."""
    pair = Pair(FAMILIES[family], "float32")
    batch = pair.batch(SEQ_MULTI)
    loss, grads = port_grads(pair.cfg, pair.params, batch)
    one = dataclasses.replace(pair.cfg, ssm_chunk=SEQ_MULTI)
    loss1, grads1 = port_grads(one, pair.params, batch)
    assert abs(loss - loss1) <= 1e-4 * abs(loss1)
    err, name = _worst(grads, grads1)
    assert err <= GRAD_CHUNKING, (name, err)
    # the gradient with the scan cut, as the reference's, is far from it
    orig = tmamba.associative_scan
    monkeypatch.setattr(tmamba, "associative_scan",
                        lambda fn, elems, dim: orig(fn, [e.detach() for e in elems], dim))
    _, cut = port_grads(pair.cfg, pair.params, batch)
    assert _worst(cut, grads1)[0] > 10 * GRAD_CHUNKING


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_bf16_loss_and_grads(family, mesh1, rules):
    pair = Pair(FAMILIES[family], "bfloat16")
    batch = pair.batch(SEQ)
    jloss, jgrads = pair.reference(batch, mesh1, rules)
    loss, grads = port_grads(pair.cfg, pair.params, batch)
    assert abs(loss - jloss) <= BF16_LOSS * abs(jloss), (loss, jloss)
    head = ["['lm_head']['w']", "['final_norm']"]
    err, name = _worst(grads, jgrads, head)
    assert err <= BF16_HEAD, (name, err)
    # below the head the reference's bf16 gradient is zero (its uint16
    # carry; moe: the aux loss's alone, which its f32 carry passes on within
    # each layer); the port's is its own f32 gradient's, to bf16 precision
    if family != "moe":
        assert all(np.abs(jgrads[n]).max() == 0 for n in jgrads if "layers" in n)
    f32_cfg = dataclasses.replace(pair.cfg, dtype="float32")
    _, grads32 = port_grads(f32_cfg, adamw.map_tree(lambda t: t.float(), pair.params), batch)
    err, name = _worst(grads, grads32)
    assert err <= BF16_VS_F32, (name, err)
    assert all(np.abs(g).max() > 0 for n, g in grads.items() if "layers" in n)


@pytest.mark.parametrize("family", ["dense", "moe", "hybrid"])
def test_remat_policies_give_the_same_grads(family):
    pair = Pair(FAMILIES[family], "float32")
    batch = pair.batch(SEQ)
    out = {}
    for remat in ("none", "full", "dots"):
        cfg = dataclasses.replace(pair.cfg, remat=remat)
        out[remat] = port_grads(cfg, pair.params, batch)
    for remat in ("full", "dots"):
        assert out[remat][0] == out["none"][0]
        for n, g in out["none"][1].items():
            np.testing.assert_array_equal(out[remat][1][n], g, err_msg=f"{remat} {n}")


def test_unknown_remat_raises():
    pair = Pair("repro-100m", "float32")
    cfg = dataclasses.replace(pair.cfg, remat="everything")
    with pytest.raises(ValueError, match="remat"):
        port_grads(cfg, pair.params, pair.batch(SEQ))


@pytest.mark.parametrize("family", ["dense", "hybrid"])
def test_train_step_matches_reference(family, mesh1, rules):
    """One AdamW step (f32: the reference's bf16 gradient below the head is
    zero) from the same parameters and batch: the metrics, every new
    parameter and every leaf of the new OptState."""
    pair = Pair(FAMILIES[family], "float32")
    opt_cfg = dict(lr=1e-3, warmup_steps=2, total_steps=10)
    jstep = jax.jit(jmake_train_step(pair.jcfg, mesh1, rules, jadamw.AdamWConfig(**opt_cfg)))
    step = make_train_step(pair.cfg, adamw.AdamWConfig(**opt_cfg))
    batch = pair.batch(SEQ)
    jparams, jopt, jmetrics = jstep(pair.jparams, jadamw.init(pair.jparams),
                                    {k: jnp.asarray(v) for k, v in batch.items()})
    jopt = jax.block_until_ready(jopt)
    params, opt, metrics = step(pair.params, adamw.init(pair.params),
                                {k: torch.from_numpy(v) for k, v in batch.items()})
    for k in ("loss", "grad_norm", "lr"):
        assert float(metrics[k]) == pytest.approx(float(jmetrics[k]), rel=1e-5), k
    want = opt_state_from_numpy(jax.tree_util.tree_map(np.asarray, jopt), pair.cfg)
    assert int(opt.count) == int(want.count) == 1
    for part in ("master", "mu", "nu"):
        got_l, want_l = adamw.leaves(getattr(opt, part)), adamw.leaves(getattr(want, part))
        for name, g, w in zip(_names(params), got_l, want_l):
            scale = max(float(w.abs().max()), 1e-30)
            assert float((g - w).abs().max()) <= 1e-4 * scale, (part, name)
    jp = lm_params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams), pair.cfg)
    for name, g, w in zip(_names(params), adamw.leaves(params), adamw.leaves(jp)):
        assert g.dtype == w.dtype
        assert float((g - w).abs().max()) <= 1e-4 * float(w.abs().max()), name


def test_train_state_shapes_are_the_reference_state():
    cfg = get_config("zamba2-2.7b", smoke=True)
    pshapes, oshapes = train_state_shapes(cfg)
    params = tmodel.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    opt = adamw.init(params)
    got = adamw.leaves(pshapes) + [s for part in oshapes[:3] for s in adamw.leaves(part)]
    want = adamw.leaves(params) + [t for part in opt[:3] for t in adamw.leaves(part)]
    assert [(tuple(t.shape), t.dtype) for t in want] == got
    assert oshapes.count == ((), torch.int32)


def test_forward_train_returns_logits_that_carry_a_grad():
    cfg = get_config("zamba2-2.7b", smoke=True)
    params = tmodel.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    params = adamw.map_tree(lambda t: t.requires_grad_(), params)
    tokens = torch.zeros((1, 8), dtype=torch.long)
    logits, cache, aux = tmodel.forward(cfg, params, tokens, mode="train")
    assert cache is None and logits.requires_grad and logits.shape == (1, 8, cfg.padded_vocab)
    logits.float().sum().backward()
    assert params["lm_head"]["w"].grad is not None
    with torch.no_grad():
        logits, _, _ = tmodel.forward(cfg, params, tokens, mode="prefill")
    assert not logits.requires_grad
