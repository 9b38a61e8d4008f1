"""The port's MoE block (``repro_torch.models.moe``) on the CPU against
``repro.models.moe.moe_block`` on a (1, 1) mesh with ``DEFAULT_RULES``:
granite-moe and grok SMOKE, ``expert_shards`` 1 and 2, f32 and bf16,
``capacity_factor`` 1.25 and 0.5 (where tokens are dropped), prefill-shaped
(3, 24, d) and decode-shaped (3, 1, d) inputs, from the reference's weights
handed over by ``convert.lm_params_from_numpy``.

Held to: the same experts and the same kept slots as the reference's
routing; the output within 1e-5 x max|reference| in f32 (the same
operations, f32 sums in other orders) and within one bf16 ulp, 2^-7 x
max|reference|, in bf16; the aux loss within 1e-6. Also the port's copy
of ``repro.models.flops`` against the reference's.
"""
import dataclasses
import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.configs import registry as jregistry
from repro.configs.base import SHAPES as JSHAPES
from repro.configs.base import ShapeConfig as JShapeConfig
from repro.models import flops as jflops
from repro.models import model as jmodel
from repro.models import moe as jmoe
from repro_torch.configs import get_config
from repro_torch.configs.base import SHAPES, ShapeConfig
from repro_torch.convert import lm_params_from_numpy
from repro_torch.models import flops, moe

ARCHS = ["granite-moe-1b-a400m", "grok-1-314b"]
F32_TOL, ONE_BF16_ULP, AUX_TOL = 1e-5, 2.0 ** -7, 1e-6
CASES = list(itertools.product(ARCHS, (1, 2), ("float32", "bfloat16"), (1.25, 0.5), (24, 1)))
WEIGHTS = ("router", "moe_wi", "moe_wg", "moe_wo")


def _configs(arch, expert_shards, dtype, capacity_factor):
    kw = dict(expert_shards=expert_shards, dtype=dtype, capacity_factor=capacity_factor)
    return (dataclasses.replace(jget_config(arch, smoke=True), **kw),
            dataclasses.replace(get_config(arch, smoke=True), **kw))


def _layer0(jcfg, cfg, seed: int = 0):
    """Layer 0's MoE weights of the reference's init, as numpy and as the
    port's tensors."""
    jp = jax.tree_util.tree_map(np.asarray, jmodel.init_params(jcfg, jax.random.PRNGKey(seed)))
    tp = lm_params_from_numpy(jp, cfg)
    return ({n: jp["layers"][n][0] for n in WEIGHTS},
            {n: tp["layers"][n][0] for n in WEIGHTS})


def _reference_routing(jcfg, xt, wr):
    """The reference's routing steps (``repro/models/moe.py:166-195``) in
    jnp: the experts of each token, best first, and each (token, rank)
    pair's kept flag and slot."""
    t, e = xt.shape[0], jcfg.n_experts
    cap = jmoe._capacity(t, jcfg)
    probs = jax.nn.softmax(xt.astype(jnp.float32) @ wr.astype(jnp.float32), axis=-1)
    _, tope = jax.lax.top_k(probs, jcfg.top_k)
    flat_e = tope.reshape(-1)
    onehot = (flat_e[:, None] == jnp.arange(e)[None, :]).astype(jnp.int32)
    pos = jnp.sum(jnp.cumsum(onehot, axis=0) * onehot, axis=-1) - 1
    keep = pos < cap
    slot = jnp.where(keep, flat_e * cap + pos, e * cap)
    return np.asarray(tope), np.asarray(keep), np.asarray(slot)


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape
    return float(np.abs(got - want).max() / np.abs(want).max())


@pytest.mark.parametrize("arch", ARCHS)
def test_capacity_is_the_references(arch):
    for smoke, cf in itertools.product((True, False), (0.25, 0.5, 1.0, 1.25, 2.0, 8.0)):
        jcfg = dataclasses.replace(jget_config(arch, smoke=smoke), capacity_factor=cf)
        cfg = dataclasses.replace(get_config(arch, smoke=smoke), capacity_factor=cf)
        for t in (1, 3, 4, 7, 24, 72, 1000, 4096, 16384):
            assert moe._capacity(t, cfg) == jmoe._capacity(t, jcfg), (smoke, cf, t)


@pytest.mark.parametrize("arch,shards,dtype,cf,s", CASES)
def test_moe_block_matches_the_reference(arch, shards, dtype, cf, s, mesh1, rules):
    jcfg, cfg = _configs(arch, shards, dtype, cf)
    jw, tw = _layer0(jcfg, cfg)
    x = np.random.default_rng(1).standard_normal((3, s, cfg.d_model)).astype(np.float32)
    jx = jnp.asarray(x).astype(jcfg.dtype)
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    want, jaux = jmoe.moe_block(jcfg, mesh1, rules, jx, *(jnp.asarray(jw[n]) for n in WEIGHTS))
    got, aux = moe.moe_block(cfg, tx, *(tw[n] for n in WEIGHTS))
    assert got.dtype == tx.dtype and got.shape == tx.shape

    tope, keep, slot = _reference_routing(jcfg, jx.reshape(-1, cfg.d_model),
                                          jnp.asarray(jw["router"]))
    r = moe.route(cfg, tx.reshape(-1, cfg.d_model), tw["router"])
    np.testing.assert_array_equal(r.tope.numpy(), tope)
    np.testing.assert_array_equal(r.keep.numpy(), keep)
    np.testing.assert_array_equal(r.slot.numpy(), slot)
    if cf < 1 and s > 1:  # 144 routed pairs, 96 slots: a third dropped
        assert float(r.dropped_share) == pytest.approx(1 / 3)

    tol = F32_TOL if dtype == "float32" else ONE_BF16_ULP
    assert _rel(got.float().numpy(), np.asarray(want.astype(jnp.float32))) <= tol
    assert aux.dtype == torch.float32 and abs(float(aux) - float(jaux)) <= AUX_TOL


def test_top_k_ties_go_to_the_lower_expert():
    """A zero router gives every expert the same probability: the top-k is
    the first k experts, best first, as ``jax.lax.top_k`` picks them."""
    jcfg, cfg = _configs("granite-moe-1b-a400m", 1, "float32", 1.25)
    xt = np.random.default_rng(2).standard_normal((5, cfg.d_model)).astype(np.float32)
    wr = np.zeros((cfg.d_model, cfg.n_experts), np.float32)
    tope, keep, slot = _reference_routing(jcfg, jnp.asarray(xt), jnp.asarray(wr))
    r = moe.route(cfg, torch.from_numpy(xt), torch.from_numpy(wr))
    np.testing.assert_array_equal(r.tope.numpy(), tope)
    np.testing.assert_array_equal(r.tope.numpy(), np.tile(np.arange(cfg.top_k), (5, 1)))
    np.testing.assert_array_equal(r.slot.numpy(), slot)
    np.testing.assert_array_equal(r.keep.numpy(), keep)


def test_expert_shards_split_is_exact():
    """Each expert's d_ff split in two shards gives the unsplit block's
    output: every slot visits both shards and their outputs are summed (the
    twin of the reference's ``test_moe_expert_shards_exact``)."""
    cfg1 = dataclasses.replace(get_config("granite-moe-1b-a400m", smoke=True), dtype="float32")
    cfg2 = dataclasses.replace(cfg1, expert_shards=2)
    g = torch.Generator().manual_seed(3)
    e, d, ff = cfg1.n_experts, cfg1.d_model, cfg1.d_ff
    wr = torch.randn((d, e), generator=g)
    wi, wg = torch.randn((e, d, ff), generator=g) / 8, torch.randn((e, d, ff), generator=g) / 8
    wo = torch.randn((e, ff, d), generator=g) / 8

    def split(w, axis):
        a, b = torch.chunk(w, 2, dim=axis)
        return torch.stack([a, b], dim=1).reshape((2 * e,) + a.shape[1:])

    x = torch.randn((2, 16, d), generator=g)
    y1, aux1 = moe.moe_block(cfg1, x, wr, wi, wg, wo)
    y2, aux2 = moe.moe_block(cfg2, x, wr, split(wi, 2), split(wg, 2), split(wo, 1))
    assert _rel(y2.numpy(), y1.numpy()) <= F32_TOL
    assert float(aux1) == float(aux2)


def test_dropped_pairs_add_nothing():
    """With a capacity of 8 slots an expert, top-1, and every token routed
    to one expert, only the first 8 tokens are kept; the other 12 tokens'
    outputs are 0."""
    cfg = dataclasses.replace(get_config("granite-moe-1b-a400m", smoke=True), dtype="float32",
                              top_k=1, capacity_factor=0.01)
    d, e = cfg.d_model, cfg.n_experts
    g = torch.Generator().manual_seed(4)
    wr = torch.zeros((d, e))
    wr[:, 2] = 1.0  # every token with a positive feature sum prefers expert 2
    x = torch.rand((1, 20, d), generator=g) + 0.1
    ff = cfg.d_ff
    w = [torch.randn(s, generator=g) for s in ((e, d, ff), (e, d, ff), (e, ff, d))]
    y, _ = moe.moe_block(cfg, x, wr, *w)
    r = moe.route(cfg, x[0], wr)
    assert r.cap == 8 and r.keep.tolist() == [True] * 8 + [False] * 12
    assert torch.equal(y[0, 8:], torch.zeros_like(y[0, 8:]))
    assert not torch.equal(y[0, :8], torch.zeros_like(y[0, :8]))


@pytest.mark.parametrize("arch", sorted(jregistry._MODULES))
def test_cell_cost_is_the_references(arch):
    """``models/flops.py``: the port's copy gives the reference's executed
    FLOPs, useful FLOPs and HBM bytes for every registered config and shape
    (the MoE counts its E x cap capacity slots), and the serve prefill
    shape that ``chip_smoke.py`` reads against the card's peak."""
    cfg, jcfg = get_config(arch), jget_config(arch)
    shapes = [(SHAPES[n], JSHAPES[n]) for n in sorted(SHAPES)]
    shapes.append((ShapeConfig("serve", 4096, 4, "prefill"),
                   JShapeConfig("serve", 4096, 4, "prefill")))
    for shape, jshape in shapes:
        got, want = flops.cell_cost(cfg, shape), jflops.cell_cost(jcfg, jshape)
        assert dataclasses.asdict(got) == dataclasses.asdict(want), (arch, shape.name)
