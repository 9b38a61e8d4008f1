"""The port's ``dense``, ``moe``, ``ssm``, ``audio`` and ``vlm`` families on
the CPU against the JAX package: for each family's SMOKE configs (qwen2-7b
with its qkv bias, yi-6b and smollm-360m for ``dense``; granite-moe-1b-a400m
and grok-1-314b for ``moe``; mamba2-1.3b; musicgen-large; internvl2-76b),
from the reference's weights handed over by ``convert.lm_params_from_numpy``,
the prefill and decode logits, the caches, the forward's aux loss and the
greedy tokens of ``Engine.generate``; prefill from ``embeds`` for the audio
and vision families; ``param_count_actual`` for all 11 configs.

Tolerances are ``test_torch_lm.py``'s, as a fraction of max|reference
logit|: 1e-4 where no bf16 rounding intervenes (a one-chunk prefill, and
decode steps from the reference's own cache), 5e-3 after one (decode from
the port's own bf16 K/V cache or bf16 conv states, whose entries can land
one bf16 ulp from the reference's), 1e-1 for the bf16 configs.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.configs import registry as jregistry
from repro.models import model as jmodel
from repro.serve.engine import Engine as JEngine
from repro.serve.engine import ServeConfig as JServeConfig
from repro_torch.configs import get_config
from repro_torch.convert import bf16_from_bits, lm_cache_from_numpy, lm_params_from_numpy
from repro_torch.models import model as tmodel
from repro_torch.models.mamba2 import SsmState
from repro_torch.serve.engine import Engine, ServeConfig

ARCHS = ["qwen2-7b", "yi-6b", "smollm-360m", "granite-moe-1b-a400m", "grok-1-314b",
         "mamba2-1.3b", "musicgen-large", "internvl2-76b"]
MOE_ARCHS = ["granite-moe-1b-a400m", "grok-1-314b"]
EMBED_ARCHS = ["musicgen-large", "internvl2-76b"]
B, P, STEPS = 3, 24, 6  # batch, prompt (one 32-token SSD chunk of the ssm SMOKE), decode
TIGHT, CACHE_ROUNDING, BF16 = 1e-4, 5e-3, 1e-1
ONE_BF16_ULP = 2.0 ** -7


def _rel_err(got, want) -> float:
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.abs(got - want).max() / np.abs(want).max())


def _np(t) -> np.ndarray:
    return t.float().numpy() if isinstance(t, torch.Tensor) else np.asarray(t, np.float32)


class Pair:
    """The reference's and the port's SMOKE model of ``arch`` from the same
    weights (the reference's init, handed over as numpy), with engines."""

    def __init__(self, arch: str, dtype: str, batch: int, max_seq_len: int, seed: int = 0):
        from repro.utils.compat import make_mesh

        self.jcfg = dataclasses.replace(jget_config(arch, smoke=True), dtype=dtype)
        self.cfg = dataclasses.replace(get_config(arch, smoke=True), dtype=dtype)
        self.jparams = jmodel.init_params(self.jcfg, jax.random.PRNGKey(seed))
        self.params = lm_params_from_numpy(jax.tree_util.tree_map(np.asarray, self.jparams),
                                           self.cfg)
        self.jeng = JEngine(self.jcfg, make_mesh((1, 1), ("data", "model")), self.jparams,
                            JServeConfig(max_seq_len=max_seq_len, batch_size=batch))
        self.eng = Engine(self.cfg, self.params,
                          ServeConfig(max_seq_len=max_seq_len, batch_size=batch), device="cpu")

    def jax_steps(self, tokens, p, n):
        logits, cache = self.jeng.prefill(self.jparams, {"tokens": jnp.asarray(tokens[:, :p])})
        out, pre = [np.asarray(logits, np.float32)], cache
        cache = self.jeng._pad_cache(cache, p)
        for i in range(n - 1):
            logits, cache = self.jeng.decode(self.jparams, cache, {
                "token": jnp.asarray(tokens[:, p + i:p + i + 1]), "pos": jnp.int32(p + i)})
            out.append(np.asarray(logits, np.float32))
        return out, pre

    def port_steps(self, tokens, p, n, cache=None):
        t = torch.as_tensor(np.asarray(tokens), dtype=torch.long)
        logits, own = self.eng.prefill(self.params, {"tokens": t[:, :p]})
        out = [_np(logits)]
        cache = self.eng._pad_cache(own if cache is None else cache, p)
        for i in range(n - 1):
            logits, cache = self.eng.decode(self.params, cache, {"token": t[:, p + i:p + i + 1],
                                                                 "pos": p + i})
            out.append(_np(logits))
        return out, own


def _tokens(cfg, seed: int = 7):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size,
                                                (B, P + STEPS)).astype(np.int32)


@pytest.fixture(scope="module", params=ARCHS)
def f32_runs(request):
    pair = Pair(request.param, "float32", B, P + STEPS)
    tokens = _tokens(pair.cfg)
    want, jcache = pair.jax_steps(tokens, P, STEPS + 1)
    own, cache = pair.port_steps(tokens, P, STEPS + 1)
    ref_cache = lm_cache_from_numpy(jax.tree_util.tree_map(np.asarray, jcache))
    from_ref, _ = pair.port_steps(tokens, P, STEPS + 1, cache=ref_cache)
    return {"pair": pair, "want": want, "jcache": jcache, "own": own, "cache": cache,
            "ref_cache": ref_cache, "from_ref": from_ref}


def test_prefill_logits_f32(f32_runs):
    assert _rel_err(f32_runs["own"][0], f32_runs["want"][0]) <= TIGHT


def test_prefill_cache_f32(f32_runs):
    cfg, cache, want = f32_runs["pair"].cfg, f32_runs["cache"], f32_runs["ref_cache"]
    if cfg.family == "ssm":
        assert isinstance(cache, SsmState) and isinstance(want, SsmState)
        assert cache.h.shape == (cfg.n_layers, B, cfg.ssm_nheads, cfg.ssm_headdim,
                                 cfg.ssm_state)
        assert cache.conv_x.dtype == torch.bfloat16 and cache.h.dtype == torch.float32
        pairs = list(zip(cache, want))
    else:
        assert set(cache) == {"k", "v"}
        assert cache["k"].shape == (cfg.n_layers, B, P, cfg.n_kv_heads, cfg.resolved_head_dim)
        pairs = [(cache[n], want[n]) for n in ("k", "v")]
    for got, ref in pairs:
        assert got.shape == ref.shape and got.dtype == ref.dtype
        ref = _np(ref)
        # the second layer's inputs carry the first layer's roundings: the
        # states by the cache tolerance of their scale, K/V by one bf16 ulp
        atol = (CACHE_ROUNDING if cfg.family == "ssm" else 1e-6) * np.abs(ref).max()
        np.testing.assert_allclose(_np(got), ref, rtol=ONE_BF16_ULP, atol=atol)


def test_decode_steps_from_the_reference_cache_f32(f32_runs):
    """The first step reads only the reference's cache: 1e-4. Each step then
    writes its own token's entries, rounded to bf16 from f32 values that
    differ from the reference's in their last bits. The attention families
    read such an entry once, at its own position, and stay within 1e-4; the
    ssm family's rolling bf16 conv window feeds each one to the next three
    steps' convolutions (measured 5.6e-4 by step 4), so its later steps are
    held to the cache tolerance, 5e-3."""
    want, from_ref = f32_runs["want"], f32_runs["from_ref"]
    later = CACHE_ROUNDING if f32_runs["pair"].cfg.family == "ssm" else TIGHT
    for i in range(1, STEPS + 1):
        assert _rel_err(from_ref[i], want[i]) <= (TIGHT if i == 1 else later), i


def test_decode_steps_from_the_own_cache_f32(f32_runs):
    want, own = f32_runs["want"], f32_runs["own"]
    for i in range(1, STEPS + 1):
        assert _rel_err(own[i], want[i]) <= CACHE_ROUNDING, i


def test_decode_updates_the_cache_in_place(f32_runs):
    pair = f32_runs["pair"]
    t = torch.as_tensor(_tokens(pair.cfg)[:, :P + 1], dtype=torch.long)
    _, pre = pair.eng.prefill(pair.params, {"tokens": t[:, :P]})
    cache = pair.eng._pad_cache(pre, P)
    leaves = list(cache) if isinstance(cache, SsmState) else [cache["k"], cache["v"]]
    before = [x.clone() for x in leaves]
    _, out = pair.eng.decode(pair.params, cache, {"token": t[:, P:P + 1], "pos": P})
    assert out is cache
    assert any(not torch.equal(a, b) for a, b in zip(leaves, before))
    if not isinstance(cache, SsmState):  # the new entry at P, none after it
        assert torch.equal(cache["k"][:, :, :P], pre["k"])
        assert not cache["k"][:, :, P].eq(0).all() and cache["k"][:, :, P + 1:].eq(0).all()


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_bf16(arch):
    pair = Pair(arch, "bfloat16", B, P + STEPS, seed=1)
    tokens = _tokens(pair.cfg, seed=8)
    want, _ = pair.jax_steps(tokens, P, STEPS + 1)
    got, cache = pair.port_steps(tokens, P, STEPS + 1)
    leaf = cache.conv_x if isinstance(cache, SsmState) else cache["k"]
    assert leaf.dtype == torch.bfloat16
    for i in range(STEPS + 1):
        assert _rel_err(got[i], want[i]) <= BF16, i


def _check_greedy(got, want, ref_logits, vocab, tol):
    """Equal tokens up to a step where the reference's two best logits are
    within ``tol`` x max|logit| (a near tie either side may break)."""
    p = want.shape[1] - len(ref_logits)
    for i, lg in enumerate(ref_logits):
        if not np.array_equal(got[:, p + i], want[:, p + i]):
            top2 = np.sort(lg[:, :vocab], axis=-1)[:, -2:]
            gap = float((top2[:, 1] - top2[:, 0]).min())
            assert gap <= tol * np.abs(lg).max(), (i, gap)
            return i
    return len(ref_logits)


@pytest.mark.parametrize("arch", ARCHS)
def test_generate_matches_the_reference_engine(arch):
    b, p, n = 2, 12, 6  # prompt length != batch: the reference engine runs
    pair = Pair(arch, "float32", b, p + n, seed=2)
    prompts = np.random.default_rng(11).integers(0, pair.cfg.vocab_size, (b, p)).astype(np.int32)
    want = pair.jeng.generate(prompts, max_new_tokens=n)
    got = pair.eng.generate(prompts, max_new_tokens=n)
    assert got.shape == want.shape == (b, p + n) and got.dtype == want.dtype == np.int32
    np.testing.assert_array_equal(got[:, :p], prompts)
    ref_logits, _ = pair.jax_steps(want, p, n)
    assert _check_greedy(got, want, ref_logits, pair.cfg.vocab_size, CACHE_ROUNDING) >= 1


@pytest.mark.parametrize("arch", EMBED_ARCHS)
def test_prefill_from_embeds(arch):
    """The audio and vision front ends hand their frame or patch embeddings
    straight to the stack (``batch["embeds"]``), then decode from tokens."""
    pair = Pair(arch, "float32", B, P + 2, seed=3)
    rng = np.random.default_rng(9)
    emb = rng.standard_normal((B, P, pair.cfg.d_model)).astype(np.float32)
    want, jcache = pair.jeng.prefill(pair.jparams, {"embeds": jnp.asarray(emb)})
    got, cache = pair.eng.prefill(pair.params, {"embeds": torch.from_numpy(emb)})
    assert _rel_err(_np(got), want) <= TIGHT
    ref = lm_cache_from_numpy(jax.tree_util.tree_map(np.asarray, jcache))
    for n in ("k", "v"):
        np.testing.assert_allclose(_np(cache[n]), _np(ref[n]), rtol=ONE_BF16_ULP, atol=1e-6)
    tok = rng.integers(0, pair.cfg.vocab_size, (B, 1)).astype(np.int32)
    jlogits, _ = pair.jeng.decode(pair.jparams, pair.jeng._pad_cache(jcache, P),
                                  {"token": jnp.asarray(tok), "pos": jnp.int32(P)})
    logits, _ = pair.eng.decode(pair.params, pair.eng._pad_cache(ref, P),
                                {"token": torch.from_numpy(tok).long(), "pos": P})
    assert _rel_err(_np(logits), jlogits) <= TIGHT
    # a decode step may take an embedding in place of a token, as the reference's
    e1 = rng.standard_normal((B, 1, pair.cfg.d_model)).astype(np.float32)
    jlogits, _ = pair.jeng.decode(pair.jparams, pair.jeng._pad_cache(jcache, P),
                                  {"embed": jnp.asarray(e1), "pos": jnp.int32(P)})
    logits, _ = pair.eng.decode(pair.params, pair.eng._pad_cache(ref, P),
                                {"embed": torch.from_numpy(e1), "pos": P})
    assert _rel_err(_np(logits), jlogits) <= TIGHT


@pytest.mark.parametrize("arch", sorted(jregistry._MODULES))
def test_param_count_actual_is_the_references(arch):
    cfg, jcfg = get_config(arch), jget_config(arch)
    assert tmodel.param_count_actual(cfg) == jmodel.param_count_actual(jcfg)
    shapes = tmodel.param_shapes(get_config(arch, smoke=True))
    want = jax.tree_util.tree_map(lambda s: (s.shape, s.dtype.name),
                                  jmodel.param_shapes(jget_config(arch, smoke=True)))
    got = jax.tree_util.tree_map(
        lambda t: (tuple(t.shape), str(t.dtype).replace("torch.", "")), shapes,
        is_leaf=torch.is_tensor)
    assert got == want
    assert all(t.device.type == "meta" for t in jax.tree_util.tree_leaves(
        shapes, is_leaf=torch.is_tensor))


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_params_hand_over(arch):
    """The ``moe`` schema is the reference's and its parameters convert,
    the router and the expert stacks bit for bit."""
    cfg = get_config(arch, smoke=True)
    tmodel.check_ported(cfg)
    jp = jax.tree_util.tree_map(np.asarray, jmodel.init_params(jget_config(arch, smoke=True),
                                                               jax.random.PRNGKey(0)))
    tp = lm_params_from_numpy(jp, cfg)
    for name in ("router", "moe_wi", "moe_wg", "moe_wo"):
        a = jp["layers"][name]
        assert tuple(tp["layers"][name].shape) == a.shape
        assert torch.equal(tp["layers"][name], bf16_from_bits(a.view(np.uint16)))


def test_forward_aux_is_the_references(f32_runs, mesh1, rules):
    """The full-logits forward's aux loss: the sum of the ``moe`` blocks'
    load-balance losses (within 1e-6 of the reference's), 0 for the other
    families, as in the reference."""
    pair = f32_runs["pair"]
    tokens = _tokens(pair.cfg)[:, :P]
    _, _, want = jmodel.forward(pair.jcfg, mesh1, rules, pair.jparams, jnp.asarray(tokens),
                                mode="prefill")
    _, _, got = tmodel.forward(pair.cfg, pair.params, torch.as_tensor(tokens, dtype=torch.long))
    assert got.dtype == torch.float32 and got.shape == ()
    assert abs(float(got) - float(want)) <= 1e-6
    assert (float(got) > 0.5) == (pair.cfg.family == "moe")  # ~1 for near-uniform routing


def test_the_reference_bf16_bits_hand_over_for_every_family():
    for arch in ARCHS:
        jcfg, cfg = jget_config(arch, smoke=True), get_config(arch, smoke=True)
        jp = jax.tree_util.tree_map(np.asarray, jmodel.init_params(jcfg, jax.random.PRNGKey(4)))
        tp = lm_params_from_numpy(jp, cfg)
        a = jp["layers"]["wo"]
        assert a.dtype.name == "bfloat16"
        assert torch.equal(tp["layers"]["wo"], bf16_from_bits(a.view(np.uint16)))
