"""The port's LM serving path on the CPU against the JAX package: configs,
layers, the attention sublayer, the hybrid superblock, prefill and decode
logits and caches of zamba2-2.7b SMOKE, ``Engine.generate``, the parameter
hand-over, every family admitted, and a train forward that carries a grad."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.configs import registry as jregistry
from repro.configs.base import SHAPES as JSHAPES
from repro.models import layers as jlayers
from repro.models import model as jmodel
from repro.models import transformer as jtfm
from repro.models.layers import pack_bf16
from repro.serve.engine import Engine as JEngine
from repro.serve.engine import ServeConfig as JServeConfig
from repro_torch.configs import get_config
from repro_torch.configs import registry
from repro_torch.configs.base import SHAPES
from repro_torch.convert import bf16_from_bits, lm_cache_from_numpy, lm_params_from_numpy
from repro_torch.models import layers as tlayers
from repro_torch.models import model as tmodel
from repro_torch.models import transformer as ttfm
from repro_torch.serve.engine import Engine, ServeConfig

ARCH = "zamba2-2.7b"
B, P, STEPS = 3, 24, 8  # batch, prompt (one 32-token SSD chunk), decode steps
P_MULTI = 70  # three SSD chunks, the last one padded

# Tolerances on logits, as a fraction of max|reference logit|:
# float32, prompt within one SSD chunk, decode from the reference's cache:
#   f32 on both sides, sums in other orders: the acceptance bound, 1e-4.
# float32, decode from the port's own cache, or a multi-chunk prompt: the
#   bf16 K/V cache and the bf16 inter-chunk states are rounded from f32
#   values that differ from the reference's in their last bits, so a rounded
#   entry can land one bf16 ulp (up to 2^-7 of its value) away; measured up
#   to 1.7e-3 over 8 steps, hence 5e-3.
# bfloat16: both sides round every activation to bf16, but XLA keeps f32
#   between fused bf16 ops where torch rounds after each op; measured up to
#   5e-2 over prefill and 8 steps, hence 1e-1.
TIGHT, CACHE_ROUNDING, BF16 = 1e-4, 5e-3, 1e-1
ONE_BF16_ULP = 2.0 ** -7  # relative, at the low end of a binade


def _rel_err(got, want) -> float:
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.abs(got - want).max() / np.abs(want).max())


def _np(t) -> np.ndarray:
    return t.float().numpy() if isinstance(t, torch.Tensor) else np.asarray(t, np.float32)


def _ref(a) -> torch.Tensor:
    """A reference array as a tensor: its uint16 entries are bf16 bit patterns."""
    a = np.asarray(a)
    return bf16_from_bits(a) if a.dtype == np.uint16 else torch.from_numpy(np.array(a))


# -- configs -----------------------------------------------------------------


@pytest.mark.parametrize("arch", sorted(jregistry._MODULES))
def test_configs_are_the_references(arch):
    for smoke in (False, True):
        assert (dataclasses.asdict(get_config(arch, smoke=smoke))
                == dataclasses.asdict(jget_config(arch, smoke=smoke)))
    cfg = get_config(arch)
    assert cfg.param_count() == jget_config(arch).param_count()


def test_shapes_and_archs_are_the_references():
    assert {k: dataclasses.asdict(v) for k, v in SHAPES.items()} == {
        k: dataclasses.asdict(v) for k, v in JSHAPES.items()}
    assert registry.ASSIGNED_ARCHS == jregistry.ASSIGNED_ARCHS


# -- layers --------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_layers_match(dtype):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 5, 4, 16)).astype(np.float32)
    w = rng.standard_normal(16).astype(np.float32)
    jd, td = jnp.dtype(dtype), getattr(torch, dtype)
    tol = 1e-6 if dtype == "float32" else ONE_BF16_ULP
    got = tlayers.rmsnorm(torch.from_numpy(x).to(td), torch.from_numpy(w))
    assert got.dtype == td
    assert _rel_err(_np(got), jlayers.rmsnorm(jnp.asarray(x, jd), jnp.asarray(w))) <= tol
    pos = np.array([0, 3, 7, 100, 4095], np.int32)
    got = tlayers.apply_rope(torch.from_numpy(x).to(td), torch.from_numpy(pos), 1e4)
    assert _rel_err(_np(got), jlayers.apply_rope(jnp.asarray(x, jd), jnp.asarray(pos), 1e4)) <= tol
    h = rng.standard_normal((3, 16)).astype(np.float32)
    wi, wg = (rng.standard_normal((16, 32)).astype(np.float32) for _ in range(2))
    wo = rng.standard_normal((32, 16)).astype(np.float32)
    got = tlayers.swiglu(*(torch.from_numpy(a) for a in (h, wi, wg, wo)))
    assert _rel_err(_np(got), jlayers.swiglu(*(jnp.asarray(a) for a in (h, wi, wg, wo)))) <= 1e-5


# -- blocks --------------------------------------------------------------------


def _random_params(defs, rng):
    """Numpy values for a dict of ParamDefs: weights N(0, 1/fan_in), every
    other leaf (norms, biases, SSM scalars) N(1, 0.1) or N(0, 0.1) so that
    none is trivially 0 or 1."""
    out = {}
    for name, d in defs.items():
        if len(d.shape) >= 2 and d.init == "normal":
            out[name] = rng.standard_normal(d.shape) / np.sqrt(d.shape[-2])
        elif d.init in ("ones", "a_log"):
            out[name] = 1.0 + 0.1 * rng.standard_normal(d.shape)
        elif d.init == "dt_bias":
            out[name] = -4.6 + 0.1 * rng.standard_normal(d.shape)
        else:
            out[name] = 0.1 * rng.standard_normal(d.shape)
        out[name] = out[name].astype(np.float32)
    return out


@pytest.mark.parametrize("qkv_bias", [False, True])
def test_attention_sublayer_prefill_and_decode(qkv_bias, mesh1, rules):
    cfg = dataclasses.replace(get_config(ARCH, smoke=True), dtype="float32", qkv_bias=qkv_bias)
    jcfg = dataclasses.replace(jget_config(ARCH, smoke=True), dtype="float32", qkv_bias=qkv_bias)
    rng = np.random.default_rng(int(qkv_bias))
    p = _random_params(tmodel.param_defs(cfg)["shared"], rng)
    assert ("bq" in p) == qkv_bias
    jp = {k: jnp.asarray(v) for k, v in p.items()}
    tp = {k: torch.from_numpy(v) for k, v in p.items()}
    s, smax = 10, 16
    x = rng.standard_normal((2, s, cfg.d_model)).astype(np.float32)
    out_want, cache_want = jtfm.attention_sublayer(
        jcfg, mesh1, rules, jp, jnp.asarray(x), jnp.arange(s), "prefill")
    out, cache = ttfm.attention_sublayer(cfg, tp, torch.from_numpy(x), torch.arange(s), "prefill")
    assert _rel_err(_np(out), out_want) <= 2e-5
    for n in ("k", "v"):
        assert cache[n].dtype == torch.bfloat16
        np.testing.assert_allclose(_np(cache[n]), _np(_ref(cache_want[n])),
                                   rtol=ONE_BF16_ULP, atol=1e-6)
    # decode at pos 10 into a 16-slot cache holding the reference's prefill
    jcache = {n: jnp.pad(cache_want[n], ((0, 0), (0, smax - s), (0, 0), (0, 0)))
              for n in ("k", "v")}
    tcache = {n: _ref(jcache[n]) for n in ("k", "v")}
    xt = rng.standard_normal((2, 1, cfg.d_model)).astype(np.float32)
    out_want, new_want = jtfm.attention_sublayer(
        jcfg, mesh1, rules, jp, jnp.asarray(xt), jnp.full((1,), s), "decode", jcache, jnp.int32(s))
    out, new = ttfm.attention_sublayer(cfg, tp, torch.from_numpy(xt), torch.full((1,), s),
                                       "decode", tcache, s)
    assert new is tcache  # written in place
    assert _rel_err(_np(out), out_want) <= 2e-5
    for n in ("k", "v"):
        np.testing.assert_allclose(_np(new[n]), _np(_ref(new_want[n])),
                                   rtol=ONE_BF16_ULP, atol=1e-6)


def test_hybrid_superblock_prefill(mesh1, rules):
    cfg = dataclasses.replace(get_config(ARCH, smoke=True), dtype="float32")
    jcfg = dataclasses.replace(jget_config(ARCH, smoke=True), dtype="float32")
    rng = np.random.default_rng(5)
    defs = tmodel.param_defs(cfg)
    lead = {k: dataclasses.replace(d, shape=d.shape[1:]) for k, d in defs["layers"].items()}
    p_sb = _random_params(lead, rng)
    shared = _random_params(defs["shared"], rng)
    s = 40  # two SSD chunks: the states pass through the bf16 scan
    x = rng.standard_normal((2, s, cfg.d_model)).astype(np.float32)
    x_want, st_want, attn_want = jtfm.hybrid_superblock(
        jcfg, mesh1, rules, {k: jnp.asarray(v) for k, v in p_sb.items()},
        {k: jnp.asarray(v) for k, v in shared.items()}, jnp.asarray(x), jnp.arange(s), "prefill")
    x_got, st, attn = ttfm.hybrid_superblock(
        cfg, {k: torch.from_numpy(v) for k, v in p_sb.items()},
        {k: torch.from_numpy(v) for k, v in shared.items()}, torch.from_numpy(x),
        torch.arange(s), "prefill")
    assert _rel_err(_np(x_got), x_want) <= CACHE_ROUNDING
    assert st.h.shape == (cfg.hybrid_period, 2, cfg.ssm_nheads, cfg.ssm_headdim, cfg.ssm_state)
    # the second layer's inputs already carry the first layer's bf16-state
    # differences, so its states are held to CACHE_ROUNDING of their scale
    for got, want in zip(st, st_want):
        want = _np(_ref(want))
        np.testing.assert_allclose(_np(got), want, rtol=ONE_BF16_ULP,
                                   atol=CACHE_ROUNDING * np.abs(want).max())
    for n in ("k", "v"):
        np.testing.assert_allclose(_np(attn[n]), _np(_ref(attn_want[n])),
                                   rtol=ONE_BF16_ULP, atol=1e-6)


# -- the model: prefill and decode of zamba2 SMOKE ------------------------------


class Pair:
    """The reference's and the port's SMOKE model from the same weights
    (the reference's init, handed over as numpy), with engines."""

    def __init__(self, dtype: str, batch: int, max_seq_len: int):
        self.jcfg = dataclasses.replace(jget_config(ARCH, smoke=True), dtype=dtype)
        self.cfg = dataclasses.replace(get_config(ARCH, smoke=True), dtype=dtype)
        from repro.utils.compat import make_mesh

        self.jparams = jmodel.init_params(self.jcfg, jax.random.PRNGKey(0))
        self.params = lm_params_from_numpy(jax.tree_util.tree_map(np.asarray, self.jparams),
                                           self.cfg)
        self.jeng = JEngine(self.jcfg, make_mesh((1, 1), ("data", "model")), self.jparams,
                            JServeConfig(max_seq_len=max_seq_len, batch_size=batch))
        self.eng = Engine(self.cfg, self.params,
                          ServeConfig(max_seq_len=max_seq_len, batch_size=batch), device="cpu")

    def jax_steps(self, tokens, p, n):
        """Reference: prefill tokens[:, :p], then n - 1 decode steps fed
        with tokens[:, p + i]. Returns the n logits and the prefill cache."""
        logits, cache = self.jeng.prefill(self.jparams, {"tokens": jnp.asarray(tokens[:, :p])})
        out, pre = [np.asarray(logits, np.float32)], cache
        cache = self.jeng._pad_cache(cache, p)
        for i in range(n - 1):
            logits, cache = self.jeng.decode(self.jparams, cache, {
                "token": jnp.asarray(tokens[:, p + i:p + i + 1]), "pos": jnp.int32(p + i)})
            out.append(np.asarray(logits, np.float32))
        return out, pre

    def port_steps(self, tokens, p, n, cache=None):
        """The same on the port; ``cache`` (the prefill cache to decode
        from, e.g. the reference's) replaces the port's own."""
        t = torch.as_tensor(np.asarray(tokens), dtype=torch.long)
        logits, own = self.eng.prefill(self.params, {"tokens": t[:, :p]})
        out = [_np(logits)]
        cache = self.eng._pad_cache(own if cache is None else cache, p)
        for i in range(n - 1):
            logits, cache = self.eng.decode(self.params, cache, {"token": t[:, p + i:p + i + 1],
                                                                 "pos": p + i})
            out.append(_np(logits))
        return out, own


@pytest.fixture(scope="module")
def f32_pair():
    return Pair("float32", B, P_MULTI + STEPS)


@pytest.fixture(scope="module")
def tokens():
    return np.random.default_rng(7).integers(0, 256, (B, P_MULTI + STEPS)).astype(np.int32)


@pytest.fixture(scope="module")
def f32_runs(f32_pair, tokens):
    want, jcache = f32_pair.jax_steps(tokens, P, STEPS + 1)
    own, cache = f32_pair.port_steps(tokens, P, STEPS + 1)
    from_ref, _ = f32_pair.port_steps(
        tokens, P, STEPS + 1, cache=lm_cache_from_numpy(jax.tree_util.tree_map(np.asarray, jcache)))
    return want, jcache, own, cache, from_ref


def test_prefill_logits_f32(f32_runs):
    want, _, own, _, _ = f32_runs
    assert _rel_err(own[0], want[0]) <= TIGHT


def test_prefill_cache_f32(f32_runs, f32_pair):
    _, jcache, _, cache, _ = f32_runs
    want = lm_cache_from_numpy(jax.tree_util.tree_map(np.asarray, jcache))
    cfg = f32_pair.cfg
    n_sb = cfg.n_layers // cfg.hybrid_period
    assert cache["attn"]["k"].shape == (n_sb, B, P, cfg.n_kv_heads, cfg.resolved_head_dim)
    assert cache["ssm"].conv_x.dtype == torch.bfloat16 and cache["ssm"].h.dtype == torch.float32
    pairs = [(cache["attn"][n], want["attn"][n]) for n in ("k", "v")] + list(
        zip(cache["ssm"], want["ssm"]))
    for got, ref in pairs:
        assert got.shape == ref.shape and got.dtype == ref.dtype
        ref = _np(ref)
        np.testing.assert_allclose(_np(got), ref, rtol=ONE_BF16_ULP, atol=1e-6 * np.abs(ref).max())


def test_decode_steps_from_the_reference_cache_f32(f32_runs):
    want, _, _, _, from_ref = f32_runs
    for i in range(1, STEPS + 1):
        assert _rel_err(from_ref[i], want[i]) <= TIGHT, i


def test_decode_steps_from_the_own_cache_f32(f32_runs):
    want, _, own, _, _ = f32_runs
    for i in range(1, STEPS + 1):
        assert _rel_err(own[i], want[i]) <= CACHE_ROUNDING, i


def test_multi_chunk_prefill_f32(f32_pair, tokens):
    want, _ = f32_pair.jax_steps(tokens, P_MULTI, 1)
    got, _ = f32_pair.port_steps(tokens, P_MULTI, 1)
    assert _rel_err(got[0], want[0]) <= CACHE_ROUNDING


def test_prefill_and_decode_bf16(tokens):
    pair = Pair("bfloat16", B, P + STEPS + 1)
    want, _ = pair.jax_steps(tokens, P, STEPS + 1)
    got, cache = pair.port_steps(tokens, P, STEPS + 1)
    assert pair.params["layers"]["wx"].dtype == torch.bfloat16
    assert cache["attn"]["k"].dtype == torch.bfloat16
    for i in range(STEPS + 1):
        assert _rel_err(got[i], want[i]) <= BF16, i


def test_full_logits_forward_matches(f32_pair, tokens, mesh1, rules):
    want, _, _ = jmodel.forward(f32_pair.jcfg, mesh1, rules, f32_pair.jparams,
                                tokens=jnp.asarray(tokens[:, :P]), mode="prefill")
    got, _, aux = tmodel.forward(f32_pair.cfg, f32_pair.params,
                                 torch.as_tensor(tokens[:, :P]).long(), mode="prefill")
    assert got.shape == (B, P, f32_pair.cfg.padded_vocab) and float(aux) == 0.0
    assert _rel_err(_np(got), want) <= TIGHT


# -- generate ------------------------------------------------------------------


def _check_greedy(got, want, ref_logits, vocab, tol):
    """Equal tokens up to a step where the reference's two best logits are
    within ``tol`` x max|logit| of each other (a near tie either side may
    break the other way). Returns the steps compared."""
    p = want.shape[1] - len(ref_logits)
    for i, lg in enumerate(ref_logits):
        if not np.array_equal(got[:, p + i], want[:, p + i]):
            top2 = np.sort(lg[:, :vocab], axis=-1)[:, -2:]
            gap = float((top2[:, 1] - top2[:, 0]).min())
            assert gap <= tol * np.abs(lg).max(), (i, gap)
            return i
    return len(ref_logits)


def test_generate_matches_the_reference_engine():
    b, p, n = 2, 12, 8  # prompt length != batch: the reference engine runs
    pair = Pair("float32", b, p + n)
    prompts = np.random.default_rng(11).integers(0, pair.cfg.vocab_size, (b, p)).astype(np.int32)
    want = pair.jeng.generate(prompts, max_new_tokens=n)
    got = pair.eng.generate(prompts, max_new_tokens=n)
    assert got.shape == want.shape == (b, p + n) and got.dtype == want.dtype == np.int32
    np.testing.assert_array_equal(got[:, :p], prompts)
    ref_logits, _ = pair.jax_steps(want, p, n)
    assert _check_greedy(got, want, ref_logits, pair.cfg.vocab_size, CACHE_ROUNDING) >= 1


def test_generate_zero_new_tokens_matches_the_reference_engine():
    """``max_new_tokens=0`` runs the prefill and returns the prompts, int32
    as the reference's; a negative count or one past the budget raises."""
    b, p = 2, 12
    pair = Pair("float32", b, p + 4)
    prompts = np.random.default_rng(14).integers(0, pair.cfg.vocab_size, (b, p))
    assert prompts.dtype == np.int64
    want = pair.jeng.generate(prompts, max_new_tokens=0)
    prefills = []
    prefill = pair.eng.prefill
    pair.eng.prefill = lambda *a: prefills.append(1) or prefill(*a)
    got = pair.eng.generate(prompts, max_new_tokens=0)
    assert len(prefills) == 1
    assert got.dtype == want.dtype == np.int32 and got.shape == want.shape == (b, p)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, prompts)
    for bad in (-1, 5):
        with pytest.raises(ValueError, match="budget"):
            pair.eng.generate(prompts, max_new_tokens=bad)


def test_generate_with_prompt_length_equal_to_batch():
    """Prompt length == batch: the port grows the attention cache by name,
    so the conv states (batch on their axis -3) stay as they are, and each
    token is the greedy choice of a fresh prefill of the sequence so far."""
    b = p = 3
    n = 5
    cfg = dataclasses.replace(get_config(ARCH, smoke=True), dtype="float32")
    params = tmodel.init_params(cfg, torch.Generator().manual_seed(3), device="cpu")
    eng = Engine(cfg, params, ServeConfig(max_seq_len=p + n, batch_size=b), device="cpu")
    prompts = np.random.default_rng(12).integers(0, cfg.vocab_size, (b, p))
    out = eng.generate(prompts, max_new_tokens=n)
    assert out.shape == (b, p + n) and np.array_equal(out[:, :p], prompts)
    _, cache = eng.prefill(params, {"tokens": torch.as_tensor(prompts)})
    grown = eng._pad_cache(cache, p)
    assert grown["attn"]["k"].shape[-3] == p + n
    for got, was in zip(grown["ssm"], cache["ssm"]):
        assert got.shape == was.shape and torch.equal(got, was)
    fresh = [_np(eng.prefill(params, {"tokens": torch.as_tensor(out[:, :p + i])})[0])
             for i in range(n)]
    assert _check_greedy(out, out, fresh, cfg.vocab_size, CACHE_ROUNDING) == n
    for i, lg in enumerate(fresh):  # each generated token is the fresh prefill's argmax
        top2 = np.sort(lg[:, :cfg.vocab_size], axis=-1)[:, -2:]
        clear = (top2[:, 1] - top2[:, 0]) > CACHE_ROUNDING * np.abs(lg).max()
        np.testing.assert_array_equal(out[clear, p + i], lg[clear, :cfg.vocab_size].argmax(-1))


def test_generate_stops_rows_at_eos():
    cfg = get_config(ARCH, smoke=True)
    params = tmodel.init_params(cfg, torch.Generator().manual_seed(4), device="cpu")
    eng = Engine(cfg, params, ServeConfig(max_seq_len=16, batch_size=2), device="cpu")
    prompts = np.random.default_rng(13).integers(0, cfg.vocab_size, (2, 4))
    free = eng.generate(prompts, max_new_tokens=6)
    eos = int(free[0, 5])  # row 0's second new token
    out = eng.generate(prompts, max_new_tokens=6, eos_id=eos)
    np.testing.assert_array_equal(out[:, :6], free[:, :6])
    assert (out[0, 5:] == eos).all()


# -- parameters ------------------------------------------------------------------


def test_params_from_numpy_are_bit_exact_on_bf16_leaves():
    jcfg, cfg = jget_config(ARCH, smoke=True), get_config(ARCH, smoke=True)
    jp = jax.tree_util.tree_map(np.asarray, jmodel.init_params(jcfg, jax.random.PRNGKey(1)))
    tp = lm_params_from_numpy(jp, cfg)
    jleaves = jax.tree_util.tree_leaves_with_path(jp)
    assert len(jleaves) == len(list(jax.tree_util.tree_leaves(tp, is_leaf=torch.is_tensor)))
    n_bf16 = 0
    for path, a in jleaves:
        t = tp
        for key in path:
            t = t[key.key]
        if a.dtype.name == "bfloat16":
            n_bf16 += 1
            assert t.dtype == torch.bfloat16
            np.testing.assert_array_equal(t.view(torch.int16).numpy().view(np.uint16),
                                          a.view(np.uint16))
        else:
            assert t.dtype == torch.float32 and np.array_equal(t.numpy(), a)
    assert n_bf16 > 10


def test_params_from_numpy_check_the_schema():
    cfg = get_config(ARCH, smoke=True)
    jp = jax.tree_util.tree_map(np.asarray, jmodel.init_params(
        jget_config(ARCH, smoke=True), jax.random.PRNGKey(2)))
    jp["shared"]["wq"] = jp["shared"]["wq"][:, :-1]
    with pytest.raises(ValueError, match="shared/wq"):
        lm_params_from_numpy(jp, cfg)


def test_reference_cache_converts_to_bf16():
    a = np.arange(6, dtype=np.float32).reshape(2, 3)
    packed = np.asarray(pack_bf16(jnp.asarray(a).astype(jnp.bfloat16)))
    assert packed.dtype == np.uint16
    t = bf16_from_bits(packed)
    assert t.dtype == torch.bfloat16 and np.array_equal(t.float().numpy(), a)
    with pytest.raises(ValueError, match="uint16"):
        bf16_from_bits(a)


def test_init_params_follow_the_schema_and_seed():
    cfg = get_config(ARCH, smoke=True)
    p1 = tmodel.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    p2 = tmodel.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    shapes = jax.tree_util.tree_map(lambda s: (s.shape, s.dtype.name),
                                    jmodel.param_shapes(jget_config(ARCH, smoke=True)))
    got = jax.tree_util.tree_map(lambda t: (tuple(t.shape), str(t.dtype).replace("torch.", "")),
                                 p1, is_leaf=torch.is_tensor)
    assert got == shapes
    for a, b in zip(jax.tree_util.tree_leaves(p1, is_leaf=torch.is_tensor),
                    jax.tree_util.tree_leaves(p2, is_leaf=torch.is_tensor)):
        assert torch.equal(a, b)
    assert torch.equal(p1["final_norm"], torch.ones(cfg.d_model))
    assert float(p1["layers"]["dt_bias"][0, 0, 0]) == pytest.approx(-4.6)
    np.testing.assert_allclose(p1["layers"]["a_log"][1, 0].numpy(),
                               np.log(np.linspace(1, 16, cfg.ssm_nheads)), rtol=1e-6)
    w = p1["layers"]["wx"].float()
    assert abs(float(w.std()) * np.sqrt(cfg.d_model) - 1) < 0.05


# -- what is not ported ------------------------------------------------------------


@pytest.mark.parametrize("arch", [a for a in sorted(jregistry._MODULES)
                                  if jget_config(a).family != "hybrid"])
def test_unported_families_raise(arch):
    """No family is left unported: every one beside ``hybrid`` (``dense``,
    ``moe``, ``ssm``, ``audio`` and ``vlm``) is admitted at every entry
    point, and its schema is the reference's."""
    cfg = get_config(arch, smoke=True)
    shapes = jax.tree_util.tree_map(lambda s: s.shape, jmodel.param_shapes(
        jget_config(arch, smoke=True)))
    assert jax.tree_util.tree_map(lambda d: d.shape, tmodel.param_defs(cfg),
                                  is_leaf=lambda d: isinstance(d, tmodel.ParamDef)) == shapes
    assert cfg.family in tmodel.PORTED_FAMILIES
    tmodel.check_ported(cfg)
    tmodel.make_prefill_step(cfg)
    tmodel.make_serve_step(cfg)
    params = tmodel.param_shapes(cfg)  # meta tensors: admitted without allocating
    with pytest.raises(ValueError, match="params on meta"):
        Engine(cfg, params, ServeConfig(), device="cpu")


def test_sampling_and_training_raise():
    """Sampling is ported (``tests/test_torch_sampling.py``), and so is
    training (``tests/test_torch_train.py``): neither raises any more, and
    ``forward(mode="train")`` returns logits that carry a grad (the name is
    kept from when both raised)."""
    cfg = get_config(ARCH, smoke=True)
    params = tmodel.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    Engine(cfg, params, ServeConfig(temperature=0.7), device="cpu")
    params = jax.tree_util.tree_map(lambda t: t.requires_grad_(), params)
    logits, cache, _ = tmodel.forward(cfg, params, torch.zeros((1, 4), dtype=torch.long),
                                      mode="train")
    assert cache is None and logits.requires_grad and logits.grad_fn is not None


def test_entry_points_default_to_the_card():
    cfg = get_config(ARCH, smoke=True)
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default runs there")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tmodel.init_params(cfg, torch.Generator().manual_seed(0))
    params = tmodel.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Engine(cfg, params)
