"""Sampling with ``temperature > 0`` in the port's ``Engine`` on the CPU:
argmax at ``temperature <= 0``; draws from softmax(logits[:V] / T) (a
chi-square test against that law, with a fixed seed, at p >= 1e-6); a
seeded generator repeats its draws; padded-vocab columns are never drawn,
in either package; a row with one dominant logit gives the reference's
token; ``generate`` at T > 0 holds rows that reached ``eos_id``.

The reference draws with ``jax.random.categorical`` from an unseeded key,
so the two packages are compared by law, not draw for draw.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy import stats

from repro.configs import get_config as jget_config
from repro.models import model as jmodel
from repro.serve.engine import Engine as JEngine
from repro.serve.engine import ServeConfig as JServeConfig
from repro.utils.compat import make_mesh
from repro_torch.configs import get_config
from repro_torch.convert import lm_params_from_numpy
from repro_torch.models import model as tmodel
from repro_torch.serve.engine import Engine, ServeConfig

ARCH = "granite-moe-1b-a400m"
T = 0.8
MIN_P = 1e-6  # the chi-square test's p-value floor
N_DRAWS = 2 ** 18


@pytest.fixture(scope="module")
def cfg():
    return dataclasses.replace(get_config(ARCH, smoke=True), dtype="float32")


@pytest.fixture(scope="module")
def params(cfg):
    return tmodel.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")


def _engine(cfg, params, temperature=T, seed=None, batch=2, max_seq_len=32):
    gen = None if seed is None else torch.Generator().manual_seed(seed)
    return Engine(cfg, params, ServeConfig(max_seq_len=max_seq_len, batch_size=batch,
                                           temperature=temperature), device="cpu", generator=gen)


def _logits(cfg, rows: int, seed: int = 0) -> torch.Tensor:
    """Random (rows, Vp) logits, the padded columns far above the rest."""
    g = torch.Generator().manual_seed(seed)
    lg = 2.0 * torch.randn((rows, cfg.padded_vocab), generator=g)
    lg[:, cfg.vocab_size:] = 1e4
    return lg


def chi_square_p(counts: np.ndarray, probs: np.ndarray) -> float:
    """The chi-square test's p-value of ``counts`` against ``probs``, the
    bins whose expected count is below 5 pooled into one."""
    n = counts.sum()
    expected = n * probs
    small = expected < 5
    obs = np.append(counts[~small], counts[small].sum())
    exp = np.append(expected[~small], expected[small].sum())
    if exp[-1] == 0:
        obs, exp = obs[:-1], exp[:-1]
    stat = float(((obs - exp) ** 2 / exp).sum())
    return float(stats.chi2.sf(stat, len(obs) - 1))


@pytest.mark.parametrize("temperature", [0.0, -1.0])
def test_greedy_at_zero_or_negative_temperature(cfg, params, temperature):
    eng = _engine(cfg, params, temperature=temperature, batch=64)
    lg = _logits(cfg, 64)
    got = eng._sample(lg)
    assert torch.equal(got, torch.argmax(lg[:, :cfg.vocab_size], dim=-1))


def test_a_seeded_generator_repeats_its_draws(cfg, params):
    lg = _logits(cfg, 64)
    a, b = _engine(cfg, params, seed=5), _engine(cfg, params, seed=5)
    first = [a._sample(lg) for _ in range(3)]
    assert all(torch.equal(x, y) for x, y in zip(first, (b._sample(lg) for _ in range(3))))
    assert not torch.equal(first[0], first[1])  # the generator moves on
    other = _engine(cfg, params, seed=6)._sample(lg)
    assert not torch.equal(other, first[0])
    # without a generator the engine seeds its own from fresh entropy
    assert not torch.equal(_engine(cfg, params)._sample(lg), _engine(cfg, params)._sample(lg))


def test_draws_follow_the_softmax_law(cfg, params):
    eng = _engine(cfg, params, seed=11)
    row = _logits(cfg, 1, seed=3)[0]
    draws = torch.cat([eng._sample(row.expand(2 ** 14, -1)) for _ in range(N_DRAWS // 2 ** 14)])
    assert draws.shape == (N_DRAWS,) and int(draws.max()) < cfg.vocab_size
    counts = np.bincount(draws.numpy(), minlength=cfg.vocab_size)
    probs = torch.softmax(row[:cfg.vocab_size].double() / T, dim=-1).numpy()
    assert chi_square_p(counts, probs) >= MIN_P
    # the test can tell: the same draws against the law at another temperature fail it
    assert chi_square_p(counts, torch.softmax(row[:cfg.vocab_size].double() / (1.2 * T),
                                              dim=-1).numpy()) < MIN_P


def test_padded_vocab_is_never_drawn_in_either_package(cfg, params):
    lg = _logits(cfg, 4096)
    got = _engine(cfg, params, seed=1)._sample(lg)
    assert int(got.max()) < cfg.vocab_size
    jcfg = jget_config(ARCH, smoke=True)
    jeng = JEngine.__new__(JEngine)  # only _sample: no mesh, no compiled steps
    jeng.cfg, jeng.scfg = jcfg, JServeConfig(temperature=T)
    want = np.asarray(jeng._sample(jnp.asarray(lg.numpy())))
    assert int(want.max()) < jcfg.vocab_size
    # both draw from the same law: their histograms over the first 8 tokens agree
    counts = [np.bincount(np.asarray(x).ravel(), minlength=cfg.vocab_size)[:8]
              for x in (got.numpy(), want)]
    assert np.abs(counts[0] - counts[1]).max() <= 5 * np.sqrt(max(counts[1].max(), 1)) + 5


def test_a_dominant_logit_gives_the_references_token(cfg, params):
    g = torch.Generator().manual_seed(7)
    lg = torch.randn((8, cfg.padded_vocab), generator=g)
    winners = torch.randint(0, cfg.vocab_size, (8,), generator=g)
    lg[torch.arange(8), winners] += 60.0  # exp(60 / 0.8) against the rest
    got = _engine(cfg, params, seed=2)._sample(lg)
    jeng = JEngine.__new__(JEngine)
    jeng.cfg, jeng.scfg = jget_config(ARCH, smoke=True), JServeConfig(temperature=T)
    want = np.asarray(jeng._sample(jnp.asarray(lg.numpy())))
    np.testing.assert_array_equal(got.numpy(), winners.numpy())
    np.testing.assert_array_equal(want, winners.numpy())


def test_generate_at_temperature_repeats_and_holds_rows_at_eos(cfg, params):
    prompts = np.random.default_rng(13).integers(0, cfg.vocab_size, (2, 5))
    out = _engine(cfg, params, seed=9).generate(prompts, max_new_tokens=8)
    again = _engine(cfg, params, seed=9).generate(prompts, max_new_tokens=8)
    np.testing.assert_array_equal(out, again)
    np.testing.assert_array_equal(out[:, :5], prompts)
    assert out.dtype == np.int32 and int(out.max()) < cfg.vocab_size
    greedy = _engine(cfg, params, temperature=0.0).generate(prompts, max_new_tokens=8)
    assert not np.array_equal(out, greedy)
    eos = int(out[0, 6])  # row 0's second new token
    held = _engine(cfg, params, seed=9).generate(prompts, max_new_tokens=8, eos_id=eos)
    np.testing.assert_array_equal(held[:, :7], out[:, :7])
    assert (held[0, 6:] == eos).all()


def test_generate_at_temperature_draws_like_the_reference(cfg):
    """One step of ``generate`` at T > 0 from the reference's weights: the
    port's first new tokens, the prompt repeated over a batch of 512, follow
    the law of the reference's prefill logits of the prompt alone
    (chi-square, p >= 1e-6). A capacity factor of E lets every expert take
    every token, so the batch's routing drops none and each row's logits
    are the prompt's alone."""
    cf = float(cfg.n_experts)
    cfg = dataclasses.replace(cfg, capacity_factor=cf)
    jcfg = dataclasses.replace(jget_config(ARCH, smoke=True), dtype="float32", capacity_factor=cf)
    jparams = jmodel.init_params(jcfg, jax.random.PRNGKey(1))
    jeng = JEngine(jcfg, make_mesh((1, 1), ("data", "model")), jparams,
                   JServeConfig(max_seq_len=16, batch_size=1))
    prompt = np.random.default_rng(5).integers(0, cfg.vocab_size, (1, 6)).astype(np.int32)
    jlogits, _ = jeng.prefill(jparams, {"tokens": jnp.asarray(prompt)})
    probs = torch.softmax(torch.from_numpy(np.asarray(jlogits, np.float64)[0, :cfg.vocab_size])
                          / T, dim=-1).numpy()
    tparams = lm_params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams), cfg)
    batch = 512
    eng = _engine(cfg, tparams, seed=21, batch=batch, max_seq_len=16)
    firsts = [eng.generate(np.repeat(prompt, batch, 0), max_new_tokens=1)[:, -1]
              for _ in range(16)]
    counts = np.bincount(np.concatenate(firsts), minlength=cfg.vocab_size)
    assert chi_square_p(counts, probs) >= MIN_P
