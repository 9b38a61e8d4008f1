"""QRP gradient compression in repro_torch (``optim/compression.py``) and its
bench (``launch/compress_bench.py``) on the CPU, against the reference's
``repro.optim.compression`` on the same numpy inputs.

These twin the reference's own tests (``tests/test_optim.py``): exact at
the true rank, error feedback recovers the mean gradient, the ratio; and
more: ``min_elements`` passes small leaves through, a tree of mixed leaves
(a stack whose leading dims collapse, bf16, a bias, a nested dict) against
the reference's ``compress_grads_for_slow_axis`` without a slow axis, and
the bench's matrices, byte model and one-rank run. The 2-rank path (a gloo
group) runs in ``tests/test_torch_shard.py``'s world of 2.

Inputs with a rank-r part are drawn with 1e-3 noise beside it: full rank,
since the Gram form of QRP returns NaN on a rank-deficient matrix in both
packages (ROADMAP.md queue 3), and a gap in the spectrum, so that the two
packages' pivots (and so their Q) agree. Tolerances: Q P^T within 1e-4 x
max|G| of the reference's (f32 QRP in two libraries' orders); against G
itself at the true rank 1e-3 x max|G| (the noise).
"""
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.optim import compression as jcomp
from repro_torch.configs import get_config
from repro_torch.launch import compress_bench as cb
from repro_torch.optim import compression as comp


def _low_rank(rng, m, n, r, noise=1e-3):
    return (rng.standard_normal((m, r)) @ rng.standard_normal((r, n))
            + noise * rng.standard_normal((m, n))).astype(np.float32)


def _close(got, want, rel=1e-4):
    want = np.asarray(want, dtype=np.float32)
    np.testing.assert_allclose(np.asarray(got, dtype=np.float32), want, rtol=0,
                               atol=rel * max(np.abs(want).max(), 1e-30))


@pytest.mark.parametrize("m,n,r", [(64, 48, 8), (30, 90, 5), (24, 1024, 24)])
def test_compression_exact_at_the_true_rank(m, n, r):
    g = _low_rank(np.random.default_rng(m + n), m, n, r)
    q, p = comp.compress_matrix(torch.from_numpy(g), r)
    jq, jp = jcomp.compress_matrix(jnp.asarray(g), r)
    assert q.shape == (m, min(r, m, n)) and p.shape == (n, min(r, m, n))
    got = comp.decompress_matrix(q, p).numpy()
    _close(got, g, 1e-3)
    _close(got, np.asarray(jcomp.decompress_matrix(jq, jp)))
    _close(q @ q.T, np.asarray(jq @ jq.T))


def test_compression_error_feedback_recovers():
    """With error feedback the mean of the delivered gradients converges to
    the true gradient (the PowerSGD property, the reference's own test's
    bound); the first steps match the reference's step for step (its 40
    steps are its own test's)."""
    rng = np.random.default_rng(1)
    g_true = rng.standard_normal((32, 32)).astype(np.float32)
    cfg = comp.CompressionConfig(rank=4, min_elements=1)
    jcfg = jcomp.CompressionConfig(rank=4, min_elements=1)
    err, jerr = None, None
    acc = np.zeros_like(g_true)
    for step in range(40):
        red, err = comp.compress_grads_for_slow_axis({"w": torch.from_numpy(g_true)}, cfg, err,
                                                     axis_present=False)
        acc += red["w"].numpy()
        if step < 3:  # before the feedback's rounding can drift the two pivots apart
            jred, jerr = jcomp.compress_grads_for_slow_axis({"w": jnp.asarray(g_true)}, jcfg,
                                                            jerr, axis_present=False)
            _close(red["w"].numpy(), np.asarray(jred["w"]), 1e-3)
            _close(err["w"].numpy(), np.asarray(jerr["w"]), 1e-3)
    np.testing.assert_allclose(acc / 40, g_true, atol=0.35 * np.abs(g_true).max())


@pytest.mark.parametrize("m,n,r", [(4096, 11008, 64), (24, 1024, 64), (100, 100, 7)])
def test_compression_ratio(m, n, r):
    assert comp.compression_ratio_matrix(m, n, r) == jcomp.compression_ratio_matrix(m, n, r)
    assert comp.compression_ratio_matrix(4096, 11008, 64) > 30


def test_min_elements_passes_small_leaves_through():
    rng = np.random.default_rng(2)
    grads = {"b": torch.from_numpy(rng.standard_normal(16).astype(np.float32)),
             "small": torch.from_numpy(_low_rank(rng, 8, 8, 2)),
             "w": torch.from_numpy(_low_rank(rng, 64, 48, 3))}
    cfg = comp.CompressionConfig(rank=3, min_elements=100)
    red, err = comp.compress_grads_for_slow_axis(grads, cfg, axis_present=False)
    for k in ("b", "small"):
        assert torch.equal(red[k], grads[k]) and not err[k].any()
    assert not torch.equal(red["w"], grads["w"])
    _close(red["w"] + err["w"], grads["w"].numpy(), 1e-6)
    # no process group: axis_present=True is the identity reduce too (a world of one)
    red1, _ = comp.compress_grads_for_slow_axis(grads, cfg, axis_present=True)
    assert all(torch.equal(red1[k], red[k]) for k in grads)


def test_tree_of_mixed_leaves_matches_the_reference():
    rng = np.random.default_rng(3)
    stack = _low_rank(rng, 24, 20, 4).reshape(3, 8, 20)
    tree = {"layers": {"stack": stack, "bias": rng.standard_normal(20).astype(np.float32),
                       "bf16": _low_rank(rng, 40, 30, 4)},
            "head": _low_rank(rng, 50, 16, 4)}
    err0 = {"layers": {"stack": 0.01 * rng.standard_normal((3, 8, 20)).astype(np.float32),
                       "bias": np.zeros(20, np.float32), "bf16": np.zeros((40, 30), np.float32)},
            "head": np.zeros((50, 16), np.float32)}

    def port_leaf(path, x):
        t = torch.from_numpy(np.asarray(x))
        return t.to(torch.bfloat16) if path == "bf16" else t

    def jax_leaf(path, x):
        return jnp.asarray(x, dtype=jnp.bfloat16 if path == "bf16" else jnp.float32)

    def build(fn, t):
        return {"layers": {k: fn(k, v) for k, v in t["layers"].items()}, "head": fn("head",
                                                                                    t["head"])}

    cfg = comp.CompressionConfig(rank=4, min_elements=200)
    jcfg = jcomp.CompressionConfig(rank=4, min_elements=200)
    red, err = comp.compress_grads_for_slow_axis(build(port_leaf, tree), cfg,
                                                 build(port_leaf, err0), axis_present=False)
    jred, jerr = jcomp.compress_grads_for_slow_axis(build(jax_leaf, tree), jcfg,
                                                    build(jax_leaf, err0), axis_present=False)
    assert list(red) == ["layers", "head"] and list(red["layers"]) == ["stack", "bias", "bf16"]
    for got, want, gerr, werr, key in [
            (red["head"], jred["head"], err["head"], jerr["head"], "head"),
            *((red["layers"][k], jred["layers"][k], err["layers"][k], jerr["layers"][k], k)
              for k in ("stack", "bias", "bf16"))]:
        assert tuple(got.shape) == tuple(want.shape), key
        assert str(got.dtype).split(".")[-1] == str(want.dtype), key
        rel = 2.0 ** -7 if key == "bf16" else 1e-4  # one bf16 rounding of G_hat
        _close(got.float().numpy(), np.asarray(want, dtype=np.float32), rel)
        _close(gerr.float().numpy() + got.float().numpy(),
               np.asarray(werr, dtype=np.float32) + np.asarray(want, dtype=np.float32), rel)
    assert torch.equal(red["layers"]["bias"], torch.from_numpy(tree["layers"]["bias"]))


@pytest.mark.parametrize("arch", ["granite-moe-1b-a400m", "qwen2-7b"])
@pytest.mark.parametrize("smoke", [False, True])
def test_bench_matrices_and_models_are_the_references(arch, smoke, monkeypatch):
    # the reference's bench sets XLA_FLAGS when it is imported and finds none
    monkeypatch.setenv("XLA_FLAGS", os.environ.get("XLA_FLAGS", ""))
    from repro.launch import compress_bench as jcb

    mats = cb.grad_matrices(get_config(arch, smoke=smoke))
    assert mats == jcb.grad_matrices(jget_config(arch, smoke=smoke))
    want = sum(m * n for _, m, n in mats) / sum(64 * (m + n) for _, m, n in mats)
    assert cb.analytic_reduction(mats, 64) == want
    assert cb.model_bytes(mats, 64)["raw"] == 4 * sum(m * n for _, m, n in mats)
    if arch == "granite-moe-1b-a400m" and not smoke:
        assert len(mats) == 10 and sum(m * n for _, m, n in mats) == 1_284_292_608
        assert sum(64 * (m + n) for _, m, n in mats) == 134_157_312
        # r = min(64, m, n): ln1, ln2 (24 rows) at 24 and the router (32 columns) at 32
        assert cb.model_bytes(mats, 64)["qrp_compressed"] == 4 * 133_286_016
        assert round(want, 2) == 9.57


def test_bench_on_one_rank_checks_its_bytes_and_bits():
    mats = cb.grad_matrices(get_config("granite-moe-1b-a400m", smoke=True))
    rep = cb.run_rank(mats, 8, "cpu", repeats=1)
    res = cb.summarize([rep], mats, 8)
    assert res["ok"], res["checks"]
    assert res["raw"]["coll_bytes"] == cb.model_bytes(mats, 8)["raw"]
    assert res["reduction"] == res["raw"]["model_bytes"] / res["qrp_compressed"]["model_bytes"]
    bad = dict(rep, bytes={"raw": 0, "qrp_compressed": 0})
    assert not cb.summarize([rep, bad], mats, 8)["checks"]["bytes_match_model"]
    other = dict(rep, digests=list(reversed(rep["digests"])))
    assert not cb.summarize([rep, other], mats, 8)["checks"]["same_bits_on_every_rank"]
    # the seeded gradients: rank r plus noise, the same on every call
    g = cb.seeded_gradient(40, 30, 4, 7, "cpu")
    assert torch.equal(g, cb.seeded_gradient(40, 30, 4, 7, "cpu"))
    s = torch.linalg.svdvals(g)
    assert s[3] > 100 * s[4] > 0
    assert cb.bits_digest(g) == cb.bits_digest(g.clone()) != cb.bits_digest(g + 1)


def test_bench_refuses_no_card_by_default():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device resolves")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cb.bench("granite-moe-1b-a400m", 8, smoke=True)
