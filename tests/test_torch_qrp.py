"""repro_torch QRP / factor updates against the reference (CPU)."""
import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch


jqrp = importlib.import_module("repro.core.qrp")
# repro_torch.core re-exports the function qrp under the module's name
tqrp = importlib.import_module("repro_torch.core.qrp")


def _draw(m, n, seed):
    return np.random.default_rng(seed).standard_normal((m, n)).astype(np.float32)


def _proj(q):
    q = np.asarray(q, dtype=np.float64)
    return q @ q.T


@pytest.mark.parametrize("m,n,r,seed", [(40, 20, 5, 0), (30, 12, 12, 1), (9, 25, 4, 2)])
def test_householder_same_pivots_and_q(m, n, r, seed):
    a = _draw(m, n, seed)
    jq, jpiv = jqrp.qrp_householder(jnp.asarray(a), r)
    tq, tpiv = tqrp.qrp_householder(torch.from_numpy(a), r)
    np.testing.assert_array_equal(tpiv.numpy(), np.asarray(jpiv))
    np.testing.assert_allclose(tq.numpy(), np.asarray(jq), rtol=0, atol=1e-5)


def test_householder_ties_pick_the_first_column():
    a = _draw(20, 6, 3)
    a[:, 4] = a[:, 1]  # equal norms: argmax must pick column 1 first
    a[:, 5] = -a[:, 2]
    jq, jpiv = jqrp.qrp_householder(jnp.asarray(a), 4)
    tq, tpiv = tqrp.qrp_householder(torch.from_numpy(a), 4)
    np.testing.assert_array_equal(tpiv.numpy(), np.asarray(jpiv))


@pytest.mark.parametrize("m,n,r,seed", [(40, 20, 5, 0), (60, 16, 8, 4)])
def test_gram_full_rank_same_pivots_and_subspace(m, n, r, seed):
    # full-rank draws only: on a rank-deficient unfolding the reference's
    # gram path returns NaN (ROADMAP.md queue 3), which is no oracle.
    a = _draw(m, n, seed)
    jq, jpiv = jqrp.qrp_gram(jnp.asarray(a), r)
    tq, tpiv = tqrp.qrp_gram(torch.from_numpy(a), r)
    np.testing.assert_array_equal(tpiv.numpy(), np.asarray(jpiv))
    np.testing.assert_allclose(_proj(tq.numpy()), _proj(jq), rtol=0, atol=1e-4)
    np.testing.assert_allclose(tq.numpy().T @ tq.numpy(), np.eye(r), atol=1e-5)


@pytest.mark.parametrize("method", ["svd", "householder", "gram"])
def test_factor_update_subspace_matches(method):
    a = _draw(50, 24, 7)
    want = jqrp.factor_update(jnp.asarray(a), 6, method)
    got = tqrp.factor_update(torch.from_numpy(a), 6, method)
    assert tuple(got.shape) == tuple(want.shape)
    # singular vectors are defined up to sign: compare the projectors.
    np.testing.assert_allclose(_proj(got.numpy()), _proj(want), rtol=0, atol=1e-4)


def test_pivoted_cholesky_same_pivots():
    a = _draw(30, 10, 5)
    g = a.T @ a
    jl, jpiv = jqrp.pivoted_cholesky(jnp.asarray(g), 6)
    tl, tpiv = tqrp.pivoted_cholesky(torch.from_numpy(g), 6)
    np.testing.assert_array_equal(tpiv.numpy(), np.asarray(jpiv))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=0, atol=1e-3)


def test_unknown_method_raises():
    with pytest.raises(ValueError, match="unknown QRP method"):
        tqrp.qrp(torch.zeros(3, 3), 1, method="lu")
