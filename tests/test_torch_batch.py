"""TuckerPlan.batch on the CPU: the batched sweep program (members stacked
block-diagonally, one unfolding per mode, a batched factor update, the core
per member) against the reference's per-tensor runs and the port's own, the
batch rules, the sequential fallbacks, and the batch helpers of
``sparse.layout`` and ``core.qrp`` against the reference's.

Tolerances: against the reference's per-tensor ``tucker.plan(spec)(coo,
factors_init=...)`` from the same numpy factors, the fit within 1e-4 and the
factor projectors within 1e-3 (two frameworks' f32 products over a few
sweeps, as ``test_torch_tucker.py``); against the port's own per-tensor runs
from the same factors, 1e-6 (the same arithmetic; only the batched matrix
products may block their sums otherwise); the batched QRP against the
matrix-at-a-time QRP, 1e-6.
"""
import threading

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import tucker as jtucker
from repro.core.coo import SparseCOO as JSparseCOO
from repro.sparse.generators import random_sparse_tensor as jrandom
from repro.sparse.layout import bucket_nnz as jbucket_nnz
from repro.sparse.layout import pad_coo_batch as jpad_coo_batch
from repro_torch import tucker
from repro_torch.convert import coo_from_numpy
from repro_torch.core.engine import make_engine
from repro_torch.core.qrp import factor_update, pivoted_cholesky, qrp_householder
from repro_torch.kernels import kron_kernel, launch_count, ttm_kernel
from repro_torch.sparse.layout import bucket_nnz, pad_coo_batch, stack_coo_batch

SHAPES = {2: ((30, 24), (4, 3)), 3: ((16, 14, 12), (3, 3, 2)), 4: ((9, 8, 7, 6), (2, 2, 2, 2))}
METHODS = ("householder", "gram", "svd")


def _members(order, k=3, seed=0):
    """k reference COO tensors of one shape with ragged nnz."""
    shape, _ = SHAPES[order]
    return [jrandom(shape, 0.04 + 0.02 * i, seed=seed + 7 * i) for i in range(k)]


def _port(c):
    return coo_from_numpy(np.asarray(c.indices), np.asarray(c.values), c.shape)


def _factors(shape, ranks, seed):
    rng = np.random.default_rng(seed)
    return [np.linalg.qr(rng.standard_normal((s, r)))[0].astype(np.float32)
            for s, r in zip(shape, ranks)]


def _projectors_close(a, b, atol):
    for fa, fb in zip(a, b):
        fa, fb = np.asarray(fa), np.asarray(fb)
        np.testing.assert_allclose(fa @ fa.T, fb @ fb.T, rtol=0, atol=atol)


@pytest.mark.parametrize("method", METHODS)
@pytest.mark.parametrize("order", [2, 3, 4])
def test_batch_matches_the_reference_per_tensor(order, method):
    shape, ranks = SHAPES[order]
    members = _members(order, seed=order)
    spec = tucker.TuckerSpec(shape, ranks, method=method, n_iter=3)
    inits = [_factors(shape, spec.ranks, 50 + i) for i in range(len(members))]
    results = tucker.plan(spec, device="cpu").batch([_port(c) for c in members],
                                                    factors_init=inits)
    jspec = jtucker.TuckerSpec(shape=shape, ranks=ranks, method=method, n_iter=3)
    for c, f0, res in zip(members, inits, results):
        ref = jtucker.plan(jspec)(c, factors_init=[jnp.asarray(f) for f in f0])
        assert res.n_sweeps == ref.n_sweeps == 3
        np.testing.assert_allclose(res.fit_history, ref.fit_history, rtol=0, atol=1e-4)
        _projectors_close([f.numpy() for f in res.factors], ref.factors, 1e-3)
        assert tuple(res.core.shape) == spec.ranks


@pytest.mark.parametrize("method", METHODS)
@pytest.mark.parametrize("order", [2, 3, 4])
@pytest.mark.parametrize("tol", [0.0, 2e-3])
def test_batch_matches_its_own_per_tensor_runs(order, method, tol):
    """Each member's factors, core and fit as the per-tensor run's from the
    same generator; under tol > 0 each member stops at its own sweep."""
    shape, ranks = SHAPES[order]
    coos = [_port(c) for c in _members(order, k=4, seed=10 + order)]
    p = tucker.plan(tucker.TuckerSpec(shape, ranks, method=method, n_iter=6, tol=tol),
                    device="cpu")
    results = p.batch(coos, generators=[torch.Generator().manual_seed(i) for i in range(4)])
    sweeps = []
    for i, (c, res) in enumerate(zip(coos, results)):
        one = p(c, generator=torch.Generator().manual_seed(i))
        assert res.n_sweeps == one.n_sweeps
        sweeps.append(one.n_sweeps)
        np.testing.assert_allclose(res.fit_history, one.fit_history, rtol=0, atol=1e-6)
        for a, b in zip(res.factors, one.factors):
            np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0, atol=1e-6)
        np.testing.assert_allclose(res.core.numpy(), one.core.numpy(), rtol=0, atol=1e-6)
    if tol == 0.0:
        assert sweeps == [6] * 4
    # counters describe the whole batch, on its first result
    assert [r.dispatches for r in results] == [1, 0, 0, 0]
    assert results[0].schedule_builds == order and results[1].schedule_builds == 0
    assert all(r.launches == 0 for r in results)  # the CPU launches no kernel


def test_members_stop_at_their_own_sweep_under_tol():
    """A member whose fit settles early keeps its factors and core while the
    others sweep on: its history ends there, theirs continue."""
    shape, ranks = SHAPES[3]
    coos = [_port(c) for c in _members(3, k=3, seed=41)]
    p = tucker.plan(tucker.TuckerSpec(shape, ranks, n_iter=12, tol=1e-3), device="cpu")
    results = p.batch(coos, factors_init=[_factors(shape, ranks, 9)] * 3)
    singles = [p(c, factors_init=_factors(shape, ranks, 9)) for c in coos]
    assert [r.n_sweeps for r in results] == [s.n_sweeps for s in singles]
    assert len({r.n_sweeps for r in results}) > 1  # the members stop apart


def test_batch_keeps_the_per_tensor_schedules():
    """A batch runs on the plan's batch engine: the per-tensor schedules of
    the last tensor stay warm."""
    shape, ranks = SHAPES[3]
    coos = [_port(c) for c in _members(3, seed=60)]
    p = tucker.plan(tucker.TuckerSpec(shape, ranks, n_iter=2), device="cpu")
    assert p(coos[0]).schedule_builds == 3
    p.batch(coos)
    assert p(coos[0]).schedule_builds == 0
    assert p.stats.calls == 5 and p.stats.dispatches == 3


def test_batch_rules():
    shape, ranks = SHAPES[3]
    coos = [_port(c) for c in _members(3, seed=70)]
    p = tucker.plan(tucker.TuckerSpec(shape, ranks, n_iter=2), device="cpu")
    assert p.batch([]) == []
    zero = coo_from_numpy(np.zeros((0, 3), np.int32), np.zeros(0, np.float32), shape)
    with pytest.raises(ValueError, match="zero stored nonzeros"):
        p.batch([coos[0], zero])
    nnz_max = max(c.nnz for c in coos)
    with pytest.raises(ValueError, match="would drop nonzeros"):
        p.batch(coos, pad_nnz_to=nnz_max - 1)
    # a target at or above the batch max pads nothing: the same results
    a = p.batch(coos, pad_nnz_to=bucket_nnz(nnz_max))
    b = p.batch(coos)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x.fit_history, y.fit_history)
    with pytest.raises(ValueError, match="generators"):
        p.batch(coos, generators=[None])
    with pytest.raises(ValueError, match="does not match"):
        p.batch([_port(jrandom((5, 5, 5), 0.2, seed=1))])
    with pytest.raises(ValueError, match="algorithm='sparse'"):
        tucker.plan(tucker.TuckerSpec(shape, ranks, algorithm="dense"), device="cpu").batch(coos)
    with pytest.raises(TypeError, match="SnapshotSpec"):
        tucker.TuckerSpec(shape, ranks, snapshot=object())
    # the reference's rules on its side of the same inputs
    jp = jtucker.plan(jtucker.TuckerSpec(shape=shape, ranks=ranks, n_iter=2))
    assert jp.batch([]) == []


@pytest.mark.parametrize("case", ["python", "bf16", "fuse_core"])
def test_fallback_specs_run_k_sequential_calls(case):
    shape, ranks = SHAPES[3]
    coos = [_port(c) for c in _members(3, seed=80)]
    spec = tucker.TuckerSpec(shape, ranks, n_iter=2,
                             pipeline="python" if case == "python" else "scan",
                             precision="bf16_fp32acc" if case == "bf16" else "fp32")
    engine = make_engine("torch", "cpu", fuse_core=True) if case == "fuse_core" else None
    p = tucker.plan(spec, device="cpu", engine=engine)
    assert not p.supports_batched_dispatch and not p.batch_is_vmappable()
    assert spec.supports_batched_dispatch == (case == "fuse_core")
    results = p.batch(coos, generators=[torch.Generator().manual_seed(i) for i in range(3)])
    for i, (c, res) in enumerate(zip(coos, results)):
        one = p(c, generator=torch.Generator().manual_seed(i))
        np.testing.assert_array_equal(res.fit_history, one.fit_history)
        assert res.dispatches == one.dispatches == (2 if case == "python" else 1)
    assert p.stats.calls == 6


def count_plain_launches(monkeypatch):
    """Make every plain unfolding and core update count one launch, as its
    kernel would on the card (the CPU launches none)."""
    for name in ("fused_kron_scatter", "kron_contrib", "scatter_rows",
                 "fused_kron_chain_scatter"):
        wrapper, plain = getattr(kron_kernel, name), getattr(kron_kernel, f"{name}_plain")

        def counted(*a, _plain=plain, _wrapper=wrapper, **kw):
            launch_count.count(_wrapper)
            return _plain(*a, **kw)

        monkeypatch.setattr(kron_kernel, f"{name}_plain", counted)
    real_ttm = ttm_kernel.ttm_plain

    def ttm_counted(*a, **kw):
        launch_count.count(ttm_kernel.ttm)
        return real_ttm(*a, **kw)

    monkeypatch.setattr(ttm_kernel, "ttm_plain", ttm_counted)


def test_launches_are_exact_per_call_under_concurrent_batches(monkeypatch):
    """Each result's launches are its own call's, counted on its thread,
    while another thread launches too."""
    count_plain_launches(monkeypatch)
    runs = {}
    barrier = threading.Barrier(2)

    def run(order, k, n_iter):
        shape, ranks = SHAPES[order]
        coos = [_port(c) for c in _members(order, k=k, seed=90 + order)]
        p = tucker.plan(tucker.TuckerSpec(shape, ranks, n_iter=n_iter), device="cpu")
        barrier.wait(60)
        runs[order] = (p.batch(coos), p(coos[0]))

    threads = [threading.Thread(target=run, args=a) for a in ((3, 4, 3), (4, 2, 2))]
    for th in threads:
        th.start()
    for th in threads:
        th.join(300)
    assert not any(th.is_alive() for th in threads)
    batch3, single3 = runs[3]
    # 3-way: kernel 1 once per mode per sweep for the whole batch, kernel 2
    # once per member per sweep; the single call: 3 + 1 a sweep
    assert batch3[0].launches == 3 * 3 + 4 * 3 and single3.launches == 4 * 3
    assert [r.launches for r in batch3[1:]] == [0, 0, 0]
    # 4-way: the chain kernel once per mode for the whole batch, kernel 2
    # per member
    batch4, single4 = runs[4]
    assert batch4[0].launches == 2 * (4 + 2) and single4.launches == 2 * (4 + 1)


def test_launch_tally_is_per_thread():
    def fake():
        pass

    fake.launches = 0
    seen = {}

    def work(i):
        before = launch_count.tally()
        for _ in range(1000 * (i + 1)):
            launch_count.count(fake)
        seen[i] = launch_count.since(before)

    threads = [threading.Thread(target=work, args=(i,)) for i in range(4)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(60)
    assert seen == {i: {"fake": 1000 * (i + 1)} for i in range(4)}
    assert fake.launches == 10000


# -- the batch helpers ----------------------------------------------------------


def test_bucket_nnz_matches_the_reference():
    for nnz in (0, 1, 511, 512, 513, 1000, 4097, 12000, 36000):
        for base, growth in ((512, 2.0), (100, 1.5), (1, 3.0)):
            assert bucket_nnz(nnz, base, growth) == jbucket_nnz(nnz, base, growth)
    for bad in (dict(nnz=1, base=0), dict(nnz=1, growth=1.0), dict(nnz=-1)):
        with pytest.raises(ValueError):
            bucket_nnz(**bad)


def test_pad_coo_batch_matches_the_reference():
    members = _members(3, seed=100)
    for target in (None, 400):
        ji, jv = jpad_coo_batch(members, target_nnz=target)
        ti, tv = pad_coo_batch([_port(c) for c in members], target_nnz=target)
        np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
        np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    with pytest.raises(ValueError, match="would drop nonzeros"):
        pad_coo_batch([_port(c) for c in members], target_nnz=1)
    with pytest.raises(ValueError, match="at least one"):
        pad_coo_batch([])
    mixed = [_port(members[0]), coo_from_numpy(np.asarray(members[1].indices),
                                               np.asarray(members[1].values, np.float64),
                                               members[1].shape)]
    with pytest.raises(ValueError, match="one common value dtype"):
        pad_coo_batch(mixed)
    with pytest.raises(ValueError, match="same-shape"):
        jpad_coo_batch([members[0], JSparseCOO(members[0].indices[:, :2],
                                               members[0].values, (16, 14))])


def test_stack_coo_batch_is_block_diagonal():
    members = [_port(c) for c in _members(3, seed=110)]
    stacked, offsets = stack_coo_batch(members)
    shape = members[0].shape
    assert stacked.shape == tuple(3 * s for s in shape)
    assert offsets == [0] + list(np.cumsum([c.nnz for c in members]))
    dense = stacked.to_dense()
    for i, c in enumerate(members):
        block = dense[tuple(slice(i * s, (i + 1) * s) for s in shape)]
        np.testing.assert_array_equal(block.numpy(), c.to_dense().numpy())
        part = stacked.indices[offsets[i]:offsets[i + 1]] - torch.tensor(shape) * i
        np.testing.assert_array_equal(part.numpy(), c.indices.numpy())
    assert float(dense.abs().sum()) == pytest.approx(sum(float(c.values.abs().sum())
                                                         for c in members))


@pytest.mark.parametrize("method", METHODS)
def test_batched_factor_update_matches_one_matrix_at_a_time(method):
    rng = np.random.default_rng(3)
    a = torch.tensor(rng.standard_normal((5, 40, 24)), dtype=torch.float32)
    got = factor_update(a, 6, method)
    assert tuple(got.shape) == (5, 40, 6)
    for i in range(5):
        np.testing.assert_allclose(got[i].numpy(), factor_update(a[i], 6, method).numpy(),
                                   rtol=0, atol=1e-6)
    q, piv = qrp_householder(a, 6)
    assert tuple(piv.shape) == (5, 6)
    for i in range(5):
        assert torch.equal(piv[i], qrp_householder(a[i], 6)[1])
    g = a.mT @ a
    l, piv = pivoted_cholesky(g, 4)
    for i in range(5):
        li, pi = pivoted_cholesky(g[i], 4)
        assert torch.equal(piv[i], pi)
        np.testing.assert_allclose(l[i].numpy(), li.numpy(), rtol=0, atol=1e-4)
    with pytest.raises(ValueError, match="batch of matrices"):
        factor_update(a[None], 6, "householder")
