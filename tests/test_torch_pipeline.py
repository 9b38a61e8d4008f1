"""The per-sweep pipeline (``pipeline="python"``): against the port's scan
pipeline on the CPU (the same sweeps, so the same bits) and against the
reference's ``pipeline="python"`` from the same initial factors, with the
``tol`` exit and the dispatch count."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import tucker as jtucker
from repro.sparse.generators import low_rank_sparse_tensor as jlow_rank
from repro.sparse.generators import random_sparse_tensor as jrandom
from repro_torch import tucker
from repro_torch.convert import coo_from_numpy, factors_from_numpy
from repro_torch.core import hooi as thooi
from repro_torch.core.engine import make_engine

CASES = {
    "3-way": (lambda: jrandom((30, 25, 20), 0.02, seed=6), (4, 3, 3), {}),
    "4-way": (lambda: jrandom((12, 10, 9, 8), 0.03, seed=8), (3, 2, 2, 2), {}),
    "2-way": (lambda: jrandom((40, 30), 0.05, seed=5), (5, 4), {}),
    # fit deltas 0.091, 0.025, 0.0039, ...: the tol exit stops after sweep 4
    "tol": (lambda: jlow_rank((30, 25, 20), (3, 3, 2), 0.02, seed=0)[0], (3, 3, 2),
            {"tol": 1e-2}),
}


def _inputs(case):
    build, ranks, extra = CASES[case]
    coo = build()
    rng = np.random.default_rng(3)
    f0 = [np.linalg.qr(rng.standard_normal((s, r)))[0].astype(np.float32)
          for s, r in zip(coo.shape, tucker.TuckerSpec(coo.shape, ranks).ranks)]
    tc = coo_from_numpy(np.asarray(coo.indices), np.asarray(coo.values), coo.shape)
    return coo, tc, ranks, f0, dict(n_iter=5, **extra)


@pytest.mark.parametrize("method", ["householder", "svd"])
@pytest.mark.parametrize("case", list(CASES))
def test_python_pipeline_equals_the_scan_pipeline(case, method):
    _, tc, ranks, f0, kw = _inputs(case)
    eng = make_engine("torch", "cpu")
    res = {}
    for pipeline in ("scan", "python"):
        spec = tucker.TuckerSpec(tc.shape, ranks, method=method, pipeline=pipeline, **kw)
        res[pipeline] = tucker.plan(spec, device="cpu", engine=eng)(
            tc, factors_init=factors_from_numpy(f0))
    scan, py = res["scan"], res["python"]
    np.testing.assert_array_equal(py.fit_history, scan.fit_history)
    assert py.rel_error == scan.rel_error and py.n_sweeps == scan.n_sweeps
    assert torch.equal(py.core, scan.core)
    assert all(torch.equal(a, b) for a, b in zip(py.factors, scan.factors))
    # one dispatch a sweep against one a call; the engine's schedules shared
    assert scan.dispatches == 1 and py.dispatches == py.n_sweeps
    assert scan.schedule_builds == len(ranks) and py.schedule_builds == 0
    assert py.launches == 0 and py.engine == "torch"


@pytest.mark.parametrize("case", ["3-way", "4-way", "tol"])
def test_python_pipeline_matches_reference(case):
    coo, tc, ranks, f0, kw = _inputs(case)
    jspec = jtucker.TuckerSpec(coo.shape, ranks, engine="pallas", pipeline="python", **kw)
    ref = jtucker.plan(jspec)(coo, factors_init=[jnp.asarray(f) for f in f0])
    port = tucker.plan(tucker.TuckerSpec(tc.shape, ranks, pipeline="python", **kw),
                       device="cpu")(tc, factors_init=factors_from_numpy(f0))
    if case == "tol":
        assert ref.n_sweeps == 4  # the early exit fired in the reference
    assert port.dispatches == ref.dispatches == ref.n_sweeps
    assert port.fit_history.shape == ref.fit_history.shape
    np.testing.assert_allclose(port.fit_history, ref.fit_history, rtol=0, atol=1e-4)
    core = port.core.numpy()
    for n, (a, b) in enumerate(zip(port.factors, ref.factors)):
        a, b = a.numpy(), np.asarray(b)
        np.testing.assert_allclose(a @ a.T, b @ b.T, rtol=0, atol=1e-3)
        sign = np.sign(np.sum(a * b, axis=0))
        core = core * sign.reshape([-1 if t == n else 1 for t in range(core.ndim)])
    np.testing.assert_allclose(core, np.asarray(ref.core), rtol=0, atol=1e-3)


def test_hooi_sparse_shim_warns_and_equals_the_plan():
    _, tc, ranks, f0, _ = _inputs("3-way")
    eng = make_engine("torch", "cpu")
    with pytest.warns(DeprecationWarning, match="hooi_sparse is deprecated"):
        old = thooi.hooi_sparse(tc, ranks, n_iter=3, engine=eng, pipeline="python",
                                device="cpu")
    new = tucker.plan(tucker.TuckerSpec(tc.shape, ranks, n_iter=3, pipeline="python"),
                      device="cpu")(tc)
    np.testing.assert_array_equal(old.fit_history, new.fit_history)
    assert torch.equal(old.core, new.core) and old.dispatches == 3
    assert old.schedule_builds == 3  # the prebuilt engine built them
