"""The port's remaining public functions against the JAX package on the
same numpy inputs (CPU): the SparseCOO members, the reconstruction and
error functions, ``mode_unfold_matmul``, the flop models, the scatter plan,
``sparse_ttm_chain_kernel``, ``layout_padding_fraction``,
``available_engines`` and ``sweep_call_counts``."""
import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.coo import SparseCOO as JCOO
from repro.kernels import kron_kernel as jkron
from repro.kernels import ops as jops
from repro.sparse import layout as jlayout
from repro_torch.core import engine as tengine
from repro_torch.core import hooi as thooi
from repro_torch.core import kron as tkron
from repro_torch.core import reconstruct as trec
from repro_torch.core.coo import SparseCOO
from repro_torch.kernels import kron_kernel as tkronk
from repro_torch.kernels import ops as tops
from repro_torch.sparse import layout as tlayout

# repro.core re-exports functions named like its submodules (ttm, ...).
jhooi = importlib.import_module("repro.core.hooi")
# repro_torch.core re-exports the functions qrp and ttm under their modules' names
tqrp = importlib.import_module("repro_torch.core.qrp")
tttm = importlib.import_module("repro_torch.core.ttm")
jkronm = importlib.import_module("repro.core.kron")
jqrp = importlib.import_module("repro.core.qrp")
jrec = importlib.import_module("repro.core.reconstruct")
jttm = importlib.import_module("repro.core.ttm")


def _pair(shape, nnz, seed, dup=0):
    """The same random COO in both packages (``dup`` repeated coordinates)."""
    rng = np.random.default_rng(seed)
    idx = np.stack([rng.integers(0, s, nnz) for s in shape], 1).astype(np.int32)
    idx = np.concatenate([idx, idx[:dup]])
    vals = rng.standard_normal(idx.shape[0]).astype(np.float32)
    return JCOO.from_parts(idx, vals, shape), SparseCOO.from_parts(idx, vals, shape), rng


def _same_coo(t, j):
    np.testing.assert_array_equal(t.indices.numpy(), np.asarray(j.indices))
    np.testing.assert_array_equal(t.values.numpy(), np.asarray(j.values))
    assert t.shape == tuple(j.shape) and t.indices.dtype == torch.int32


@pytest.mark.parametrize("shape", [(6, 7), (5, 4, 6), (4, 3, 5, 2)])
def test_from_dense_matches_reference(shape):
    rng = np.random.default_rng(1)
    dense = rng.standard_normal(shape).astype(np.float32)
    dense[rng.random(shape) < 0.7] = 0.0
    want = JCOO.from_dense(dense)
    _same_coo(SparseCOO.from_dense(dense), want)
    # a tensor keeps its device and gives the same nonzeros
    _same_coo(SparseCOO.from_dense(torch.from_numpy(dense)), want)
    assert SparseCOO.from_dense(torch.from_numpy(dense)).device == torch.device("cpu")


def test_density_scale_sort_linearized_match_reference():
    jc, tc, _ = _pair((9, 8, 7), 60, 2, dup=7)
    assert tc.density() == jc.density()
    _same_coo(tc.scale(2.5), jc.scale(2.5))
    for mode in range(3):
        _same_coo(tc.sort_by_mode(mode), jc.sort_by_mode(mode))
        np.testing.assert_array_equal(tc.linearized_index(mode), jc.linearized_index(mode))
        assert tc.linearized_index(mode).dtype == np.int64
    # a 20000^3 unfolding's columns pass int32
    big = SparseCOO.from_parts(np.array([[1, 19999, 19999]], np.int32), np.ones(1, np.float32),
                               (20000, 20000, 20000))
    assert big.linearized_index(0)[0] == 19999 + 19999 * 20000


@pytest.mark.parametrize("shape,ranks", [((7, 6), (3, 2)), ((6, 5, 4), (3, 2, 2)),
                                         ((5, 4, 3, 4), (2, 3, 2, 2))])
def test_reconstruct_at_and_errors_match_reference(shape, ranks):
    rng = np.random.default_rng(4)
    core = rng.standard_normal(ranks).astype(np.float32)
    fs = [np.linalg.qr(rng.standard_normal((s, r)))[0].astype(np.float32)
          for s, r in zip(shape, ranks)]
    x = rng.standard_normal(shape).astype(np.float32)
    idx = np.stack([rng.integers(0, s, 25) for s in shape], 1).astype(np.int32)
    tcore, tfs = torch.from_numpy(core), [torch.from_numpy(f) for f in fs]
    jcore, jfs = jnp.asarray(core), [jnp.asarray(f) for f in fs]
    got = trec.reconstruct_at(tcore, tfs, torch.from_numpy(idx))
    np.testing.assert_allclose(got.numpy(), np.asarray(jrec.reconstruct_at(jcore, jfs, idx)),
                               rtol=1e-5, atol=1e-6)
    # the Kolda order: the entries of the dense reconstruction
    dense = trec.reconstruct_dense(tcore, tfs)
    np.testing.assert_allclose(got.numpy(), dense[tuple(torch.from_numpy(idx).long().T)].numpy(),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(
        float(trec.relative_error_dense(torch.from_numpy(x), tcore, tfs)),
        float(jrec.relative_error_dense(jnp.asarray(x), jcore, jfs)), rtol=1e-6)
    xnorm2 = float(np.sum(np.square(core))) * 1.5
    np.testing.assert_allclose(
        float(trec.relative_error_projection(torch.tensor(xnorm2), tcore)),
        float(jrec.relative_error_projection(jnp.float32(xnorm2), jcore)), rtol=1e-6)


@pytest.mark.parametrize("mode", [0, 1, 2, 3])
def test_mode_unfold_matmul_and_ttm_match_reference(mode):
    rng = np.random.default_rng(5)
    x = rng.standard_normal((5, 4, 6, 3)).astype(np.float32)
    u = rng.standard_normal((2, x.shape[mode])).astype(np.float32)
    want = np.asarray(jttm.mode_unfold_matmul(jnp.asarray(x), jnp.asarray(u), mode))
    got = tttm.mode_unfold_matmul(torch.from_numpy(x), torch.from_numpy(u), mode)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    # ttm reads x in place as (A, I, B); Eq. 5 unfolds it
    np.testing.assert_allclose(tttm.ttm(torch.from_numpy(x), torch.from_numpy(u), mode).numpy(),
                               want, rtol=1e-5, atol=1e-5)


def test_flop_models_match_reference():
    # paper Sec III-D: QRP 2mn^2 - 2n^3/3, SVD 2mn^2 + 11n^3
    assert tqrp.qrp_flops(100, 10) == 2 * 100 * 100 - 2 * 1000 // 3
    assert tqrp.svd_flops(100, 10) == 2 * 100 * 100 + 11 * 1000
    assert tqrp.qrp_flops(20000, 32) < tqrp.svd_flops(20000, 32)
    for m, n in [(100, 10), (20000, 32), (7, 7)]:
        assert tqrp.qrp_flops(m, n) == jqrp.qrp_flops(m, n)
        assert tqrp.svd_flops(m, n) == jqrp.svd_flops(m, n)
    jc, tc, _ = _pair((9, 8, 7, 6), 40, 3)
    for mode in range(4):
        assert tkron.kron_flops(tc, (3, 4, 2, 5), mode) == jkronm.kron_flops(jc, (3, 4, 2, 5), mode)


def test_sweep_call_counts_match_reference():
    for shape, ranks, nnz, n_iter in [((20000,) * 3, (32,) * 3, 902, 2), ((130, 150), (30, 30),
                                                                          3510, 12)]:
        assert thooi.sweep_call_counts(shape, ranks, nnz, n_iter) == \
            jhooi.sweep_call_counts(shape, ranks, nnz, n_iter)


@pytest.mark.parametrize("bn,bi", [(128, 128), (8, 4)])
def test_scatter_plan_and_padding_fraction_match_reference(bn, bi):
    jc, tc, _ = _pair((40, 35, 30), 201, 6, dup=20)
    for mode in range(3):
        rows = np.asarray(jc.indices[:, mode])
        want = jkron.build_scatter_plan(rows, jc.shape[mode], bn, bi)
        got = tkronk.build_scatter_plan(tc.indices[:, mode], tc.shape[mode], bn, bi)
        for field in jkron.ScatterPlan._fields:
            w, g = getattr(want, field), getattr(got, field)
            if w is None or isinstance(w, int):
                assert g == w, field
            else:
                np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=field)
        jl, tl = jlayout.build_mode_layout(jc, mode, bn, bi), tlayout.build_mode_layout(
            tc, mode, bn, bi)
        assert tlayout.layout_padding_fraction(tl) == pytest.approx(
            jlayout.layout_padding_fraction(jl), abs=1e-12)


@pytest.mark.parametrize("shape,ranks", [((30, 25), (4, 3)), ((20, 15, 12), (4, 3, 5)),
                                         ((9, 8, 7, 6), (3, 2, 4, 2))])
@pytest.mark.parametrize("plan", ["none", "scatter_plan", "layout"])
def test_sparse_ttm_chain_kernel_matches_reference(shape, ranks, plan):
    jc, tc, rng = _pair(shape, 180, 7, dup=11)
    fs = [rng.standard_normal((s, r)).astype(np.float32) for s, r in zip(shape, ranks)]
    tfs, jfs = [torch.from_numpy(f) for f in fs], [jnp.asarray(f) for f in fs]
    for mode in range(len(shape)):
        jplan, tplan = None, None
        if plan == "scatter_plan":
            jplan = jkron.build_scatter_plan(np.asarray(jc.indices[:, mode]), shape[mode])
            tplan = tkronk.build_scatter_plan(tc.indices[:, mode], shape[mode])
        elif plan == "layout":
            jplan, tplan = jlayout.build_mode_layout(jc, mode), tlayout.build_mode_layout(tc, mode)
        for fused in (True, False):
            want = jops.sparse_ttm_chain_kernel(jc, jfs, mode, jplan, interpret=True,
                                                fused=fused)
            got = tops.sparse_ttm_chain_kernel(tc, tfs, mode, tplan, fused=fused)
            np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


def test_available_engines_on_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the answer depends on the kernel build")
    assert tengine.available_engines() == ["torch"]


# -- repro_torch.core's exports and the result types -------------------------------

def test_core_reexports_the_reference_names():
    """Every name ``src/repro/core/__init__.py`` imports resolves on
    ``repro_torch.core`` to the port's object of that name, Kron reuse's
    included."""
    import ast
    from pathlib import Path

    import repro_torch.core as tcore

    tree = ast.parse((Path(__file__).resolve().parents[1] / "src" / "repro" / "core"
                      / "__init__.py").read_text())
    names = {(node.module, a.asname or a.name) for node in tree.body
             if isinstance(node, ast.ImportFrom) for a in node.names}
    assert len(names) > 25
    for module, name in sorted(names):
        port_module = importlib.import_module(module.replace("repro.", "repro_torch.", 1))
        assert getattr(tcore, name) is getattr(port_module, name), name
    assert tcore.hooi_sparse_distributed is importlib.import_module(
        "repro_torch.core.distributed").hooi_sparse_distributed
    from repro_torch.core import HooiResult, SparseCOO, hooi_sparse_distributed, make_engine

    assert SparseCOO and make_engine and HooiResult and hooi_sparse_distributed


def _retraces_cases(tmp_path):
    from repro_torch import tucker

    shape, ranks = (12, 10, 8), (3, 2, 2)
    coo = tcoo_random(shape)
    dense = coo.to_dense()
    snap = tucker.SnapshotSpec(every_n_sweeps=1, directory=str(tmp_path))
    return [
        tucker.decompose(coo, ranks, n_iter=2, device="cpu"),
        tucker.decompose(coo, ranks, n_iter=2, pipeline="python", device="cpu"),
        tucker.decompose(dense, ranks, n_iter=2, device="cpu"),
        tucker.decompose(coo, ranks, n_iter=2, algorithm="complete", n_rounds=2, device="cpu"),
        tucker.plan(tucker.TuckerSpec(shape, ranks, n_iter=2, snapshot=snap),
                    device="cpu")(coo),
        tucker.plan(tucker.TuckerSpec(shape, ranks, n_iter=2,
                                      shard=tucker.ShardSpec(1)), device="cpu")(coo),
    ] + tucker.plan(tucker.TuckerSpec(shape, ranks, n_iter=2), device="cpu").batch([coo, coo])


def tcoo_random(shape):
    from repro_torch.sparse.generators import random_sparse_tensor

    return random_sparse_tensor(shape, 0.1, seed=5)


def test_tucker_result_is_a_hooi_result_with_zero_retraces(tmp_path):
    """TuckerResult subclasses HooiResult, as the reference's does, with the
    reference's field order; eager PyTorch never traces, so every path
    reports 0 retraces."""
    import dataclasses

    from repro.core.hooi import HooiResult as JHooiResult
    from repro.tucker.result import TuckerResult as JTuckerResult
    from repro_torch.core import HooiResult
    from repro_torch.tucker import TuckerResult

    assert issubclass(TuckerResult, HooiResult)
    assert [f.name for f in dataclasses.fields(HooiResult)] == [
        f.name for f in dataclasses.fields(JHooiResult)]
    # the reference's fields, in its order; the port adds launches
    port = [f.name for f in dataclasses.fields(TuckerResult) if f.name != "launches"]
    assert port == [f.name for f in dataclasses.fields(JTuckerResult)]
    for res in _retraces_cases(tmp_path):
        assert isinstance(res, HooiResult) and res.retraces == 0
        assert res.rel_error == float(res.fit_history[-1])
    empty = HooiResult.from_history(torch.zeros(2, 2), [], np.zeros(0))
    assert np.isnan(empty.rel_error) and empty.engine == "torch"
