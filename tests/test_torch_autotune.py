"""repro_torch.kernels.autotune on the CPU, against the reference's
``tests/test_autotune.py`` (all of it but ``TuckerPlan.analyze``, ROADMAP.md
items 16 and 22, and the reference's Pallas trial smoke).

The port's search space is its own (``BlockConfig``: bn, bi, slots_per_part,
layout), so the cases hold the port to the reference's contract: the
default first, a stable and sensitive fingerprint, an atomic table that
survives corrupt files, a cold search then warm hits with zero trials, the
tuned blocks applied to the plan's engine. Decompositions under non-default
blocks and under the fused layout are held to the reference's pallas engine
(interpret mode) with the same bn, bi and layout applied, from the same
numpy factors: fit within 1e-4, projectors within 1e-3, core within 1e-3 x
max|core| with signs aligned; the default config gives the untuned plan's
bits.
"""
import dataclasses
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro_torch.obs as obs
from repro import tucker as jtucker
from repro.core.engine import make_engine as jmake_engine
from repro.kernels import autotune as jat
from repro.sparse.generators import random_sparse_tensor as jrandom
from repro_torch import tucker
from repro_torch.convert import coo_from_numpy
from repro_torch.core.engine import make_engine
from repro_torch.kernels import autotune as at
from repro_torch.kernels import kron_kernel, launch_count, ttm_kernel
from repro_torch.sparse.generators import random_sparse_tensor
from repro_torch.sparse.layout import DeviceSchedule, build_mode_layout

CPU = {"device": "cpu"}


@pytest.fixture(autouse=True)
def _fresh(tmp_path, monkeypatch):
    """Fresh counters, an empty plan cache and a private table per test."""
    monkeypatch.setenv(at.TABLE_ENV, str(tmp_path / "table.json"))
    at.reset_counters()
    tucker.clear_plan_cache()
    obs.tracer.clear()
    yield
    obs.configure(enabled=False)
    obs.tracer.clear()
    at.reset_counters()
    tucker.clear_plan_cache()


def _cheap_trials(monkeypatch, times=None):
    """Replace the timed trial with a table lookup; the trial counter still
    moves (it is the contract)."""
    calls = []

    def fake(cfg, shape, ranks, nnz, **kw):
        at.COUNTERS["trials"] += 1
        calls.append(cfg)
        return (times or {}).get(cfg, 1.0)

    monkeypatch.setattr(at, "trial_time_ms", fake)
    return calls


# -- fingerprint and nnz bucket ------------------------------------------------------


@pytest.mark.parametrize("nnz", [0, 1, 5, 1023, 1024, 1025, 76_879_419])
def test_nnz_bucket_matches_the_reference(nnz):
    assert at.nnz_bucket(nnz) == jat.nnz_bucket(nnz)


def test_fingerprint_stable_and_sensitive():
    base = dict(dtype="float32", precision="fp32", backend="cpu")
    fp = at.fingerprint((20, 16, 12), (3, 3, 2), 500, **base)
    assert fp == at.fingerprint((20, 16, 12), (3, 3, 2), 500, **base)
    assert fp == at.fingerprint((20, 16, 12), (3, 3, 2), 400, **base)  # one bucket
    for other in (at.fingerprint((20, 16, 12), (3, 3, 2), 5000, **base),
                  at.fingerprint((20, 16, 13), (3, 3, 2), 500, **base),
                  at.fingerprint((20, 16, 12), (3, 3, 3), 500, **base),
                  at.fingerprint((20, 16, 12), (3, 3, 2), 500, dtype="float32",
                                 precision="bf16_fp32acc", backend="cpu"),
                  at.fingerprint((20, 16, 12), (3, 3, 2), 500, dtype="float64",
                                 precision="fp32", backend="cpu"),
                  at.fingerprint((20, 16, 12), (3, 3, 2), 500, dtype="float32",
                                 precision="fp32", backend="cuda:NVIDIA H100 80GB HBM3:sm_90")):
        assert other != fp
    # the two packages never share an entry
    assert fp != jat.fingerprint((20, 16, 12), (3, 3, 2), 500, **base)
    assert at.backend_of("cpu") == "cpu"


# -- candidates: prune and ranking --------------------------------------------------------


def test_candidates_default_first_and_pruned():
    shape, ranks, nnz = (200, 200, 200), (16, 16, 16), 4000
    cands = at.candidate_configs(shape, ranks, nnz)
    assert cands[0] == at.DEFAULT_CONFIG == at.BlockConfig(128, 128, 1024, "split")
    assert len(set(cands)) == len(cands) > 4
    limit = at.H100_SMEM_PER_BLOCK_OPTIN
    default_slots = at.padded_slots(at.DEFAULT_CONFIG, shape, nnz)
    for c in cands[1:]:
        assert at.smem_bytes(c, shape, ranks) <= limit
        assert at.padded_slots(c, shape, nnz) <= at.SLOT_CACHE_GROWTH * default_slots
    # ranked by modeled bytes a sweep (to three digits)
    b = [float(f"{at.sweep_bytes(c, shape, ranks, nnz):.3g}") for c in cands[1:]]
    assert b == sorted(b)
    # 902 nonzeros over 20000^3 (Amazon): ~6 a row-block group, so each
    # group is one padded block; bn 256 over bi 64 would hold 3.8x the
    # default's slots, and is pruned (bn 256 over bi 128: exactly 2x, kept)
    amazon = at.candidate_configs((20000, 20000, 20000), (32, 32, 32), 902)
    assert {(c.bn, c.bi) for c in amazon} == {
        (bn, bi) for bn in (64, 128, 256) for bi in (64, 128, 256)} - {(256, 64)}


def test_candidates_fused_layout_only_for_order3():
    assert any(c.layout == "fused" for c in at.candidate_configs((50, 40, 30), (4, 4, 4), 1000))
    assert all(c.layout == "split"
               for c in at.candidate_configs((20, 20, 20, 20), (3, 3, 3, 3), 1000))
    assert all(c.layout == "split" for c in at.candidate_configs((50, 40), (4, 4), 1000))


def test_shared_memory_model_is_the_launchers():
    """Kernel 1's ring at ranks 16 is 8 KB a warp (64 KB for 8 warps) and
    kernel 5's 8-warp CTA adds a 16 KB partial and 18 KB of held rows
    (csrc/kron_scatter_ttm.cu); bf16 halves the ring; a core rank of 256
    needs a 256 KB partial even for one warp, so fused is pruned."""
    ring = at._ring_bytes(16, 16, "fp32")
    assert ring == 8192 and at._ring_bytes(16, 16, "bf16_fp32acc") == 4096
    assert at._mega_cta_bytes(8, 16, ring) == 65536 + 16384 + 18432 + 64
    split, fused = at.BlockConfig(), at.BlockConfig(layout="fused")
    assert at.smem_bytes(split, (100, 100, 100), (16, 16, 16)) == ring
    assert at.smem_bytes(fused, (100, 100, 100), (16, 16, 16)) > ring
    big = ((300, 300, 300), (16, 16, 256))
    assert at.smem_bytes(fused, *big) > at.H100_SMEM_PER_BLOCK_OPTIN
    assert all(c.layout == "split" for c in at.candidate_configs(*big, 5000))


@pytest.mark.parametrize("ra,rb,dmma,cuda_cores", [(16, 16, 16384, 16384),
                                                   (13, 22, 24576, 20480),
                                                   (33, 40, 49152, 40960),
                                                   (7, 0, 8192, 4096)])
def test_ring_model_follows_each_f64_route(ra, rb, dmma, cuda_cores):
    """Kernels 1 and 5 walk on the tensor cores in every precision and stage
    alike (csrc/kron_walk.cuh staged_strides): whole 16-element blocks, at
    ranks (13, 22) 2 x 32 x (16 + 32) x 8 bytes in f64 (DMMA); a 2-way
    tensor (rb = 0) stages a alone; f32 the same blocks in 4 bytes, bf16 in
    2 (a quarter of the f64 ring). The route left on the CUDA cores, the
    chain kernel's f64 route, stages its first factor in whole 4-column lane
    tiles and the next in 8-element rows: its two first factors' share of
    the ring is 2 x 32 x (16 + 24) x 8 at (13, 22)."""
    assert at._ring_bytes(ra, rb, "fp32", "float64") == dmma
    assert at._ring_bytes(ra, rb, "fp32") == dmma // 2
    assert at._ring_bytes(ra, rb, "bf16_fp32acc") == dmma // 4
    assert at._ring_bytes(ra, rb, "bf16_fp32acc", "float64") == dmma // 4
    assert at._chain_ring_bytes([ra, rb] if rb else [ra], "fp32", "float64") == cuda_cores


def test_smem_model_keeps_kernel5s_f64_ring_on_the_fused_layout():
    """In f64 the split layout's prune counts kernel 1's DMMA rings; the
    fused layout's counts kernel 5's CTA of one warp on the last mode's
    ring, the same DMMA ring, with its partial, held row and U in f64."""
    shape, ranks = (300, 200, 100), (13, 22, 10)
    split, fused = at.BlockConfig(), at.BlockConfig(layout="fused")
    dmma = [at._ring_bytes(*at._operand_ranks(ranks, m), "fp32", "float64") for m in range(3)]
    assert dmma == [24576, 16384, 24576]
    assert at.smem_bytes(split, shape, ranks, dtype="float64") == 24576
    k5_ring = at._ring_bytes(22, 13, "fp32", "float64")
    assert k5_ring == 2 * 32 * (32 + 16) * 8 == dmma[2]
    # ring, partial (one m16 tile x 32 n8 tiles), held rows (2 x 258), U (2 x 18), counters
    want = k5_ring + 32 * 128 * 8 + 2 * 258 * 8 + 2 * 18 * 8 + 64
    assert at._mega_cta_bytes(1, 10, k5_ring, 8) == want
    assert at.smem_bytes(fused, shape, ranks, dtype="float64") == max(24576, want)


def _shape_of(ra: int, rb: int, r: int, kind: int, smem_max: int = at.H100_SMEM_PER_BLOCK_OPTIN):
    """csrc/kron_scatter_ttm.cu's shape_of, written out: the staged strides
    (kron_walk.cuh staged_strides of the rows padded to 16 bytes), then as
    many warps (at most 8) as fit ``smem_max`` with the ring, the partial,
    the held rows and U (Smem); returns (warps, bytes), or None."""
    elem, ev = {0: 4, 1: 2, 2: 8}[kind], 8 if kind == 2 else 4
    per16 = 16 // elem
    lda, ldb = -(-ra // per16) * per16, (-(-rb // per16) * per16 if rb else 0)
    up = lambda x, m: -(-x // m) * m  # noqa: E731
    sla = up(max(lda, up(ra, 16)), 16)
    slb = up(max(ldb, up(rb, 16)), 16) if ldb else 0
    ring = 2 * 32 * (sla + slb) * elem
    rp, pad = up(r, 16), 2 if ev == 8 else 8
    for nw in range(8, 0, -1):
        total = (nw * ring + nw * (rp // 16) * -(-32 // nw) * 128 * ev
                 + nw * 2 * (256 + pad) * ev + nw * 2 * (rp + pad) * ev + 64)
        if total <= smem_max:
            return nw, total
    return None


@pytest.mark.parametrize("precision,dtype,kind", [("fp32", "float64", 2),
                                                  ("bf16_fp32acc", "float32", 1),
                                                  ("bf16_fp32acc", "float64", 1),
                                                  ("fp32", "float32", 0)])
@pytest.mark.parametrize("ranks", [(16, 16, 16), (13, 17, 10), (17, 9, 11), (2, 1, 17),
                                   (16, 16, 128), (7, 5)])
def test_fused_layout_prune_is_kernel5s_shape(ranks, precision, dtype, kind):
    """The fused layout's prune and kernel 5's CTA model agree with the
    launcher's shape_of in f64 and bf16 (and f32), at ranks 16 and at 15g's
    odd ranks: one warp's CTA is what smem_bytes counts for the last mode,
    and the 8-warp CTA of the model is the launcher's where 8 warps fit."""
    n = len(ranks)
    ra, rb = at._operand_ranks(ranks, n - 1)
    ring = at._ring_bytes(ra, rb, precision, dtype)
    ev = at._sum_bytes(precision, dtype)
    one = _shape_of(ra, rb, ranks[-1], kind, smem_max=1 << 30)
    assert one[0] == 8 and at._mega_cta_bytes(8, ranks[-1], ring, ev) == one[1]
    cut = _shape_of(ra, rb, ranks[-1], kind, smem_max=at._mega_cta_bytes(1, ranks[-1], ring, ev))
    assert cut == (1, at._mega_cta_bytes(1, ranks[-1], ring, ev))
    fused = at.BlockConfig(layout="fused")
    shape = tuple(40 + 10 * m for m in range(n))
    split_ring = max(at._ring_bytes(*at._operand_ranks(ranks, m), precision, dtype)
                     for m in range(n))
    if n == 3:
        assert at.smem_bytes(fused, shape, ranks, precision, dtype) == max(
            split_ring, at._mega_cta_bytes(1, ranks[-1], ring, ev))
    fits = _shape_of(ra, rb, ranks[-1], kind) is not None
    offered = any(c.layout == "fused"
                  for c in at.candidate_configs(shape, ranks, 5000, precision=precision,
                                                dtype=dtype))
    assert offered == (fits and n == 3)


# -- the table ------------------------------------------------------------------------


def test_table_roundtrip(tmp_path):
    path = str(tmp_path / "tab.json")
    t = at.TuningTable(path)
    assert len(t) == 0
    cfg = at.BlockConfig(64, 256, 512, "fused")
    t.put("abc", cfg, key={"shape": [4, 4, 4]}, trial_ms=1.5)
    t.save()
    t2 = at.TuningTable(path)
    assert "abc" in t2 and t2.get("abc") == cfg
    assert t2.get("missing") is None
    assert json.loads((tmp_path / "tab.json").read_text())["version"] == at.TABLE_VERSION


def test_table_tolerates_corrupt_and_versioned_files(tmp_path):
    path = tmp_path / "tab.json"
    path.write_text("{not json")
    assert len(at.TuningTable(str(path))) == 0
    path.write_text(json.dumps({"version": 999, "entries": {"x": {}}}))
    assert len(at.TuningTable(str(path))) == 0
    path.write_text(json.dumps([1, 2, 3]))
    assert len(at.TuningTable(str(path))) == 0


def test_default_table_path_follows_its_own_variable(tmp_path, monkeypatch):
    monkeypatch.setenv(at.TABLE_ENV, str(tmp_path / "x.json"))
    assert at.default_table_path() == str(tmp_path / "x.json")
    assert at.TABLE_ENV != jat.TABLE_ENV
    monkeypatch.delenv(at.TABLE_ENV)
    assert at.default_table_path().endswith("repro_torch/autotune.json")


# -- the search ------------------------------------------------------------------------


def test_autotune_cold_searches_warm_hits(tmp_path, monkeypatch):
    calls = _cheap_trials(monkeypatch)
    path = str(tmp_path / "tab.json")
    kw = dict(dtype="float32", precision="fp32", backend="cpu", device="cpu")
    cfg = at.autotune((20, 16, 12), (3, 3, 2), 300, table=at.TuningTable(path), max_trials=3,
                      **kw)
    assert isinstance(cfg, at.BlockConfig) and calls[0] == at.DEFAULT_CONFIG
    assert at.COUNTERS == {"searches": 1, "trials": 3, "table_hits": 0}
    cfg2 = at.autotune((20, 16, 12), (3, 3, 2), 300, table=at.TuningTable(path), max_trials=3,
                       **kw)
    assert cfg2 == cfg
    assert at.COUNTERS == {"searches": 1, "trials": 3, "table_hits": 1}
    # force searches again
    at.autotune((20, 16, 12), (3, 3, 2), 300, table=at.TuningTable(path), max_trials=3,
                force=True, **kw)
    assert at.COUNTERS["searches"] == 2 and at.COUNTERS["trials"] == 6


def test_autotune_picks_fastest_candidate(tmp_path, monkeypatch):
    cands = at.candidate_configs((20, 16, 12), (3, 3, 2), 300)[:4]
    times = {c: 5.0 for c in cands}
    times[cands[2]] = 0.5
    _cheap_trials(monkeypatch, times)
    cfg = at.autotune((20, 16, 12), (3, 3, 2), 300, table=at.TuningTable(str(tmp_path / "t")),
                      max_trials=4, device="cpu")
    assert cfg == cands[2]
    assert at.TuningTable(str(tmp_path / "t")).get(
        at.fingerprint((20, 16, 12), (3, 3, 2), 300)) == cands[2]


def test_autotune_survives_crashing_trials(tmp_path, monkeypatch):
    """A candidate whose trial raises loses; the search goes on, and its
    autotune.trial span records the error."""
    real = at.trial_time_ms

    def boom(cfg, *a, **kw):
        if cfg != at.DEFAULT_CONFIG:
            with obs.span("autotune.trial", layout=cfg.layout):
                at.COUNTERS["trials"] += 1
                raise RuntimeError("untunable candidate")
        return real(cfg, *a, **kw)

    monkeypatch.setattr(at, "trial_time_ms", boom)
    obs.configure(enabled=True)
    cfg = at.autotune((20, 16, 12), (3, 3, 2), 300, table=at.TuningTable(str(tmp_path / "t")),
                      max_trials=4, device="cpu")
    assert cfg == at.DEFAULT_CONFIG
    assert at.COUNTERS["trials"] == 4
    trials = [e for e in obs.tracer.events() if e.name == "autotune.trial"]
    assert [e.attrs.get("error") for e in trials] == [None] + ["RuntimeError"] * 3
    assert trials[0].attrs["best_ms"] > 0
    search = [e for e in obs.tracer.events() if e.name == "autotune.search"]
    assert len(search) == 1 and search[0].attrs["candidates"] >= 4


def test_real_trials_on_the_cpu(tmp_path):
    """Real trials (the kernels' plain versions): the default alone with
    max_trials=1, then a full search of 4 whose every trial ran."""
    obs.configure(enabled=True)
    cfg = at.autotune((12, 10, 8), (3, 3, 2), 150, table=at.TuningTable(str(tmp_path / "a")),
                      max_trials=1, device="cpu")
    assert cfg == at.DEFAULT_CONFIG
    assert at.COUNTERS["searches"] == 1 and at.COUNTERS["trials"] == 1
    at.autotune((12, 10, 8), (3, 3, 2), 150, table=at.TuningTable(str(tmp_path / "b")),
                max_trials=4, device="cpu")
    trials = [e for e in obs.tracer.events() if e.name == "autotune.trial"]
    assert len(trials) == 5 and all("error" not in e.attrs for e in trials)
    assert all(e.attrs["nnz"] == 256 for e in trials)  # the bucket of 150


def test_fused_trial_runs_kernel_5(monkeypatch):
    """A fused trial's core update is kernel 5 (its plain version here); a
    split trial's is kernel 2."""
    ran = []
    for name, mod in (("fused_kron_scatter_ttm", kron_kernel), ("ttm", ttm_kernel)):
        plain = getattr(mod, f"{name}_plain")

        def counted(*a, _plain=plain, _name=name, **kw):
            ran.append(_name)
            return _plain(*a, **kw)

        monkeypatch.setattr(mod, f"{name}_plain", counted)
    at.trial_time_ms(at.BlockConfig(layout="fused"), (12, 10, 8), (3, 3, 2), 150, device="cpu",
                     repeats=1)
    assert set(ran) == {"fused_kron_scatter_ttm"} and len(ran) == 2  # warm-up + one timed
    ran.clear()
    at.trial_time_ms(at.DEFAULT_CONFIG, (12, 10, 8), (3, 3, 2), 150, device="cpu", repeats=1)
    assert set(ran) == {"ttm"}


# -- through the plan ----------------------------------------------------------------------


def _jcoo(shape=(20, 16, 12), seed=0, density=0.05):
    return jrandom(shape, density, seed=seed)


# a tall last mode: the fused layout, which writes no last unfolding, ranks
# among the first four candidates here
TALL = (20, 16, 600)


def _port(j):
    return coo_from_numpy(np.asarray(j.indices), np.asarray(j.values), tuple(j.shape))


def test_plan_autotune_cold_then_warm_zero_search(monkeypatch):
    _cheap_trials(monkeypatch)
    coo = _port(_jcoo())
    spec = tucker.TuckerSpec(coo.shape, (3, 3, 2), method="gram", n_iter=2, autotune=True)
    res1 = tucker.plan(spec, **CPU)(coo)
    assert res1.tuned_blocks is not None and at.COUNTERS["searches"] == 1
    trials = at.COUNTERS["trials"]
    assert trials == 4
    tucker.plan(spec, **CPU)(coo)  # the same plan: tuned once per plan
    assert at.COUNTERS == {"searches": 1, "trials": trials, "table_hits": 0}
    tucker.clear_plan_cache()  # forget the plan, keep the table
    res2 = tucker.plan(spec, **CPU)(coo)
    assert at.COUNTERS == {"searches": 1, "trials": trials, "table_hits": 1}
    assert res2.tuned_blocks == res1.tuned_blocks
    np.testing.assert_array_equal(res2.fit_history, res1.fit_history)
    assert torch.equal(res2.core, res1.core)


def test_plan_autotune_applies_blocks_to_engine(monkeypatch):
    coo = _port(_jcoo(TALL, seed=1, density=0.002))
    cands = at.candidate_configs(TALL, (3, 3, 2), coo.nnz)[:4]
    winner = next(c for c in cands if c.layout == "fused")
    _cheap_trials(monkeypatch, {c: (0.1 if c == winner else 9.0) for c in cands})
    spec = tucker.TuckerSpec(coo.shape, (3, 3, 2), method="gram", n_iter=2, autotune=True)
    p = tucker.plan(spec, **CPU)
    res = p(coo)
    assert tuple(res.tuned_blocks) == tuple(winner)
    assert (p.engine.bn, p.engine.bi, p.engine.slots_per_part) == winner[:3]
    assert p.engine.fuse_core == (winner.layout == "fused")
    sched = p.engine.device_schedule(coo, 0)
    assert (sched.bn, sched.bi) == (winner.bn, winner.bi)
    # a tuned fused plan runs no batched program: its batch is k calls
    assert not p.supports_batched_dispatch


def test_default_config_gives_the_untuned_bits(monkeypatch):
    """A search won by the default applies today's geometry: the untuned
    plan's fit history, factors and core, bit for bit."""
    _cheap_trials(monkeypatch, {at.DEFAULT_CONFIG: 0.1})
    coo = _port(_jcoo(seed=2))
    spec = tucker.TuckerSpec(coo.shape, (3, 3, 2), n_iter=3)
    tuned = tucker.plan(dataclasses.replace(spec, autotune=True), **CPU)(coo)
    plain = tucker.plan(spec, **CPU)(coo)
    assert tuned.tuned_blocks == at.DEFAULT_CONFIG and plain.tuned_blocks is None
    np.testing.assert_array_equal(tuned.fit_history, plain.fit_history)
    assert torch.equal(tuned.core, plain.core)
    assert all(torch.equal(a, b) for a, b in zip(tuned.factors, plain.factors))


def test_spec_autotune_validation():
    for mod in (tucker, jtucker):
        with pytest.raises(ValueError, match="autotune"):
            mod.TuckerSpec(shape=(8, 8), ranks=(2, 2), algorithm="dense", autotune=True)
    coo = random_sparse_tensor((10, 8, 6), 0.05, seed=2)
    assert tucker.decompose(coo, (2, 2, 2), n_iter=2, **CPU).tuned_blocks is None


def test_apply_blocks_rebuilds_the_schedules_only_on_new_geometry():
    coo = _port(_jcoo(seed=3))
    eng = make_engine("torch", "cpu")
    eng.device_schedule(coo, 0)
    eng.apply_blocks(at.BlockConfig(layout="fused"))  # same geometry: kept
    eng.device_schedule(coo, 0)
    assert eng.schedule_builds == 1 and eng.fuse_core
    eng.apply_blocks(at.BlockConfig(slots_per_part=512))
    sched = eng.device_schedule(coo, 0)
    assert eng.schedule_builds == 2 and not eng.fuse_core
    want = DeviceSchedule.from_layout(build_mode_layout(coo, 0), coo, slots_per_part=512)
    assert torch.equal(sched.parts, want.parts)


# -- decompositions under non-default blocks, against the reference -----------------------


def _f0(shape, ranks):
    rng = np.random.default_rng(0)
    return [np.linalg.qr(rng.standard_normal((s, r)))[0].astype(np.float32)
            for s, r in zip(shape, ranks)]


@pytest.mark.parametrize("blocks", [(64, 256, 512, "split"), (256, 64, 2048, "split"),
                                    (128, 128, 1024, "fused"), (64, 64, 512, "fused")])
@pytest.mark.parametrize("method", ["householder", "gram"])
def test_blocks_decompose_as_the_reference(blocks, method, monkeypatch):
    """The port under ``blocks`` against the reference's pallas engine with
    the same bn, bi and layout (interpret mode; its own TTM tile), from the
    same factors, three sweeps; and against the port's default blocks."""
    jc = _jcoo((40, 35, 30), seed=5)
    coo = _port(jc)
    ranks = (5, 4, 3)
    cfg = at.BlockConfig(*blocks)
    f0 = _f0(coo.shape, ranks)
    eng = make_engine("torch", "cpu")
    eng.apply_blocks(cfg)
    spec = tucker.TuckerSpec(coo.shape, ranks, method=method, n_iter=3)
    port = tucker.plan(spec, engine=eng, **CPU)(coo, factors_init=f0)
    jeng = jmake_engine("pallas", fuse_core=cfg.layout == "fused")
    jeng.apply_blocks(jat.BlockConfig(bn=cfg.bn, bi=cfg.bi, layout=cfg.layout))
    jspec = jtucker.TuckerSpec(shape=coo.shape, ranks=ranks, method=method, n_iter=3,
                               engine="pallas")
    ref = jtucker.plan(jspec, engine=jeng)(jc, factors_init=[jnp.asarray(f) for f in f0])
    default = tucker.plan(spec, **CPU)(coo, factors_init=f0)
    for want in (ref, default):
        np.testing.assert_allclose(port.fit_history, want.fit_history, rtol=0, atol=1e-4)
        core = port.core.numpy()
        for n, (a, b) in enumerate(zip(port.factors, want.factors)):
            a, b = a.numpy(), np.asarray(b)
            np.testing.assert_allclose(a @ a.T, b @ b.T, rtol=0, atol=1e-3)
            sign = np.sign(np.sum(a * b, axis=0))
            core = core * sign.reshape([-1 if t == n else 1 for t in range(core.ndim)])
        scale = float(np.abs(np.asarray(want.core)).max())
        np.testing.assert_allclose(core, np.asarray(want.core), rtol=0, atol=1e-3 * scale)
    sched = eng.device_schedule(coo, 0)
    assert (sched.bn, sched.bi) == (cfg.bn, cfg.bi)


def test_tuned_plan_counts_its_launches(monkeypatch):
    """Under the fused layout a sweep launches kernel 1 on each mode and
    kernel 5 once (the plain versions count as their kernels would)."""
    from test_torch_batch import count_plain_launches

    own_y = kron_kernel.fused_kron_scatter_plain
    count_plain_launches(monkeypatch)
    counted_k1 = kron_kernel.fused_kron_scatter_plain
    real = kron_kernel.fused_kron_scatter_ttm_plain

    def counted(*a, **kw):
        launch_count.count(kron_kernel.fused_kron_scatter_ttm)
        # kernel 5's plain version forms its Y with kernel 1's: no launch of 1
        kron_kernel.fused_kron_scatter_plain = own_y
        try:
            return real(*a, **kw)
        finally:
            kron_kernel.fused_kron_scatter_plain = counted_k1

    monkeypatch.setattr(kron_kernel, "fused_kron_scatter_ttm_plain", counted)
    coo = _port(_jcoo(TALL, seed=6, density=0.002))
    fused = next(c for c in at.candidate_configs(TALL, (3, 3, 2), coo.nnz)[:4]
                 if c.layout == "fused")
    _cheap_trials(monkeypatch, {fused: 0.1})
    spec = tucker.TuckerSpec(coo.shape, (3, 3, 2), n_iter=2, autotune=True)
    t0 = launch_count.tally()
    res = tucker.plan(spec, **CPU)(coo)
    assert res.tuned_blocks.layout == "fused"
    assert launch_count.since(t0) == {"fused_kron_scatter": 6, "fused_kron_scatter_ttm": 2}
