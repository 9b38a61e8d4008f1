"""The ``ssm`` and ``hybrid`` families served across the ranks of a mesh with a
model axis above 1, on the CPU, against the JAX package: tensor-parallel
Mamba-2 layers (heads, channels and the gated RMSNorm over a cut
``d_inner``), the decode state cut by ``model.cache_pspecs``, and Zamba2's
shared block on the attention families' mesh layers.

The port's ranks are CPU processes over gloo, spawned from a subprocess that
keeps JAX out of them, as ``tests/test_torch_serve_ranks.py`` spawns them
(its helpers are reused); each rank gets the whole batch and its blocks of
the reference's parameters. Meshes (1, 2), (1, 4) and (2, 2); both rules
tables; f32 SMOKE configs: mamba2-1.3b (``"cp"``: it has no attention) and
zamba2-2.7b (``"cp"`` and ``"hp"``). Extra cases: mamba2-1.3b with
``ssm_chunk=8`` (three SSD chunks) on (1, 4), mamba2-1.3b at ``d_model=96``
on (1, 4) (``d_inner`` 192 divides over 4 ranks, its 6 heads do not: every
leaf that arrived cut is gathered and every rank runs every head), and a
batch and prompt that divide over no axis (``ODD_B``, ``ODD_P``), whose
prefill logits are held to the reference's one-device prefill of the same
prompts and whose greedy tokens to the port's world of one.

What each case is held to, as a fraction of max|reference|, against the
reference's one-device run (the function does not depend on the mesh):
  * the last-token prefill logits within 1e-5; the multi-chunk case within
    5e-3, ``test_torch_families.py``'s rule after a bf16 rounding (its
    states pass through the bf16 scan), and within 1e-5 of the port's world
    of one;
  * the prefill cache gathered from the ranks within one bf16 ulp entry by
    entry: the conv windows and K/V are bf16, and ``h`` is the bf16 scan's
    last state widened to f32 (one chunk too), so an f32 value summed in
    another order can round to its neighbour (measured 3.7e-4 of max|h| on
    (1, 2), 1.8e-4 for the port's world of one);
  * four teacher-forced decode steps from the reference's padded cache cut
    by ``cache_pspecs`` (``convert.lm_cache_from_numpy(..., sharding=)``)
    within 1e-4, ``test_torch_lm.py``'s and ``test_torch_families.py``'s
    rule for a decode from the reference's cache in f32: each step writes
    its token's conv window entries and K/V in bf16 and reads them back, so
    an entry can round one bf16 ulp from the reference's. The port's world
    of one lands 8.0e-5 from the reference at Zamba2's step 2 and 7.2e-5
    at the d_model 96 Mamba2's step 4 (``test_torch_serve_ranks.py``'s 2e-5
    holds for mamba2-1.3b, 7.6e-7); the mesh lands within 8.0e-5 of the
    world of one;
  * ``Engine.generate`` giving the port's world of one's greedy tokens, with
    a budget that divides over the model axes and one that does not;
  * every rank the same bits;
  * kernel 7 once a Mamba layer a prefill on the rank's heads, none in a
    decode step; kernel 6 once a shared block a prefill, on operands the
    card's kernel takes;
  * each collective's counted bytes equal to a count derived here from the
    shapes.
Also: the cut gated RMSNorm against ``layers.rmsnorm`` of the whole,
``cache_pspecs`` against the reference's ``cache_specs`` spec by spec,
``lm_cache_from_numpy(..., sharding=)`` on the stacked and the hybrid
``SsmState``, and a rules table whose model names disagree refused.
"""
import contextlib
import dataclasses
import json
import math
import os
from pathlib import Path

import numpy as np
import pytest
import torch

import test_torch_serve_ranks as base
from test_torch_serve_ranks import (B, BUDGET, LOGIT_TOL, MESHES, NEW, ODD_B,
                                    ODD_BUDGET, ODD_P, ONE_BF16_ULP, P, RULES, STEPS, _bf16,
                                    _duck_mesh, _finish, _load, _rel, _start, digest,
                                    flat_names, kernel6_operands_checked, mesh_id, unflatten)
from repro_torch.configs import get_config
from repro_torch.convert import lm_cache_from_numpy, lm_params_from_numpy
from repro_torch.launch import mesh as tmesh
from repro_torch.models import layers as tlayers
from repro_torch.models import mamba2 as tmamba
from repro_torch.models import model as tmodel
from repro_torch.models import sharding as tsharding
from repro_torch.models.mamba2 import SsmState
from repro_torch.serve.engine import Engine, ServeConfig

PORT_ONLY = base.PORT_ONLY  # the port's subprocess and its ranks skip the JAX package
if not PORT_ONLY:
    import jax
    import jax.numpy as jnp
    from jax.sharding import AbstractMesh

    from repro.configs import get_config as jget_config
    from repro.configs.base import ShapeConfig as JShapeConfig
    from repro.launch.inputs import cache_specs as jcache_specs
    from repro.models import model as jmodel
    from repro.models import sharding as jsharding
    from repro.serve.engine import Engine as JEngine
    from repro.serve.engine import ServeConfig as JServeConfig

MULTI_CHUNK_TOL = 5e-3  # test_torch_families.py's rule after a bf16 rounding
SSM_DECODE_TOL = 1e-4  # test_torch_lm.py's TIGHT: a decode from the reference's cache
# model key -> (config, the fields it replaces)
MODELS = {"mamba2-1.3b": ("mamba2-1.3b", {}),
          "zamba2-2.7b": ("zamba2-2.7b", {}),
          "mamba2-chunk8": ("mamba2-1.3b", {"ssm_chunk": 8}),
          "mamba2-d96": ("mamba2-1.3b", {"d_model": 96})}
MULTI_CHUNK = ("mamba2-chunk8",)
PARTS = {"mamba2-1.3b": ("cp",), "zamba2-2.7b": ("cp", "hp")}
CASES = ([(m, r, p, name) for m in MESHES for r in RULES for name in PARTS
          for p in PARTS[name]]
         + [((1, 4), "DEFAULT_RULES", "cp", "mamba2-chunk8"),
            ((1, 4), "RULES_SERVE", "cp", "mamba2-d96")])
CASE_IDS = [f"{mesh_id(m)}-{r}-{p}-{name}" for m, r, p, name in CASES]
ODD_CASES = [c for c in CASES if c[2] == "cp" and c[3] in PARTS]
ODD_IDS = [CASE_IDS[CASES.index(c)] for c in ODD_CASES]
HYBRID_IDS = [c for c in CASE_IDS if c.endswith("zamba2-2.7b")]


def port_cfg(name: str, part: str = "cp"):
    arch, extra = MODELS[name]
    return dataclasses.replace(get_config(arch, smoke=True), dtype="float32",
                               attn_partitioning=part, **extra)


def cache_flat(cache) -> dict:
    """A cache's leaves (or specs) by name: ``k``, ``v``; ``conv_x`` ...
    ``h`` (an ``SsmState``, either package's); or ``ssm/conv_x`` ...
    ``attn/v`` (the hybrid's)."""
    if isinstance(cache, dict) and "attn" in cache:
        return {**{f"ssm/{k}": v for k, v in cache_flat(cache["ssm"]).items()},
                **{f"attn/{k}": v for k, v in cache_flat(cache["attn"]).items()}}
    if isinstance(cache, dict):
        return {k: cache[k] for k in ("k", "v")}
    return dict(zip(SsmState._fields, cache))


def cache_tree(flat: dict, prefix: str = ""):
    """:func:`cache_flat`'s inverse."""
    if f"{prefix}ssm/h" in flat:
        return {"ssm": cache_tree(flat, f"{prefix}ssm/"),
                "attn": {k: flat[f"{prefix}attn/{k}"] for k in ("k", "v")}}
    return SsmState(*(flat[f"{prefix}{k}"] for k in SsmState._fields))


# -- the port's ranks ----------------------------------------------------------------


def _params(mesh, name: str, cfg, rules, tmp: str):
    numpy_params = unflatten(_load(Path(tmp, f"params-{name}.npz")), "", tmodel.param_defs(cfg))
    return lm_params_from_numpy(numpy_params, cfg, "cpu",
                                sharding=(mesh, tmodel.param_pspecs(cfg, rules, mesh)))


@contextlib.contextmanager
def kernel7_calls():
    """The shape of each call of ``ops.ssd_chunk`` inside."""
    from repro_torch.kernels import ops

    real, calls = ops.ssd_chunk, []

    def record(x, a, b, c):
        calls.append(list(x.shape) + [int(b.shape[-1])])
        return real(x, a, b, c)

    ops.ssd_chunk = record
    try:
        yield calls
    finally:
        ops.ssd_chunk = real


def _case(mesh, case, tmp: str) -> dict:
    """One case on this rank: prefill, the gathered cache, decode steps
    from the reference's cache, generate; the counters and the kernel calls
    of a prefill and of the decode steps."""
    shape, rules_name, part, name = case
    rules = getattr(tsharding, rules_name)
    cfg = port_cfg(name, part)
    params = _params(mesh, name, cfg, rules, tmp)
    tokens = torch.from_numpy(_load(Path(tmp, f"data-{name}.npz"))["tokens"]).long()
    eng = Engine(cfg, params, ServeConfig(max_seq_len=BUDGET, batch_size=B), device="cpu",
                 mesh=mesh, rules=rules)
    mesh.reset_counters()
    with kernel6_operands_checked() as calls6, kernel7_calls() as calls7:
        logits, cache = eng.prefill(params, {"tokens": tokens[:, :P]})
    counters = {"prefill": dict(mesh.counters)}
    specs = cache_flat(tmodel.cache_pspecs(cfg, rules, mesh, B, P))
    whole = {k: mesh.gather_full(t, specs[k]).float().numpy()
             for k, t in cache_flat(cache).items()}
    ref = _load(Path(tmp, f"ref-{name}.npz"))
    padded = cache_tree({k[4:]: ref[k] for k in ref if k.startswith("pad/")})
    dspecs = tmodel.cache_pspecs(cfg, rules, mesh, B, BUDGET)
    dcache = lm_cache_from_numpy(padded, "cpu", sharding=(mesh, dspecs))
    held = {k: tuple(t.shape) for k, t in cache_flat(dcache).items()}
    steps = []
    with kernel7_calls() as decode7:
        for i in range(STEPS):
            mesh.reset_counters()
            step_logits, dcache = eng.decode(params, dcache,
                                             {"token": tokens[:, P + i:P + i + 1], "pos": P + i})
            if i == 0:
                counters["decode"] = dict(mesh.counters)
            steps.append(step_logits.numpy())
    gen = eng.generate(tokens[:, :P].numpy(), NEW)
    odd = Engine(cfg, params, ServeConfig(max_seq_len=ODD_BUDGET, batch_size=B), device="cpu",
                 mesh=mesh, rules=rules).generate(tokens[:, :P].numpy(), NEW)
    out = {"prefill": logits.numpy(), "decode": np.stack(steps), "gen": gen, "odd": odd,
           **{f"cache/{k}": v for k, v in whole.items()}}
    lay = tsharding.ServeLayout.build(mesh, rules, B, P)
    return {"arrays": out, "counters": counters, "kernel6": calls6, "kernel7": calls7,
            "kernel7_decode": len(decode7), "decode_cache_shapes": held,
            "digest": digest(*(out[k] for k in sorted(out))),
            "layout": {"rows": list(lay.rows(B)), "positions": list(lay.positions()),
                       "n": lay.n, "seq": lay.seq}}


def _odd_case(mesh, case, tmp: str) -> dict:
    """``ODD_B`` prompts of ``ODD_P`` tokens: the prefill's logits and
    ``generate``'s tokens."""
    shape, rules_name, part, name = case
    rules = getattr(tsharding, rules_name)
    cfg = port_cfg(name, part)
    params = _params(mesh, name, cfg, rules, tmp)
    prompts = _load(Path(tmp, f"data-{name}.npz"))["tokens"][:ODD_B, :ODD_P]
    eng = Engine(cfg, params, ServeConfig(max_seq_len=ODD_BUDGET, batch_size=ODD_B),
                 device="cpu", mesh=mesh, rules=rules)
    logits, _ = eng.prefill(params, {"tokens": torch.from_numpy(prompts).long()})
    return {"prefill": logits.numpy(), "gen": eng.generate(prompts, NEW)}


def _rank(rank: int, world: int, store: str, tmp: str) -> None:
    base._init(rank, world, store)
    out = {"rank": rank, "cases": {}}
    arrays = {}
    for shape in [m for m in MESHES if math.prod(m) == world]:
        mesh = tmesh.make_mesh(shape, ("data", "model"), device="cpu")
        for case, cid in zip(CASES, CASE_IDS):
            if case[0] != shape:
                continue
            res = _case(mesh, case, tmp)
            out["cases"][cid] = {k: v for k, v in res.items() if k != "arrays"}
            arrays.update({f"{cid}/{k}": v for k, v in res["arrays"].items()})
            if case in ODD_CASES:
                arrays.update({f"{cid}/odd-{k}": v for k, v in _odd_case(mesh, case, tmp).items()})
    np.savez(Path(tmp, f"port-{world}-r{rank}.npz"), **arrays)
    Path(tmp, f"port-{world}-r{rank}.json").write_text(json.dumps(out))


def main(tmp: str) -> None:
    """The port's side, in a subprocess: the ranks of worlds 2 and 4."""
    import torch.multiprocessing as mp

    for world in (2, 4):
        mp.start_processes(_rank, args=(world, os.path.join(tmp, f"store-{world}"), tmp),
                           nprocs=world, start_method="spawn")
    print(json.dumps({"done": True}))


# -- the reference and the port's world of one ---------------------------------------


def ref_cfg(name: str):
    arch, extra = MODELS[name]
    return dataclasses.replace(jget_config(arch, smoke=True), dtype="float32", **extra)


def reference_run(tmp: Path, name: str) -> dict:
    """The reference's Engine of ``name`` on one device: prefill logits and
    cache, the cache padded to the budget, four teacher-forced decode steps;
    for the odd cases' models, the prefill logits of ``ODD_B`` x ``ODD_P``."""
    from repro.utils.compat import make_mesh

    jcfg = ref_cfg(name)
    params = jax.tree_util.tree_map(jnp.asarray, unflatten(
        _load(tmp / f"params-{name}.npz"), "", jmodel.param_defs(jcfg)))
    tokens = _load(tmp / f"data-{name}.npz")["tokens"]
    eng = JEngine(jcfg, make_mesh((1, 1), ("data", "model")), params,
                  JServeConfig(max_seq_len=BUDGET, batch_size=B))
    logits, cache = eng.prefill(params, {"tokens": jnp.asarray(tokens[:, :P])})
    out = {"prefill": np.asarray(logits, np.float32),
           **{f"cache/{k}": np.asarray(v) for k, v in cache_flat(cache).items()}}
    cache = eng._pad_cache(cache, P)
    out.update({f"pad/{k}": np.asarray(v) for k, v in cache_flat(cache).items()})
    steps = []
    for i in range(STEPS):
        logits, cache = eng.decode(params, cache, {
            "token": jnp.asarray(tokens[:, P + i:P + i + 1]), "pos": jnp.int32(P + i)})
        steps.append(np.asarray(logits, np.float32))
    out["decode"] = np.stack(steps)
    if name in PARTS:  # the odd cases' models: ODD_B prompts of ODD_P tokens
        odd = JEngine(jcfg, make_mesh((1, 1), ("data", "model")), params,
                      JServeConfig(max_seq_len=ODD_BUDGET, batch_size=ODD_B))
        logits, _ = odd.prefill(params, {"tokens": jnp.asarray(tokens[:ODD_B, :ODD_P])})
        out["odd-prefill"] = np.asarray(logits, np.float32)
    return out


def world_one(tmp: Path, name: str) -> dict:
    """The port's world of one: generate with both budgets, the odd batch's
    prefill logits and tokens, and the prefill logits."""
    cfg = port_cfg(name)
    params = lm_params_from_numpy(unflatten(_load(tmp / f"params-{name}.npz"), "",
                                            tmodel.param_defs(cfg)), cfg)
    tokens = _load(tmp / f"data-{name}.npz")["tokens"]
    eng = Engine(cfg, params, ServeConfig(max_seq_len=BUDGET, batch_size=B), device="cpu")
    out = {"gen": eng.generate(tokens[:, :P], NEW),
           "prefill": eng.prefill(params, {"tokens": torch.from_numpy(tokens[:, :P]).long()})[0]
           .numpy()}
    odd = Engine(cfg, params, ServeConfig(max_seq_len=ODD_BUDGET, batch_size=ODD_B),
                 device="cpu")
    prompts = tokens[:ODD_B, :ODD_P]
    out["odd-prefill"] = odd.prefill(params, {"tokens": torch.from_numpy(prompts).long()})[0]
    out["odd-prefill"] = out["odd-prefill"].numpy()
    out["odd-gen"] = odd.generate(prompts, NEW)
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both sides' runs from the reference's initial parameters, written
    here as numpy: the reference's one-device runs, then the port's ranks in
    a subprocess beside the port's world of one here."""
    tmp = tmp_path_factory.mktemp("serve-ranks-ssm")
    rng = np.random.default_rng(11)
    for name in MODELS:
        jcfg = ref_cfg(name)
        jparams = jmodel.init_params(jcfg, jax.random.PRNGKey(0))
        np.savez(tmp / f"params-{name}.npz",
                 **{n: np.asarray(a) for n, a in zip(flat_names(jparams),
                                                     jax.tree_util.tree_leaves(jparams))})
        np.savez(tmp / f"data-{name}.npz",
                 tokens=rng.integers(0, jcfg.vocab_size, (B, P + STEPS)).astype(np.int32))
    ref = {name: reference_run(tmp, name) for name in MODELS}
    for name, out in ref.items():
        np.savez(tmp / f"ref-{name}.npz", **out)
    port = _start(f"import test_torch_serve_ranks_ssm as t; t.main({str(tmp)!r})",
                  {"SERVE_RANKS_PORT_ONLY": "1"})
    world1 = {name: world_one(tmp, name) for name in MODELS}
    _finish(port)
    arrays = {w: [_load(tmp / f"port-{w}-r{r}.npz") for r in range(w)] for w in (2, 4)}
    reports = {w: [json.loads((tmp / f"port-{w}-r{r}.json").read_text()) for r in range(w)]
               for w in (2, 4)}
    return {"ref": ref, "world1": world1, "arrays": arrays, "json": reports}


def _case_of(case_id: str):
    return CASES[CASE_IDS.index(case_id)]


def _port(runs, case_id: str, key: str, rank: int = 0) -> np.ndarray:
    return runs["arrays"][math.prod(_case_of(case_id)[0])][rank][f"{case_id}/{key}"]


def _reports(runs, case_id: str) -> list:
    return [r["cases"][case_id] for r in runs["json"][math.prod(_case_of(case_id)[0])]]


# -- the cases ------------------------------------------------------------------------


@pytest.mark.parametrize("case_id", CASE_IDS)
def test_prefill_logits_match_the_reference(runs, case_id):
    name = _case_of(case_id)[3]
    got = _port(runs, case_id, "prefill")
    tol = MULTI_CHUNK_TOL if name in MULTI_CHUNK else LOGIT_TOL
    assert _rel(got, runs["ref"][name]["prefill"]) <= tol
    assert _rel(got, runs["world1"][name]["prefill"]) <= LOGIT_TOL


@pytest.mark.parametrize("case_id", CASE_IDS)
def test_gathered_prefill_cache_matches_the_reference(runs, case_id):
    name = _case_of(case_id)[3]
    want = runs["ref"][name]
    keys = [k[6:] for k in want if k.startswith("cache/")]
    assert len(keys) == (6 if name == "zamba2-2.7b" else 4)
    for k in keys:
        ref = want[f"cache/{k}"]
        got = _port(runs, case_id, f"cache/{k}")
        ref = ref.astype(np.float32) if k.endswith("h") else _bf16(ref)
        assert got.shape == ref.shape, k
        np.testing.assert_allclose(got, ref, rtol=ONE_BF16_ULP, atol=1e-6 * np.abs(ref).max(),
                                   err_msg=k)


@pytest.mark.parametrize("case_id", CASE_IDS)
def test_decode_steps_from_the_reference_cache_match_the_reference(runs, case_id):
    name = _case_of(case_id)[3]
    want = runs["ref"][name]["decode"]
    got = _port(runs, case_id, "decode")
    for i in range(STEPS):
        assert _rel(got[i], want[i]) <= SSM_DECODE_TOL, i


@pytest.mark.parametrize("case_id", CASE_IDS)
def test_the_decode_cache_is_each_ranks_blocks(runs, case_id):
    """The cache that decode reads and writes holds this rank's blocks under
    ``cache_pspecs``: its rows, its channels, its heads, its budget positions."""
    shape, rules_name, part, name = _case_of(case_id)
    cfg = port_cfg(name, part)
    dd, n = shape
    rows = B // dd
    heads = cfg.ssm_nheads // n if cfg.ssm_nheads % n == 0 else cfg.ssm_nheads
    gn = cfg.ssm_ngroups * cfg.ssm_state
    km1 = cfg.ssm_conv - 1
    lead = ((cfg.n_layers // cfg.hybrid_period, cfg.hybrid_period) if cfg.family == "hybrid"
            else (cfg.n_layers,))
    pre = "ssm/" if cfg.family == "hybrid" else ""
    want = {f"{pre}conv_x": lead + (rows, km1, cfg.d_inner // n),
            f"{pre}conv_b": lead + (rows, km1, gn // n),
            f"{pre}conv_c": lead + (rows, km1, gn // n),
            f"{pre}h": lead + (rows, heads, cfg.ssm_headdim, cfg.ssm_state)}
    if cfg.family == "hybrid":
        kv = lead[:1] + (rows, BUDGET // n, cfg.n_kv_heads, cfg.resolved_head_dim)
        want.update({"attn/k": kv, "attn/v": kv})
    for r in _reports(runs, case_id):
        assert {k: tuple(v) for k, v in r["decode_cache_shapes"].items()} == want


@pytest.mark.parametrize("case_id", CASE_IDS)
def test_generate_gives_the_world_of_ones_greedy_tokens(runs, case_id):
    want = runs["world1"][_case_of(case_id)[3]]["gen"]
    assert np.array_equal(_port(runs, case_id, "gen"), want)
    assert np.array_equal(_port(runs, case_id, "odd"), want)  # a budget that does not divide


@pytest.mark.parametrize("case_id", CASE_IDS)
def test_every_rank_has_the_same_bits(runs, case_id):
    shape = _case_of(case_id)[0]
    reports = _reports(runs, case_id)
    assert len({r["digest"] for r in reports}) == 1
    for w in range(1, math.prod(shape)):
        for key in ("prefill", "decode", "gen"):
            assert np.array_equal(_port(runs, case_id, key, w), _port(runs, case_id, key))
    n = shape[1]
    lays = [r["layout"] for r in reports]
    assert {lay["n"] for lay in lays} == {n} and all(lay["seq"] for lay in lays)
    assert sorted(tuple(lay["positions"]) for lay in lays) == sorted(
        (i * P // n, (i + 1) * P // n) for i in range(n) for _ in range(shape[0]))


@pytest.mark.parametrize("case_id", CASE_IDS)
def test_kernel7_runs_once_a_layer_on_the_ranks_heads(runs, case_id):
    """One ``ops.ssd_chunk`` call a Mamba layer a prefill, on (rows x the
    rank's heads, chunks, L, headdim) with the whole state N; none in a
    decode step."""
    shape, _, part, name = _case_of(case_id)
    cfg = port_cfg(name, part)
    dd, n = shape
    heads = cfg.ssm_nheads // n if cfg.ssm_nheads % n == 0 else cfg.ssm_nheads
    chunk = min(cfg.ssm_chunk, P)
    want = [B // dd * heads, -(-P // chunk), chunk, cfg.ssm_headdim, cfg.ssm_state]
    for r in _reports(runs, case_id):
        assert r["kernel7"] == [want] * cfg.n_layers
        assert r["kernel7_decode"] == 0


@pytest.mark.parametrize("case_id", HYBRID_IDS)
def test_every_kernel6_call_is_one_the_card_takes(runs, case_id):
    """The shared block's attention: one call a superblock a prefill on
    every rank, a query block against the keys up to its end ("cp") or
    every position with the rank's heads ("hp")."""
    shape, _, part, name = _case_of(case_id)
    cfg = port_cfg(name, part)
    for r in _reports(runs, case_id):
        p0, p1 = r["layout"]["positions"]
        want = [p1 - p0, p1] if part == "cp" else [P, P]
        assert r["kernel6"] == [want + [True]] * (cfg.n_layers // cfg.hybrid_period)


@pytest.mark.parametrize("case_id", ODD_IDS)
def test_a_batch_and_prompt_that_divide_over_no_axis_match_the_reference(runs, case_id):
    name = _case_of(case_id)[3]
    assert _rel(_port(runs, case_id, "odd-prefill"), runs["ref"][name]["odd-prefill"]) \
        <= LOGIT_TOL


@pytest.mark.parametrize("case_id", ODD_IDS)
def test_a_batch_and_prompt_that_divide_over_no_axis_match_the_world_of_one(runs, case_id):
    name = _case_of(case_id)[3]
    assert _rel(_port(runs, case_id, "odd-prefill"), runs["world1"][name]["odd-prefill"]) \
        <= LOGIT_TOL
    assert np.array_equal(_port(runs, case_id, "odd-gen"), runs["world1"][name]["odd-gen"])


# -- the collectives' bytes -------------------------------------------------------------


def model_bytes(name: str, shape, rules_name: str, part: str) -> dict:
    """Each collective's payload a rank moves in one prefill and in one
    decode step, counted from the shapes (f32: 4 bytes an element) as
    ``RankMesh.counters`` counts them (see ``test_torch_serve_ranks``)."""
    cfg = port_cfg(name, part)
    dd, n = shape
    e, b = 4, B // dd
    d, v = cfg.d_model, cfg.padded_vocab
    din, gn, nh, k = cfg.d_inner, cfg.ssm_ngroups * cfg.ssm_state, cfg.ssm_nheads, cfg.ssm_conv
    hybrid = cfg.family == "hybrid"

    def cut(w):
        return n > 1 and w % n == 0

    def blk(w):
        return w // n if cut(w) else w

    # the data-axes gathers: lm_head's rows once a call, each Mamba layer's
    # fsdp leaves, the shared block's once a call
    weights = 0
    if rules_name == "DEFAULT_RULES" and dd > 1:
        weights = d * blk(v) + cfg.n_layers * (d * (2 * blk(din) + 2 * blk(gn) + blk(nh))
                                               + blk(din) * d)
        if hybrid:
            qn, kvn = cfg.n_heads * cfg.resolved_head_dim, cfg.n_kv_heads * cfg.resolved_head_dim
            weights += 2 * d * blk(qn) + 2 * d * blk(kvn) + 3 * d * blk(cfg.d_ff)
        weights *= e
    # a layer whose heads do not divide gathers every leaf that arrived cut
    whole_leaves = (2 * d * din + din + din * k) * cut(din) + 2 * (d + k) * gn * cut(gn)
    out = {}
    for mode, s in (("prefill", P), ("decode", 1)):
        c = {"all_gather": weights, "reduce_scatter": 0, "all_reduce": 0, "all_to_all": 0}
        seq = s % n == 0
        wo = "reduce_scatter" if seq else "all_reduce"
        if cut(d):  # the embedding
            c["all_to_all" if seq else "all_gather"] += e * b * s * d // (n if seq else 1)
        for _ in range(cfg.n_layers):
            if seq:
                c["all_gather"] += e * b * s * d  # the mixer's normed input
            if cut(nh):
                c["all_gather"] += 2 * e * b * s * gn * cut(gn)  # B and C whole
                c["all_reduce"] += e * b * s  # the gated norm's sum of squares
            else:
                c["all_gather"] += e * whole_leaves
                if mode == "decode":  # the state's bf16 conv windows whole
                    c["all_gather"] += 2 * b * (k - 1) * (din * cut(din) + 2 * gn * cut(gn))
            c[wo] += e * b * s * d  # wo
        for _ in range(cfg.n_layers // cfg.hybrid_period if hybrid else 0):
            h, kv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
            c["all_gather"] += 2 * e * b * s * kv * hd  # K and V whole
            if seq:
                c["all_gather"] += 2 * e * b * s * d  # the attention's and the MLP's input
            if mode == "decode":
                c["all_gather"] += e * b * h * hd + e * n * b * h * (hd + 2)
            elif part == "cp":
                c["all_to_all"] += 2 * e * b * s * h * hd // n  # q to rows, out back
            c[wo] += 2 * e * b * s * d  # wo, wo_mlp
        if mode == "prefill" and seq:
            c["all_gather"] += e * b * n * d  # the last position's hidden state
        c["all_gather"] += e * b * v + (e * B * v if dd > 1 else 0)  # vocab, then rows
        out[mode] = c
    return out


@pytest.mark.parametrize("case_id", CASE_IDS)
def test_collective_bytes_equal_the_count_from_the_shapes(runs, case_id):
    shape, rules_name, part, name = _case_of(case_id)
    want = model_bytes(name, shape, rules_name, part)
    for r in _reports(runs, case_id):
        for mode in ("prefill", "decode"):
            got = r["counters"][mode]
            assert got["host_staged"] == 0  # gloo on host tensors: nothing staged
            assert {k: got[k] for k in want[mode]} == want[mode], mode


# -- the pieces ---------------------------------------------------------------------------


class _Sums:
    """A stand-in for a layout over ``n`` ranks: ``model_sum`` adds the other
    ranks' partial sums of squares to this rank's."""

    def __init__(self, parts, rank):
        self.parts, self.rank = parts, rank

    def model_sum(self, t):
        others = [p for i, p in enumerate(self.parts) if i != self.rank]
        assert torch.equal(t, self.parts[self.rank])
        return t + sum(others)


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_the_cut_gated_rmsnorm_is_each_ranks_block_of_the_whole(n, dtype):
    cfg = port_cfg("mamba2-1.3b")
    din = cfg.d_inner
    rng = np.random.default_rng(n)
    y, z = (torch.from_numpy(rng.standard_normal((3, 5, din)).astype(np.float32)).to(dtype)
            for _ in range(2))
    w = torch.from_numpy(rng.uniform(0.5, 1.5, din).astype(np.float32))
    whole = tlayers.rmsnorm(y * torch.nn.functional.silu(z), w, cfg.norm_eps)
    ys, zs, ws = y.chunk(n, -1), z.chunk(n, -1), w.chunk(n)
    parts = [torch.sum(torch.square((a * torch.nn.functional.silu(c)).float()), -1, keepdim=True)
             for a, c in zip(ys, zs)]
    blocks = [tmamba._gated_norm(cfg, {"norm_w": ws[r]}, ys[r], zs[r], _Sums(parts, r))
              for r in range(n)]
    assert all(blk.dtype == dtype for blk in blocks)
    got = torch.cat(blocks, -1).float()
    tol = 1e-6 if dtype == torch.float32 else ONE_BF16_ULP
    torch.testing.assert_close(got, whole.float(), rtol=tol, atol=tol * whole.abs().max())


def _abstract_mesh(shape):
    names = ("data", "model") if len(shape) == 2 else ("pod", "data", "model")
    return AbstractMesh(tuple(shape), names)


class _DuckMesh:
    def __init__(self, shape):
        self.axis_names = ("data", "model") if len(shape) == 2 else ("pod", "data", "model")
        self.shape = dict(zip(self.axis_names, shape))


SPEC_MESHES = ((1, 2), (1, 4), (2, 2), (4, 1), (16, 16), (2, 16, 16))


@pytest.mark.parametrize("mesh_shape", SPEC_MESHES, ids=mesh_id)
@pytest.mark.parametrize("rules_name", RULES)
def test_cache_pspecs_match_the_references_cache_specs(mesh_shape, rules_name):
    from repro_torch.configs.registry import _MODULES

    jrules, rules = getattr(jsharding, rules_name), getattr(tsharding, rules_name)
    for arch in sorted(_MODULES):
        for smoke in (True, False):
            jcfg, cfg = jget_config(arch, smoke=smoke), get_config(arch, smoke=smoke)
            for b, s in ((4, 32), (3, 30), (32, 4096)):
                _, shard = jcache_specs(jcfg, JShapeConfig("c", s, b, "decode"),
                                        _abstract_mesh(mesh_shape), jrules)
                want = {k: tuple(ns.spec) for k, ns in cache_flat(shard).items()}
                got = cache_flat(tmodel.cache_pspecs(cfg, rules, _DuckMesh(mesh_shape), b, s))
                assert got == want, (arch, smoke, b, s)


@pytest.mark.parametrize("arch", ["mamba2-1.3b", "zamba2-2.7b"])
@pytest.mark.parametrize("mesh_shape", MESHES, ids=mesh_id)
def test_lm_cache_from_numpy_cuts_an_ssm_state_by_cache_pspecs(arch, mesh_shape):
    """Stacked (mamba2) and inside the hybrid's ``{"ssm", "attn"}``: each
    rank's leaves are its blocks of the whole under ``cache_pspecs``, and
    the blocks of all the ranks tile the whole."""
    cfg = port_cfg(arch)
    rng = np.random.default_rng(5)
    rules = tsharding.RULES_SERVE
    shapes = cache_flat(tmodel.cache_pspecs(cfg, rules, _duck_mesh(mesh_shape), B, BUDGET))
    lead = ((cfg.n_layers // cfg.hybrid_period, cfg.hybrid_period) if cfg.family == "hybrid"
            else (cfg.n_layers,))
    gn, km1 = cfg.ssm_ngroups * cfg.ssm_state, cfg.ssm_conv - 1
    dims = {"conv_x": (B, km1, cfg.d_inner), "conv_b": (B, km1, gn), "conv_c": (B, km1, gn),
            "h": (B, cfg.ssm_nheads, cfg.ssm_headdim, cfg.ssm_state)}
    whole = {}
    for key in shapes:
        leaf = key.split("/")[-1]
        if key.startswith("attn/"):
            shp = lead[:1] + (B, BUDGET, cfg.n_kv_heads, cfg.resolved_head_dim)
        else:
            shp = lead + dims[leaf]
        whole[key] = rng.standard_normal(shp).astype(np.float32)
        if leaf != "h":  # bf16 bit patterns, as the reference stores them
            whole[key] = (torch.from_numpy(whole[key]).to(torch.bfloat16).view(torch.int16)
                          .numpy().view(np.uint16))
    seen = {key: np.zeros(whole[key].shape, bool) for key in whole}
    for rank in range(math.prod(mesh_shape)):
        mesh = _duck_mesh(mesh_shape, rank)
        specs = tmodel.cache_pspecs(cfg, rules, mesh, B, BUDGET)
        got = lm_cache_from_numpy(cache_tree(whole), "cpu", sharding=(mesh, specs))
        state = got["ssm"] if cfg.family == "hybrid" else got
        assert isinstance(state, SsmState)
        flat_specs = cache_flat(specs)
        for key, t in cache_flat(got).items():
            full = (torch.from_numpy(whole[key]) if key.endswith("h")
                    else torch.from_numpy(whole[key].view(np.int16).copy()).view(torch.bfloat16))
            want = mesh.local_block(full, flat_specs[key])
            assert torch.equal(t, want), (key, rank)
            index = np.arange(whole[key].size).reshape(whole[key].shape)
            seen[key][np.unravel_index(mesh.local_block(torch.from_numpy(index), flat_specs[key])
                                       .numpy().ravel(), whole[key].shape)] = True
        n = mesh_shape[1]
        assert state.h.shape[-3] == cfg.ssm_nheads // n
        assert state.conv_x.shape[-1] == cfg.d_inner // n
    assert all(s.all() for s in seen.values())


@pytest.mark.parametrize("arch", ["mamba2-1.3b", "zamba2-2.7b"])
@pytest.mark.parametrize("rules_name", RULES)
def test_a_rules_table_whose_model_names_disagree_is_refused(arch, rules_name):
    """Every serving entry point refuses a table that puts the model-parallel
    names on different axes; the families are served on a model axis above
    1 under the tables as they are."""
    cfg = port_cfg(arch)
    rules = getattr(tsharding, rules_name)
    bad = rules.replace(heads="data")
    for shape in ((2, 2), (2, 4), (4, 2)):  # both axes live: "heads" leaves the model axis
        mesh = _duck_mesh(shape)
        for build in (lambda: tmodel.make_prefill_step(cfg, mesh, bad),
                      lambda: tmodel.make_serve_step(cfg, mesh, bad),
                      lambda: tmodel.run_stack(cfg, {}, torch.zeros((B, P), dtype=torch.long),
                                               mesh=mesh, rules=bad),
                      lambda: Engine(cfg, {"embed": {"table": torch.zeros(1)}}, device="cpu",
                                     mesh=mesh, rules=bad)):
            with pytest.raises(ValueError, match="one set of axes"):
                build()
    for shape in MESHES:  # the table as it is: served
        tmodel.make_prefill_step(cfg, _duck_mesh(shape), rules)
        tmodel.make_serve_step(cfg, _duck_mesh(shape), rules)
