"""LM serving across the ranks of a mesh with a model axis above 1, on the
CPU, against the JAX package: sequence-, tensor- and vocab-parallel dense
layers, context- and head-parallel attention, the kvseq-cut decode cache,
the expert-parallel MoE block over ``RankMesh.all_to_all`` and
``Engine(mesh=..., rules=...)``.

The port's ranks are CPU processes over gloo, spawned as
``tests/test_torch_train_ranks.py`` spawns them (``torch.multiprocessing``,
a ``FileStore``, a 120 s group timeout) from a subprocess that keeps JAX out
of them; each rank gets the whole batch and its blocks of the reference's
parameters (``convert.lm_params_from_numpy(..., sharding=)``). Meshes
(1, 2), (1, 4) and (2, 2); both rules tables; ``attn_partitioning`` "cp"
and "hp"; f32 SMOKE configs: qwen2-7b (dense, qkv bias, 2 kv heads of 28:
on model = 4 each ``wk`` block holds half a head), granite-moe-1b-a400m
(moe) with ``capacity_factor=8.0`` (no pair dropped on any mesh) and at its
registered 1.25, and musicgen-large (audio, prefill from ``embeds``).

What each case is held to, as a fraction of max|reference|:
  * the last-token prefill logits, within 1e-5 of the reference's;
  * the prefill cache gathered from the ranks, within one bf16 ulp of the
    reference's entry by entry (``test_torch_families.py``'s rule: the
    cache is bf16, whose resolution is 2^-8 of an entry, so f32 sums taken
    in another order can round an entry to its neighbour);
  * four teacher-forced decode steps from the reference's padded cache, cut
    to each rank's rows and budget positions
    (``convert.lm_cache_from_numpy(..., sharding=)``), within 2e-5: each
    step writes its token's K/V in bf16, and an entry whose f32 value was
    summed in another order can round one bf16 ulp from the reference's
    (granite's step 3 moved its logits 1.04e-5 on every mesh; the other
    steps and models stay below 1.1e-6);
  * ``Engine.generate``'s greedy tokens equal to the port's world of one
    (with a budget that divides over the model axes and one that does not);
  * every rank the same bits.
The dense, audio and cf 8.0 MoE cases are held to the reference's
one-device run (their function does not depend on the mesh). At the
registered 1.25 the MoE block's capacity comes from each rank's own tokens,
so which pairs drop depends on the mesh: those cases are held to the
reference's run on the same mesh, in a subprocess with 4 forced host devices.

Also: ``RankMesh.all_to_all`` against the tiled definition and against
``jax.lax.all_to_all(tiled=True)`` run on the forced devices; a mesh of one
gives the unsharded bits; at T > 0 every rank draws the same tokens; the
hybrid family serves on a (2, 1) mesh, whose model axes are 1 (the ssm and
hybrid families on a model axis above 1: ``test_torch_serve_ranks_ssm.py``);
each collective's counted bytes equal a count derived here from the shapes.
"""
import contextlib
import dataclasses
import datetime
import hashlib
import json
import math
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.convert import lm_cache_from_numpy, lm_params_from_numpy
from repro_torch.launch import mesh as tmesh
from repro_torch.models import model as tmodel
from repro_torch.models import sharding as tsharding
from repro_torch.models.moe import _capacity
from repro_torch.serve.engine import Engine, ServeConfig

# the port's subprocess and its spawned ranks import this module for its
# rank functions alone, and skip the JAX package
PORT_ONLY = os.environ.get("SERVE_RANKS_PORT_ONLY") == "1"
if not PORT_ONLY:
    import jax
    import jax.numpy as jnp

    from repro.configs import get_config as jget_config
    from repro.models import model as jmodel
    from repro.serve.engine import Engine as JEngine
    from repro.serve.engine import ServeConfig as JServeConfig

ROOT = Path(__file__).resolve().parents[1]
GROUP_TIMEOUT_S = 120
B, P, STEPS, NEW = 4, 24, 4, 5  # batch, prompt, decode steps, generated tokens
BUDGET = 32  # divides over 1, 2 and 4 ranks
ODD_BUDGET = P + NEW + 1  # 30: rounded up to a multiple of the model axes' ranks
# a batch and a prompt that divide over no mesh axis: every rank holds every
# row and every position (the reference's divisibility fallback)
ODD_B, ODD_P = 3, 21
LOGIT_TOL, DECODE_TOL, ONE_BF16_ULP = 1e-5, 2e-5, 2.0 ** -7
MESHES = ((1, 2), (1, 4), (2, 2))
RULES = ("DEFAULT_RULES", "RULES_SERVE")
PARTS = ("cp", "hp")
# model name -> (config, capacity factor or None, prefill input)
MODELS = {"qwen2-7b": ("qwen2-7b", None, "tokens"),
          "granite-cf8": ("granite-moe-1b-a400m", 8.0, "tokens"),
          "granite-cf1.25": ("granite-moe-1b-a400m", None, "tokens"),
          "musicgen-large": ("musicgen-large", None, "embeds")}
MESH_DEPENDENT = ("granite-cf1.25",)  # held to the reference on the same mesh
HYBRID = "zamba2-2.7b"  # served on a (2, 1) mesh: the model axes are 1


def mesh_id(shape) -> str:
    return "x".join(map(str, shape))


CASES = [(m, r, p, name) for m in MESHES for r in RULES for p in PARTS for name in MODELS]
CASE_IDS = [f"{mesh_id(m)}-{r}-{p}-{name}" for m, r, p, name in CASES]
ODD_MODELS = ("qwen2-7b", "granite-cf8")
ODD_CASES = [c for c in CASES if c[3] in ODD_MODELS]
ODD_IDS = [CASE_IDS[CASES.index(c)] for c in ODD_CASES]


def port_cfg(name: str, part: str = "cp"):
    arch, cf, _ = MODELS[name] if name in MODELS else (name, None, "tokens")
    extra = {"capacity_factor": cf} if cf else {}
    return dataclasses.replace(get_config(arch, smoke=True), dtype="float32",
                               attn_partitioning=part, **extra)


def flat_names(tree, prefix=""):
    if isinstance(tree, dict):
        return [n for k in sorted(tree) for n in flat_names(tree[k], f"{prefix}{k}/")]
    return [prefix.rstrip("/")]


def unflatten(flat: dict, prefix: str, like):
    if isinstance(like, dict):
        return {k: unflatten(flat, f"{prefix}{k}/", v) for k, v in like.items()}
    return flat[prefix.rstrip("/")]


def digest(*arrays) -> str:
    h = hashlib.sha256()
    for a in arrays:
        h.update(np.ascontiguousarray(a).tobytes())
    return h.hexdigest()


def _load(path) -> dict:
    with np.load(path) as f:
        return dict(f)


# -- the port's ranks ----------------------------------------------------------------


def _init(rank: int, world: int, store: str) -> None:
    import torch.distributed as dist

    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(store, world), rank=rank,
                            world_size=world,
                            timeout=datetime.timedelta(seconds=GROUP_TIMEOUT_S))


def _params(mesh, cfg, rules, tmp: str):
    arch = cfg.name
    numpy_params = unflatten(_load(Path(tmp, f"params-{arch}.npz")), "",
                             tmodel.param_defs(cfg))
    specs = tmodel.param_pspecs(cfg, rules, mesh)
    return lm_params_from_numpy(numpy_params, cfg, "cpu", sharding=(mesh, specs))


def _cache_spec(mesh, rules, b: int, s: int):
    """The decode cache's spec (layers, rows, budget positions, kv, hd)."""
    lay = tsharding.ServeLayout.build(mesh, rules, b, s)
    return (None, lay.batch or None, lay.model or None, None, None)


@contextlib.contextmanager
def kernel6_operands_checked():
    """Each call of ``ops.flash_attention`` inside, recorded as (S, T) with
    whether the card's kernel takes its operands as they are
    (``flash_attention.launch_plan``: the strides, T >= S); the CPU runs
    the plain version, which takes any strides."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops

    real, calls = ops.flash_attention, []

    def check(q, k, v, **kw):
        try:
            fa.launch_plan(torch.bfloat16, (q.shape, k.shape, v.shape),
                           (q.stride(), k.stride(), v.stride()))
            ok = True
        except ValueError:
            ok = False
        calls.append([int(q.shape[2]), int(k.shape[2]), ok])
        return real(q, k, v, **kw)

    ops.flash_attention = check
    try:
        yield calls
    finally:
        ops.flash_attention = real


def _case(mesh, case, tmp: str) -> dict:
    """One case on this rank: prefill, the gathered cache, decode steps
    from the reference's cache, generate; the counters of a prefill and of
    one decode step."""
    shape, rules_name, part, name = case
    rules = getattr(tsharding, rules_name)
    cfg = port_cfg(name, part)
    params = _params(mesh, cfg, rules, tmp)
    data = _load(Path(tmp, f"data-{name}.npz"))
    tokens = torch.from_numpy(data["tokens"]).long()
    eng = Engine(cfg, params, ServeConfig(max_seq_len=BUDGET, batch_size=B), device="cpu",
                 mesh=mesh, rules=rules)
    batch = ({"embeds": torch.from_numpy(data["embeds"])} if MODELS[name][2] == "embeds"
             else {"tokens": tokens[:, :P]})
    mesh.reset_counters()
    with kernel6_operands_checked() as calls:
        logits, cache = eng.prefill(params, batch)
    counters = {"prefill": dict(mesh.counters)}
    lay = tsharding.ServeLayout.build(mesh, rules, B, P)
    whole = {}
    for n in ("k", "v"):
        t = cache[n]
        if lay.seq:
            t = mesh.all_gather(t, 2, lay.model)
        whole[n] = lay.whole_rows(t.transpose(0, 1)).transpose(0, 1)
    ref = f"ref-{mesh_id(shape)}-{name}" if name in MESH_DEPENDENT else f"ref-1-{name}"
    padded = _load(Path(tmp, f"{ref}.npz"))
    spec = _cache_spec(mesh, rules, B, 1)
    dcache = lm_cache_from_numpy({"k": padded["pad_k"], "v": padded["pad_v"]}, "cpu",
                                 sharding=(mesh, {"k": spec, "v": spec}))
    steps = []
    for i in range(STEPS):
        mesh.reset_counters()
        step_logits, dcache = eng.decode(params, dcache, {"token": tokens[:, P + i:P + i + 1],
                                                          "pos": P + i})
        if i == 0:
            counters["decode"] = dict(mesh.counters)
        steps.append(step_logits.numpy())
    gen = eng.generate(data["tokens"][:, :P], NEW)
    odd = Engine(cfg, params, ServeConfig(max_seq_len=ODD_BUDGET, batch_size=B), device="cpu",
                 mesh=mesh, rules=rules).generate(data["tokens"][:, :P], NEW)
    out = {"prefill": logits.numpy(), "k": whole["k"].float().numpy(),
           "v": whole["v"].float().numpy(), "decode": np.stack(steps), "gen": gen, "odd": odd}
    return {"arrays": out, "counters": counters, "kernel6": calls,
            "digest": digest(*(out[k] for k in sorted(out))),
            "layout": {"rows": list(lay.rows(B)), "positions": list(lay.positions()),
                       "n": lay.n, "seq": lay.seq}}


def _odd_case(mesh, case, tmp: str) -> dict:
    """A batch of ``ODD_B`` prompts of ``ODD_P`` tokens, which divide over
    no axis: the prefill's logits and ``generate``'s tokens."""
    shape, rules_name, part, name = case
    rules = getattr(tsharding, rules_name)
    cfg = port_cfg(name, part)
    params = _params(mesh, cfg, rules, tmp)
    prompts = _load(Path(tmp, f"data-{name}.npz"))["tokens"][:ODD_B, :ODD_P]
    eng = Engine(cfg, params, ServeConfig(max_seq_len=ODD_BUDGET, batch_size=ODD_B),
                 device="cpu", mesh=mesh, rules=rules)
    logits, _ = eng.prefill(params, {"tokens": torch.from_numpy(prompts).long()})
    return {"prefill": logits.numpy(), "gen": eng.generate(prompts, NEW)}


def _all_to_all_case(mesh) -> dict:
    """Each rank's input, and its output of every (axes, split, concat)."""
    x = torch.arange(4 * 8 * 3, dtype=torch.float32).reshape(4, 8, 3) + 1000 * mesh.rank
    out = {"x": x.numpy()}
    for axes in ("model", "data", ("data", "model")):
        for split, concat in ((0, 1), (1, 0), (1, 2), (0, 0)):
            key = f"{'+'.join(tsharding.axes_tuple(axes))}-{split}-{concat}"
            out[key] = mesh.all_to_all(x, split, concat, axes).numpy()
    return out


def _sampled(mesh, tmp: str) -> dict:
    """Tokens drawn at T = 1 on this rank: with a generator seeded 3, and
    with none (rank 0's fresh seed)."""
    cfg = port_cfg("qwen2-7b")
    rules = tsharding.RULES_SERVE
    params = _params(mesh, cfg, rules, tmp)
    prompts = _load(Path(tmp, "data-qwen2-7b.npz"))["tokens"][:, :P]
    scfg = ServeConfig(max_seq_len=BUDGET, batch_size=B, temperature=1.0)
    seeded = Engine(cfg, params, scfg, "cpu", torch.Generator().manual_seed(3), mesh=mesh,
                    rules=rules).generate(prompts, NEW)
    fresh = Engine(cfg, params, scfg, "cpu", mesh=mesh, rules=rules).generate(prompts, NEW)
    return {"seeded": seeded, "fresh": fresh}


def _hybrid(mesh, tmp: str) -> dict:
    """The hybrid SMOKE on a (2, 1) mesh (the model axes are 1): prefill
    logits, decode steps from its own cache, generate."""
    cfg = port_cfg(HYBRID)
    rules = tsharding.DEFAULT_RULES
    params = _params(mesh, cfg, rules, tmp)
    tokens = _load(Path(tmp, f"data-{HYBRID}.npz"))["tokens"]
    eng = Engine(cfg, params, ServeConfig(max_seq_len=BUDGET, batch_size=B), device="cpu",
                 mesh=mesh, rules=rules)
    logits, cache = eng.prefill(params, {"tokens": torch.from_numpy(tokens[:, :P]).long()})
    return {"prefill": logits.numpy(), "gen": eng.generate(tokens[:, :P], NEW)}


def _rank(rank: int, world: int, store: str, tmp: str) -> None:
    _init(rank, world, store)
    meshes = [m for m in MESHES if math.prod(m) == world]
    out = {"rank": rank, "cases": {}}
    arrays = {}
    for shape in meshes:
        mesh = tmesh.make_mesh(shape, ("data", "model"), device="cpu")
        for case, cid in zip(CASES, CASE_IDS):
            if case[0] != shape:
                continue
            res = _case(mesh, case, tmp)
            out["cases"][cid] = {k: res[k] for k in ("counters", "digest", "layout", "kernel6")}
            arrays.update({f"{cid}/{k}": v for k, v in res["arrays"].items()})
            if case in ODD_CASES:
                arrays.update({f"{cid}/odd-{k}": v for k, v in _odd_case(mesh, case, tmp).items()})
        if shape == (2, 2):
            arrays.update({f"a2a/{k}": v for k, v in _all_to_all_case(mesh).items()})
        if shape == (1, 2):
            arrays.update({f"sampled/{k}": v for k, v in _sampled(mesh, tmp).items()})
    if world == 2:
        mesh = tmesh.make_mesh((2, 1), ("data", "model"), device="cpu")
        arrays.update({f"hybrid/{k}": v for k, v in _hybrid(mesh, tmp).items()})
    np.savez(Path(tmp, f"port-{world}-r{rank}.npz"), **arrays)
    Path(tmp, f"port-{world}-r{rank}.json").write_text(json.dumps(out))


def main(tmp: str) -> None:
    """The port's side, in a subprocess: the ranks of worlds 2 and 4."""
    import torch.multiprocessing as mp

    for world in (2, 4):
        mp.start_processes(_rank, args=(world, os.path.join(tmp, f"store-{world}"), tmp),
                           nprocs=world, start_method="spawn")
    print(json.dumps({"done": True}))


# -- the reference ------------------------------------------------------------------


def ref_cfg(name: str):
    arch, cf, _ = MODELS[name] if name in MODELS else (name, None, "tokens")
    extra = {"capacity_factor": cf} if cf else {}
    return dataclasses.replace(jget_config(arch, smoke=True), dtype="float32", **extra)


def reference_run(tmp: str, name: str, mesh) -> dict:
    """The reference's Engine of ``name`` on ``mesh``: prefill logits and
    cache, the cache padded to the budget, four teacher-forced decode
    steps, generate."""
    from repro.models.sharding import DEFAULT_RULES

    jcfg = ref_cfg(name)
    arch = jcfg.name
    flat = _load(Path(tmp, f"params-{arch}.npz"))
    pshard = jmodel.param_shardings(jcfg, DEFAULT_RULES, mesh)
    params = jax.tree_util.tree_map(lambda a, s: jax.device_put(jnp.asarray(a), s),
                                    unflatten(flat, "", jmodel.param_defs(jcfg)), pshard)
    data = _load(Path(tmp, f"data-{name}.npz"))
    eng = JEngine(jcfg, mesh, params, JServeConfig(max_seq_len=BUDGET, batch_size=B))
    batch = ({"embeds": jnp.asarray(data["embeds"])} if MODELS[name][2] == "embeds"
             else {"tokens": jnp.asarray(data["tokens"][:, :P])})
    logits, cache = eng.prefill(params, batch)
    out = {"prefill": np.asarray(logits, np.float32),
           "k": np.asarray(cache["k"]), "v": np.asarray(cache["v"])}
    cache = eng._pad_cache(cache, P)
    out["pad_k"], out["pad_v"] = np.asarray(cache["k"]), np.asarray(cache["v"])
    steps = []
    for i in range(STEPS):
        logits, cache = eng.decode(params, cache, {
            "token": jnp.asarray(data["tokens"][:, P + i:P + i + 1]), "pos": jnp.int32(P + i)})
        steps.append(np.asarray(logits, np.float32))
    out["decode"] = np.stack(steps)
    out["gen"] = eng.generate(data["tokens"][:, :P], NEW)
    return out


def reference_meshes(tmp: str) -> None:
    """The reference on the (1, 2), (1, 4) and (2, 2) meshes of 4 forced
    host devices: the registered-capacity MoE, and ``jax.lax.all_to_all``
    on the port's all-to-all inputs."""
    from jax.sharding import Mesh, PartitionSpec as Pspec

    from repro.utils.compat import shard_map

    devices = jax.devices()
    for shape in MESHES:
        mesh = Mesh(np.array(devices[:math.prod(shape)]).reshape(shape), ("data", "model"))
        for name in MESH_DEPENDENT:
            np.savez(Path(tmp, f"ref-{mesh_id(shape)}-{name}.npz"),
                     **reference_run(tmp, name, mesh))
    mesh = Mesh(np.array(devices[:4]).reshape(2, 2), ("data", "model"))
    xs = np.stack([np.arange(4 * 8 * 3, dtype=np.float32).reshape(4, 8, 3) + 1000 * r
                   for r in range(4)]).reshape(2, 2, 4, 8, 3)
    out = {}
    for axes in ("model", "data", ("data", "model")):
        for split, concat in ((0, 1), (1, 0), (1, 2), (0, 0)):
            def local(x, axes=axes, split=split, concat=concat):
                return jax.lax.all_to_all(x[0, 0], axes, split, concat, tiled=True)[None, None]

            fn = shard_map(local, mesh=mesh, in_specs=Pspec("data", "model"),
                           out_specs=Pspec("data", "model"), check_vma=False)
            y = np.asarray(fn(jnp.asarray(xs)))
            key = f"{'+'.join((axes,) if isinstance(axes, str) else axes)}-{split}-{concat}"
            for r in range(4):
                out[f"{key}/r{r}"] = y[r // 2, r % 2]
    np.savez(Path(tmp, "ref-a2a.npz"), **out)
    print(json.dumps({"n_devices": len(devices)}))


def _start(code: str, env_extra: dict) -> subprocess.Popen:
    env = dict(os.environ, **env_extra)
    env["PYTHONPATH"] = os.pathsep.join([str(ROOT / "src"), str(ROOT / "tests")])
    return subprocess.Popen([sys.executable, "-c", code], env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)


def _finish(proc: subprocess.Popen, timeout: float = 400) -> dict:
    try:
        out, err = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        proc.kill()
        out, err = proc.communicate()
        raise AssertionError(f"timed out after {timeout} s: {err[-3000:]}")
    assert proc.returncode == 0, err[-4000:]
    return json.loads(out.strip().splitlines()[-1])


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both sides' runs from the reference's initial parameters, written
    here as numpy: the reference on its meshes in a subprocess beside its
    one-device runs here, then the port's ranks in a subprocess beside the
    port's world of one here."""
    from repro.utils.compat import make_mesh

    tmp = tmp_path_factory.mktemp("serve-ranks")
    rng = np.random.default_rng(7)
    for name in list(MODELS) + [HYBRID]:
        jcfg = ref_cfg(name)
        if not (tmp / f"params-{jcfg.name}.npz").exists():
            jparams = jmodel.init_params(jcfg, jax.random.PRNGKey(0))
            np.savez(tmp / f"params-{jcfg.name}.npz",
                     **{n: np.asarray(a) for n, a in zip(flat_names(jparams),
                                                         jax.tree_util.tree_leaves(jparams))})
        data = {"tokens": rng.integers(0, jcfg.vocab_size, (B, P + STEPS)).astype(np.int32)}
        if name in MODELS and MODELS[name][2] == "embeds":
            data["embeds"] = rng.standard_normal((B, P, jcfg.d_model)).astype(np.float32)
        np.savez(tmp / f"data-{name}.npz", **data)
    ref = _start(f"import test_torch_serve_ranks as t; t.reference_meshes({str(tmp)!r})",
                 {"XLA_FLAGS": "--xla_force_host_platform_device_count=4",
                  "JAX_PLATFORMS": "cpu"})
    one = make_mesh((1, 1), ("data", "model"))
    for name in [n for n in MODELS if n not in MESH_DEPENDENT]:
        np.savez(tmp / f"ref-1-{name}.npz", **reference_run(str(tmp), name, one))
    ref_out = _finish(ref)
    port = _start(f"import test_torch_serve_ranks as t; t.main({str(tmp)!r})",
                  {"SERVE_RANKS_PORT_ONLY": "1"})
    # meanwhile the port's world of one and the hybrid's one-device reference
    world1 = {}
    for name in MODELS:
        cfg = port_cfg(name)
        flat = _load(tmp / f"params-{cfg.name}.npz")
        params = lm_params_from_numpy(unflatten(flat, "", tmodel.param_defs(cfg)), cfg)
        tokens = _load(tmp / f"data-{name}.npz")["tokens"]
        world1[name] = Engine(cfg, params, ServeConfig(max_seq_len=BUDGET, batch_size=B),
                              device="cpu").generate(tokens[:, :P], NEW)
        if name in ODD_MODELS:
            odd = Engine(cfg, params, ServeConfig(max_seq_len=ODD_BUDGET, batch_size=ODD_B),
                         device="cpu")
            prompts = tokens[:ODD_B, :ODD_P]
            world1[f"{name}/odd-prefill"] = odd.prefill(
                params, {"tokens": torch.from_numpy(prompts).long()})[0].numpy()
            world1[f"{name}/odd-gen"] = odd.generate(prompts, NEW)
    hyb = reference_run_hybrid(str(tmp), one)
    _finish(port)
    port_arrays = {w: [_load(tmp / f"port-{w}-r{r}.npz") for r in range(w)] for w in (2, 4)}
    port_json = {w: [json.loads((tmp / f"port-{w}-r{r}.json").read_text()) for r in range(w)]
                 for w in (2, 4)}
    return {"tmp": tmp, "ref": ref_out, "world1": world1, "hybrid_ref": hyb,
            "arrays": port_arrays, "json": port_json}


def reference_run_hybrid(tmp: str, mesh) -> dict:
    from repro.models.sharding import DEFAULT_RULES

    jcfg = ref_cfg(HYBRID)
    params = unflatten(_load(Path(tmp, f"params-{jcfg.name}.npz")), "",
                       jmodel.param_defs(jcfg))
    params = jax.tree_util.tree_map(jnp.asarray, params)
    tokens = _load(Path(tmp, f"data-{HYBRID}.npz"))["tokens"]
    eng = JEngine(jcfg, mesh, params, JServeConfig(max_seq_len=BUDGET, batch_size=B),
                  DEFAULT_RULES)
    logits, _ = eng.prefill(params, {"tokens": jnp.asarray(tokens[:, :P])})
    return {"prefill": np.asarray(logits, np.float32), "gen": eng.generate(tokens[:, :P], NEW)}


def _world(shape) -> int:
    return math.prod(shape)


def _port(runs, case_id: str, key: str, rank: int = 0) -> np.ndarray:
    shape = CASES[CASE_IDS.index(case_id)][0]
    return runs["arrays"][_world(shape)][rank][f"{case_id}/{key}"]


def _reference(runs, case) -> dict:
    shape, _, _, name = case
    ref = f"ref-{mesh_id(shape)}-{name}" if name in MESH_DEPENDENT else f"ref-1-{name}"
    return _load(runs["tmp"] / f"{ref}.npz")


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.abs(got - want).max() / np.abs(want).max())


def _bf16(bits: np.ndarray) -> np.ndarray:
    return torch.from_numpy(bits.copy()).view(torch.bfloat16).float().numpy()


# -- the cases ------------------------------------------------------------------------


def test_the_reference_ran_on_four_forced_devices(runs):
    assert runs["ref"]["n_devices"] == 4


@pytest.mark.parametrize("case_id", CASE_IDS)
def test_prefill_logits_match_the_reference(runs, case_id):
    want = _reference(runs, CASES[CASE_IDS.index(case_id)])["prefill"]
    assert _rel(_port(runs, case_id, "prefill"), want) <= LOGIT_TOL


@pytest.mark.parametrize("case_id", CASE_IDS)
def test_gathered_prefill_cache_matches_the_reference(runs, case_id):
    want = _reference(runs, CASES[CASE_IDS.index(case_id)])
    for n in ("k", "v"):
        ref = _bf16(want[n])
        got = _port(runs, case_id, n)
        assert got.shape == ref.shape
        np.testing.assert_allclose(got, ref, rtol=ONE_BF16_ULP, atol=1e-6 * np.abs(ref).max())


@pytest.mark.parametrize("case_id", CASE_IDS)
def test_decode_steps_from_the_reference_cache_match_the_reference(runs, case_id):
    want = _reference(runs, CASES[CASE_IDS.index(case_id)])["decode"]
    got = _port(runs, case_id, "decode")
    for i in range(STEPS):
        assert _rel(got[i], want[i]) <= DECODE_TOL, i


@pytest.mark.parametrize("case_id", CASE_IDS)
def test_generate_gives_the_world_of_ones_greedy_tokens(runs, case_id):
    case = CASES[CASE_IDS.index(case_id)]
    name = case[3]
    want = _reference(runs, case)["gen"] if name in MESH_DEPENDENT else runs["world1"][name]
    assert np.array_equal(_port(runs, case_id, "gen"), want)
    if name not in MESH_DEPENDENT:  # a budget that does not divide over the model axes
        assert np.array_equal(_port(runs, case_id, "odd"), want)


@pytest.mark.parametrize("case_id", CASE_IDS)
def test_every_rank_has_the_same_bits(runs, case_id):
    shape = CASES[CASE_IDS.index(case_id)][0]
    ranks = runs["json"][_world(shape)]
    assert len({r["cases"][case_id]["digest"] for r in ranks}) == 1
    lays = [r["cases"][case_id]["layout"] for r in ranks]
    n = shape[1]
    assert {lay["n"] for lay in lays} == {n} and all(lay["seq"] for lay in lays)
    assert sorted(tuple(lay["positions"]) for lay in lays) == sorted(
        (i * P // n, (i + 1) * P // n) for i in range(n) for _ in range(shape[0]))


@pytest.mark.parametrize("case_id", CASE_IDS)
def test_every_kernel6_call_is_one_the_card_takes(runs, case_id):
    """One call a layer a prefill on every rank, each a query block against
    the keys up to its end ("cp": S = P / n, T the block's end) or every
    position ("hp": S = T = P), with operands the kernel takes as they are."""
    shape, _, part, name = CASES[CASE_IDS.index(case_id)]
    n = shape[1]
    cfg = port_cfg(name, part)
    for r in runs["json"][_world(shape)]:
        calls = r["cases"][case_id]["kernel6"]
        p0, p1 = r["cases"][case_id]["layout"]["positions"]
        want = [p1 - p0, p1] if part == "cp" else [P, P]
        assert calls == [want + [True]] * cfg.n_layers, (calls, p0, p1, n)


@pytest.mark.parametrize("case_id", ODD_IDS)
def test_a_batch_and_prompt_that_divide_over_no_axis_match_the_world_of_one(runs, case_id):
    """Rows and positions replicated: the logits within 1e-5 of the port's
    world of one (held to the reference by ``test_torch_families.py``),
    the same greedy tokens."""
    name = CASES[CASE_IDS.index(case_id)][3]
    assert _rel(_port(runs, case_id, "odd-prefill"), runs["world1"][f"{name}/odd-prefill"]) \
        <= LOGIT_TOL
    assert np.array_equal(_port(runs, case_id, "odd-gen"), runs["world1"][f"{name}/odd-gen"])


# -- the collectives' bytes -------------------------------------------------------------


def model_bytes(name: str, shape, rules_name: str, part: str) -> dict:
    """Each collective's payload a rank moves in one prefill and in one
    decode step, counted from the shapes (f32: 4 bytes an element) as
    ``RankMesh.counters`` counts them: the whole tensor an all-gather
    returns, a reduce-scatter takes, an all-reduce reduces, an all-to-all
    sends."""
    cfg = port_cfg(name, part)
    dd, n = shape
    e = 4
    d, h, kv, hd, ff = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim, cfg.d_ff
    v = cfg.padded_vocab
    b = B // dd
    moe = cfg.family == "moe"
    fsdp = rules_name == "DEFAULT_RULES" and dd > 1
    # the data-axes gathers: lm_head's rows once a call, each layer's fsdp leaves
    layer = (2 * d * (h * hd) // n + 2 * d * (kv * hd) // n + (0 if moe else 3 * d * ff // n))
    weights = e * (d * v // n + cfg.n_layers * layer) if fsdp else 0
    if moe and dd > 1:  # the expert stacks' expert_fsdp dims, gathered under both tables
        weights += e * cfg.n_layers * 3 * (cfg.n_experts_eff // n) * d * (
            cfg.d_ff // cfg.expert_shards)
    out = {}
    for mode, s in (("prefill", P), ("decode", 1)):
        c = {"all_gather": weights, "reduce_scatter": 0, "all_reduce": 0, "all_to_all": 0}
        seq = s % n == 0
        if seq:
            c["all_to_all"] += e * b * s * d // n  # the embedding
        else:
            c["all_gather"] += e * b * s * d
        for _ in range(cfg.n_layers):
            c["all_gather"] += 2 * e * b * s * kv * hd  # K and V whole
            if seq:
                c["all_gather"] += e * b * s * d  # the attention's normed input
            if mode == "decode":
                c["all_gather"] += e * b * h * hd  # q whole
                c["all_gather"] += e * n * b * h * (hd + 2)  # the partial softmaxes
            elif part == "cp":
                c["all_to_all"] += 2 * e * b * s * h * hd // n  # q to rows, out back
            c["reduce_scatter" if seq else "all_reduce"] += e * b * s * d  # wo
            if moe:
                t = b * (s // n if seq else s)
                cap = _capacity(t, cfg)
                if dd > 1 or seq:
                    c["all_reduce"] += e  # the aux loss's mean over the ranks' tokens
                c["all_to_all"] += 2 * e * cfg.n_experts_eff * cap * d
            else:
                if seq:
                    c["all_gather"] += e * b * s * d  # the MLP's normed input
                c["reduce_scatter" if seq else "all_reduce"] += e * b * s * d  # wo_mlp
        if mode == "prefill" and seq:
            c["all_gather"] += e * b * n * d  # the last position's hidden state
        c["all_gather"] += e * b * v + (e * B * v if dd > 1 else 0)  # vocab, then rows
        out[mode] = c
    return out


BYTES_CASES = [c for c in CASE_IDS if c.endswith(("qwen2-7b", "granite-cf1.25"))]


@pytest.mark.parametrize("case_id", BYTES_CASES)
def test_collective_bytes_equal_the_count_from_the_shapes(runs, case_id):
    shape, rules_name, part, name = CASES[CASE_IDS.index(case_id)]
    want = model_bytes(name, shape, rules_name, part)
    for r in runs["json"][_world(shape)]:
        got = r["cases"][case_id]["counters"]
        for mode in ("prefill", "decode"):
            assert got[mode]["host_staged"] == 0  # gloo on host tensors: nothing staged
            assert {k: got[mode][k] for k in want[mode]} == want[mode], mode


# -- the rest ---------------------------------------------------------------------------


def test_all_to_all_matches_the_tiled_definition_and_jax(runs):
    """Block i along split goes to block_index i over the axes; the
    blocks received are concatenated along concat in the senders' order."""
    ranks = runs["arrays"][4]
    ref = _load(runs["tmp"] / "ref-a2a.npz")
    xs = [r["a2a/x"] for r in ranks]
    coords = [(r // 2, r % 2) for r in range(4)]  # (data, model) of rank r on (2, 2)
    for axes in (("model",), ("data",), ("data", "model")):
        for split, concat in ((0, 1), (1, 0), (1, 2), (0, 0)):
            key = f"{'+'.join(axes)}-{split}-{concat}"
            for r in range(4):
                peers = [q for q in range(4) if all(coords[q][i] == coords[r][i]
                                                    for i, a in enumerate(("data", "model"))
                                                    if a not in axes)]
                idx = {q: (coords[q][0] * 2 + coords[q][1] if len(axes) == 2
                           else coords[q][("data", "model").index(axes[0])]) for q in peers}
                order = sorted(peers, key=idx.get)
                mine = idx[r]
                want = np.concatenate([np.split(xs[q], len(order), axis=split)[mine]
                                       for q in order], axis=concat)
                assert np.array_equal(ranks[r][f"a2a/{key}"], want), (key, r)
                assert np.array_equal(ref[f"{key}/r{r}"], want), (key, r)


def test_sampling_at_a_temperature_gives_every_rank_the_same_tokens(runs):
    ranks = runs["arrays"][2]
    for key in ("seeded", "fresh"):
        a, b = ranks[0][f"sampled/{key}"], ranks[1][f"sampled/{key}"]
        assert a.shape == (B, P + NEW) and np.array_equal(a, b), key
    assert not np.array_equal(ranks[0]["sampled/seeded"][:, P:], runs["world1"]["qwen2-7b"][:, P:])


def test_hybrid_serves_on_a_mesh_whose_model_axes_are_one(runs):
    ranks = runs["arrays"][2]
    want = runs["hybrid_ref"]
    for r in ranks:
        assert _rel(r["hybrid/prefill"], want["prefill"]) <= LOGIT_TOL
        assert np.array_equal(r["hybrid/gen"], want["gen"])


def _duck_mesh(shape, rank: int = 0):
    axes = ("data", "model")
    coords = dict(zip(axes, (int(c) for c in np.unravel_index(rank, shape))))
    return tmesh.RankMesh(axes, dict(zip(axes, shape)), rank, coords,
                          ("cpu",) * math.prod(shape))


def test_a_mesh_of_one_gives_the_unsharded_bits():
    mesh = tmesh.make_host_mesh(device="cpu")
    rng = np.random.default_rng(3)
    for name in MODELS:
        cfg = port_cfg(name)
        params = tmodel.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
        tokens = torch.from_numpy(rng.integers(0, cfg.vocab_size, (B, P + 1)))
        outs = []
        for m in (None, mesh):
            eng = Engine(cfg, params, ServeConfig(max_seq_len=BUDGET, batch_size=B), "cpu",
                         mesh=m)
            logits, cache = eng.prefill(params, {"tokens": tokens[:, :P]})
            cache = eng._pad_cache(cache, P)
            step, cache = eng.decode(params, cache, {"token": tokens[:, P:], "pos": P})
            outs.append((logits, cache["k"], step, eng.generate(tokens[:, :P].numpy(), 3)))
        (a, ka, sa, ga), (b, kb, sb, gb) = outs
        assert torch.equal(a, b) and torch.equal(ka, kb) and torch.equal(sa, sb), name
        assert np.array_equal(ga, gb), name


def test_serve_layout_cuts_rows_positions_and_blocks():
    rules = tsharding.RULES_SERVE
    lay = tsharding.ServeLayout.build(_duck_mesh((2, 2), 3), rules, 4, 24)
    assert (lay.model, lay.batch, lay.n, lay.seq) == (("model",), ("data",), 2, True)
    assert lay.rows(4) == (2, 4) and lay.positions() == (12, 24)
    assert lay.cut(56) and not lay.cut(7) and lay.block(56) == (28, 56) and lay.block(7) == (0, 7)
    odd = tsharding.ServeLayout.build(_duck_mesh((2, 2), 3), rules, 3, 1)
    assert odd.batch == () and not odd.seq and odd.rows(3) == (0, 3) and odd.positions() == (0, 1)
    bad = rules.replace(vocab="data")
    with pytest.raises(ValueError, match="one set of axes"):
        tsharding.ServeLayout.build(_duck_mesh((2, 2)), bad, 4, 24)
    assert tsharding.dim_range(_duck_mesh((2, 2), 1), ("data", "model"), 8) == (2, 4)
