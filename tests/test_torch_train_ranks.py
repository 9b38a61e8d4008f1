"""LM training across ranks on the CPU: the port's mesh, sharding rules,
ZeRO-sharded parameters and AdamW state, the sharded train step, the
Trainer across ranks and the elastic checkpoint restore, against the JAX
package.

The specs. ``ParamDef.logical``, ``spec_for``, ``param_pspecs``,
``zero_spec`` and ``opt_pspecs`` equal the reference's for every
registered config (SMOKE and whole) on the meshes (1, 1), (2, 1), (4, 1),
(2, 4) and (2, 16, 16). The reference's functions read only
``mesh.axis_names`` and ``mesh.shape``, so a duck-typed mesh serves both
sides with no forced devices.

The step. The port's ranks are CPU processes over gloo (spawned as
``tests/test_torch_shard.py`` spawns them: ``torch.multiprocessing``, a
``FileStore``, a 120 s group timeout), the ranks' functions in this module;
the reference runs in a subprocess over 4 forced host devices. Both take
the reference's initial parameters as numpy (every rank its blocks through
``convert.lm_params_from_numpy(..., sharding=(mesh, specs))``) and the same
global batch of 4 x 32 tokens. f32 SMOKE configs: repro-100m (dense),
granite-moe-1b-a400m with ``capacity_factor=8.0`` (no token is dropped on
any mesh) and zamba2-2.7b (hybrid). One step at worlds 2 and 4: the loss
within 1e-5 relative and the gathered parameters, master copy, ``mu`` and
``nu`` within 1e-4 of each leaf's max|reference|. Dense and hybrid are held
to the reference's one-device step. The MoE block's load-balance loss is
each data shard's own, averaged over the shards (the reference's ``pmean``
in ``models/moe.py``), so the MoE step is a function of the mesh: it is
held to the reference's step on the same (n, 1) mesh.

Also: a mesh of one gives the unsharded step's bits; the same bits twice
at world 2; the collective payload of a step equals the count from the
specs (``train.step.collective_bytes_per_step``); a 5-step ``Trainer`` at
world 2 against the world of one (its initial blocks the world of one's
bits; losses 1e-5, grad norms 1e-4 relative, final parameters 5e-4 of
max|leaf|, as ``tests/test_torch_trainer.py`` holds the port to the
reference); a world-2 run killed by ``FailureInjector`` and resumed at
world 2 ends with the uninterrupted run's bits; the world-2 checkpoint
restored at worlds 1 and 4 gathers to the same bits, and the reference's
``CheckpointManager`` reads it.
"""
import dataclasses
import datetime
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.configs import get_config
from repro_torch.configs.registry import _MODULES as CONFIGS
from repro_torch.configs.base import ShapeConfig
from repro_torch.convert import lm_params_from_numpy
from repro_torch.launch import mesh as tmesh
from repro_torch.models import model as tmodel
from repro_torch.models import sharding as tsharding
from repro_torch.optim import adamw
from repro_torch.train.step import make_train_step, train_state_specs
from repro_torch.train.trainer import Trainer, TrainerConfig

# the port's subprocess and its spawned ranks import this module for its
# rank functions alone, and skip the JAX package (seconds an import)
PORT_ONLY = os.environ.get("TRAIN_RANKS_PORT_ONLY") == "1"
if not PORT_ONLY:
    import jax

    from repro.checkpoint.manager import CheckpointManager as JCheckpointManager
    from repro.configs import get_config as jget_config
    from repro.models import model as jmodel
    from repro.models import sharding as jsharding
    from repro.optim import adamw as jadamw

ROOT = Path(__file__).resolve().parents[1]

FAMILIES = {"dense": "repro-100m", "moe": "granite-moe-1b-a400m", "hybrid": "zamba2-2.7b"}
WORLDS = (2, 4)
BATCH, SEQ = 4, 32  # one SSD chunk of the SMOKE configs; 4 rows divide over 2 and 4 ranks
OPT = dict(lr=1e-3, warmup_steps=2, total_steps=10)
LOSS_TOL, STATE_TOL = 1e-5, 1e-4
GNORM_TOL, PARAM_TOL = 1e-4, 5e-4  # the trainer's history, as test_torch_trainer.py
TRAIN_STEPS, CKPT_EVERY, KILL_AT = 5, 2, 3  # the kill resumes from step 2's checkpoint
GROUP_TIMEOUT_S = 120
MESHES = ((1, 1), (2, 1), (4, 1), (2, 4), (2, 16, 16))


def port_cfg(arch: str):
    extra = {"capacity_factor": 8.0} if arch.startswith("granite-moe") else {}
    return dataclasses.replace(get_config(arch, smoke=True), dtype="float32", **extra)


def global_batch(arch: str) -> dict:
    from repro_torch.data.pipeline import DataConfig, batch_for_step

    return batch_for_step(port_cfg(arch), ShapeConfig("t", SEQ, BATCH, "train"),
                          DataConfig(seed=5), 3)


def trainer_cfg(directory: str) -> TrainerConfig:
    tcfg = TrainerConfig(total_steps=TRAIN_STEPS, log_every=1000,
                         opt=adamw.AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=TRAIN_STEPS),
                         checkpoint_dir=directory)
    tcfg.ft = dataclasses.replace(tcfg.ft, checkpoint_every=CKPT_EVERY, retry_backoff_s=0.0)
    return tcfg


def make_trainer(directory: str, mesh=None, injector=None) -> Trainer:
    return Trainer(port_cfg("repro-100m"), ShapeConfig("t", SEQ, BATCH, "train"),
                   trainer_cfg(directory), injector=injector, device="cpu", mesh=mesh)


def flat_names(tree, prefix=""):
    """The leaf paths of a tree of dicts in ``adamw.leaves`` order."""
    if isinstance(tree, dict):
        return [n for k in sorted(tree) for n in flat_names(tree[k], f"{prefix}{k}/")]
    return [prefix.rstrip("/")]


def unflatten(flat: dict, prefix: str, like):
    """A tree shaped as ``like`` from ``flat[prefix + path]``."""
    if isinstance(like, dict):
        return {k: unflatten(flat, f"{prefix}{k}/", v) for k, v in like.items()}
    return flat[prefix.rstrip("/")]


def state_arrays(params, opt) -> dict:
    """Whole parameters and optimizer state as ``{"params/..", "master/..",
    ...}`` numpy arrays."""
    out = {}
    for part, tree in (("params", params), ("master", opt.master), ("mu", opt.mu),
                       ("nu", opt.nu)):
        for name, t in zip(flat_names(tree), adamw.leaves(tree)):
            out[f"{part}/{name}"] = t.detach().float().numpy()
    return out


class Killed(Exception):
    pass


# -- the ranks -----------------------------------------------------------------


def _init(rank: int, world: int, store: str) -> None:
    import torch.distributed as dist

    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(store, world), rank=rank,
                            world_size=world,
                            timeout=datetime.timedelta(seconds=GROUP_TIMEOUT_S))


def _step_case(mesh, arch: str, tmp: str) -> tuple:
    """One sharded step from the reference's numpy parameters: (metrics,
    this rank's new blocks and state, the counters of the step)."""
    from repro_torch.models.sharding import RULES_TRAIN

    cfg = port_cfg(arch)
    with np.load(Path(tmp, f"params-{arch}.npz")) as f:
        numpy_params = unflatten(dict(f), "", tmodel.param_defs(cfg))
    pspecs = tmodel.param_pspecs(cfg, RULES_TRAIN, mesh)
    zspecs = adamw.opt_pspecs(pspecs, tmodel.param_shapes(cfg), mesh, RULES_TRAIN).master
    params = lm_params_from_numpy(numpy_params, cfg, "cpu", sharding=(mesh, pspecs))
    opt = adamw.init(params, mesh, pspecs, zspecs)
    rows = tsharding.spec_for(("batch",), RULES_TRAIN, mesh, (BATCH,))
    batch = {k: mesh.local_block(torch.from_numpy(v), rows) for k, v in global_batch(arch).items()}
    step = make_train_step(cfg, adamw.AdamWConfig(**OPT), mesh)
    mesh.reset_counters()
    params, opt, metrics = step(params, opt, batch)
    counters = dict(mesh.counters)
    return metrics, params, opt, counters, pspecs, zspecs


def _whole(mesh, tree, specs):
    return adamw.map_tree(lambda t, spec: mesh.gather_full(t, spec), tree, specs)


def _same(a, b) -> bool:
    return all(torch.equal(x, y) for x, y in zip(adamw.leaves(a), adamw.leaves(b)))


def _rank(rank: int, world: int, store: str, tmp: str) -> None:
    from repro_torch.runtime.fault_tolerance import FailureInjector
    from repro_torch.train.step import collective_bytes_per_step

    _init(rank, world, store)
    mesh = tmesh.make_host_mesh(device="cpu")
    out = {"rank": rank, "world": mesh.size, "route": mesh.route, "steps": {}}
    for family, arch in FAMILIES.items():
        metrics, params, opt, counters, pspecs, zspecs = _step_case(mesh, arch, tmp)
        whole = state_arrays(_whole(mesh, params, pspecs), adamw.OptState(
            _whole(mesh, opt.master, zspecs), _whole(mesh, opt.mu, zspecs),
            _whole(mesh, opt.nu, zspecs), opt.count))
        case = {"loss": float(metrics["loss"]), "grad_norm": float(metrics["grad_norm"]),
                "lr": float(metrics["lr"]), "counters": counters,
                "model": collective_bytes_per_step(port_cfg(arch), mesh)}
        if world == 2:  # the same step again from the same start: the same bits
            _, p2, o2, _, _, _ = _step_case(mesh, arch, tmp)
            case["same_bits_twice"] = _same(params, p2) and all(
                _same(getattr(opt, f), getattr(o2, f)) for f in ("master", "mu", "nu"))
        if rank == 0:
            np.savez(Path(tmp, f"port-{world}-{family}.npz"), **whole)
        out["steps"][family] = case
    if world == 2:
        a = make_trainer(str(Path(tmp, "a")), mesh)
        p0, _ = a.whole_state()
        hist = a.run()
        pa, oa = a.whole_state()
        b = make_trainer(str(Path(tmp, "b")), mesh, FailureInjector(fail_at=[KILL_AT], exc=Killed))
        try:
            b.run()
            killed = False
        except Killed:
            killed = True
        c = make_trainer(str(Path(tmp, "b")), mesh)
        start = c.start_step
        c.run()
        pc, oc = c.whole_state()
        out["trainer"] = {"history": hist, "killed": killed, "resumed_at": start,
                          "resumed_bits_equal": _same(pa, pc) and all(
                              _same(getattr(oa, f), getattr(oc, f))
                              for f in ("master", "mu", "nu"))}
        if rank == 0:
            np.savez(Path(tmp, "trainer-2.npz"), **state_arrays(pa, oa))
            np.savez(Path(tmp, "trainer-2-init.npz"),
                     **{f"params/{n}": t.numpy() for n, t in zip(flat_names(p0),
                                                                 adamw.leaves(p0))})
    if world == 4:  # the world-2 trainer's last checkpoint, cut to 4 ranks and gathered
        like, shardings = train_state_specs(port_cfg("repro-100m"), mesh)
        (p, o), step, _ = CheckpointManager(str(Path(tmp, "a"))).restore(
            like, device="cpu", shardings=shardings)
        pspecs = adamw.map_tree(lambda s: s.spec, shardings[0])
        zspecs = adamw.map_tree(lambda s: s.spec, shardings[1].master)
        blocks = {"param_block_rows": int(p["lm_head"]["w"].shape[0]),
                  "master_block_rows": int(o.master["embed"]["table"].shape[0])}
        whole_p = _whole(mesh, p, pspecs)
        whole_o = adamw.OptState(_whole(mesh, o.master, zspecs), _whole(mesh, o.mu, zspecs),
                                 _whole(mesh, o.nu, zspecs), o.count)
        out["restore"] = {"step": step, "count": int(o.count), **blocks}
        if rank == 0:
            np.savez(Path(tmp, "restore-4.npz"), **state_arrays(whole_p, whole_o))
    Path(tmp, f"ranks-{world}-r{rank}.json").write_text(json.dumps(out))


def _spawn(world: int, tmp: str) -> None:
    import torch.multiprocessing as mp

    mp.start_processes(_rank, args=(world, os.path.join(tmp, f"store-{world}"), tmp),
                       nprocs=world, start_method="spawn")


def main(tmp: str) -> None:
    """The port's side, in a subprocess: spawn the ranks of each world."""
    out = {}
    for world in WORLDS:
        _spawn(world, tmp)
        out[str(world)] = [json.loads(Path(tmp, f"ranks-{world}-r{r}.json").read_text())
                           for r in range(world)]
    print(json.dumps(out))


def reference_step(tmp: str, family: str, n: int) -> dict:
    """The reference's ``make_train_step`` of ``family`` on the first ``n``
    devices as an (n, 1) mesh, from the numpy parameters and the global
    batch; writes the new state as numpy and returns the metrics."""
    import jax.numpy as jnp
    from jax.sharding import Mesh

    from repro.models.sharding import RULES_TRAIN
    from repro.train.step import make_train_step as jmake_train_step

    arch = FAMILIES[family]
    jcfg = ref_cfg(arch)
    with np.load(Path(tmp, f"params-{arch}.npz")) as f:
        flat = dict(f)
    mesh = Mesh(np.array(jax.devices()[:n]).reshape(n, 1), ("data", "model"))
    pshard = jmodel.param_shardings(jcfg, RULES_TRAIN, mesh)
    params = jax.tree_util.tree_map(lambda a, s: jax.device_put(jnp.asarray(a), s),
                                    unflatten(flat, "", jmodel.param_defs(jcfg)), pshard)
    step = jax.jit(jmake_train_step(jcfg, mesh, RULES_TRAIN, jadamw.AdamWConfig(**OPT)))
    p, o, m = step(params, jadamw.init(params),
                   {k: jnp.asarray(v) for k, v in global_batch(arch).items()})
    arrays = {}
    for part, tree in (("params", p), ("master", o.master), ("mu", o.mu), ("nu", o.nu)):
        for name, leaf in zip(flat_names(tree), jax.tree_util.tree_leaves(tree)):
            arrays[f"{part}/{name}"] = np.asarray(leaf, np.float32)
    np.savez(Path(tmp, f"ref-{n}-{family}.npz"), **arrays)
    return {k: float(v) for k, v in m.items()}


def reference(tmp: str) -> None:
    """The reference's MoE step on the (2, 1) and (4, 1) meshes, in a
    subprocess with 4 forced host devices."""
    out = {"n_devices": len(jax.devices())}
    for n in WORLDS:
        out[f"{n}/moe"] = reference_step(tmp, "moe", n)
    print(json.dumps(out))


def ref_cfg(arch: str):
    extra = {"capacity_factor": 8.0} if arch.startswith("granite-moe") else {}
    return dataclasses.replace(jget_config(arch, smoke=True), dtype="float32", **extra)


def _start(code: str, env_extra: dict) -> subprocess.Popen:
    env = dict(os.environ, **env_extra)
    env["PYTHONPATH"] = os.pathsep.join([str(ROOT / "src"), str(ROOT / "tests")])
    return subprocess.Popen([sys.executable, "-c", code], env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)


def _finish(proc: subprocess.Popen, timeout: float = 300) -> dict:
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
    """Both sides' runs, their subprocesses side by side, from the
    reference's initial parameters written here as numpy."""
    tmp = tmp_path_factory.mktemp("train-ranks")
    for arch in FAMILIES.values():
        jparams = jmodel.init_params(ref_cfg(arch), jax.random.PRNGKey(0))
        leaves = jax.tree_util.tree_leaves(jparams)
        np.savez(tmp / f"params-{arch}.npz",
                 **{n: np.asarray(a) for n, a in zip(flat_names(jparams), leaves)})
    port = _start(f"import test_torch_train_ranks as t; t.main({str(tmp)!r})",
                  {"TRAIN_RANKS_PORT_ONLY": "1"})
    ref = _start(f"import test_torch_train_ranks as t; t.reference({str(tmp)!r})",
                 {"XLA_FLAGS": "--xla_force_host_platform_device_count=4",
                  "JAX_PLATFORMS": "cpu"})
    # dense and hybrid do not depend on the mesh: their one-device reference
    # runs here while the subprocesses run
    one = {f"1/{family}": reference_step(str(tmp), family, 1) for family in ("dense", "hybrid")}
    return {"tmp": tmp, "port": _finish(port), "ref": {**_finish(ref), **one}}


def _load(path) -> dict:
    with np.load(path) as f:
        return dict(f)


def _worst_gap(got: dict, want: dict) -> tuple:
    assert sorted(got) == sorted(want)
    return max((float(np.abs(got[k] - want[k]).max()) / max(float(np.abs(want[k]).max()), 1e-30),
                k) for k in want)


# -- the specs -------------------------------------------------------------------


class DuckMesh:
    """What both packages' spec functions read of a mesh."""

    def __init__(self, shape):
        self.axis_names = ("data", "model") if len(shape) == 2 else ("pod", "data", "model")
        self.shape = dict(zip(self.axis_names, shape))


def _ptuple(spec) -> tuple:
    return tuple(spec)


ARCHS = sorted(CONFIGS)


def test_logical_names_and_dtypes_match_the_reference_schema():
    for arch in ARCHS:
        for smoke in (True, False):
            jdefs = jmodel.param_defs(jget_config(arch, smoke=smoke))
            defs = tmodel.param_defs(get_config(arch, smoke=smoke))
            want = jax.tree_util.tree_map(lambda d: (d.shape, d.logical, d.init, d.dtype), jdefs,
                                          is_leaf=lambda d: isinstance(d, jmodel.ParamDef))
            got = tmodel.map_defs(lambda d: (d.shape, d.logical, d.init, d.dtype), defs)
            assert got == want, (arch, smoke)


@pytest.mark.parametrize("mesh_shape", MESHES, ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("rules_name", ["RULES_TRAIN", "RULES_SERVE"])
def test_param_and_zero_specs_match_the_reference(mesh_shape, rules_name):
    mesh = DuckMesh(mesh_shape)
    jrules, rules = getattr(jsharding, rules_name), getattr(tsharding, rules_name)
    assert rules.rules == jrules.rules
    for arch in ARCHS:
        for smoke in (True, False):
            jcfg, cfg = jget_config(arch, smoke=smoke), get_config(arch, smoke=smoke)
            jspecs = jmodel.param_pspecs(jcfg, jrules, mesh)
            specs = tmodel.param_pspecs(cfg, rules, mesh)
            is_p = lambda x: isinstance(x, jax.sharding.PartitionSpec)  # noqa: E731
            want = jax.tree_util.tree_map(_ptuple, jspecs, is_leaf=is_p)
            assert specs == want, (arch, smoke)
            jz = jadamw.opt_pspecs(jspecs, jmodel.param_shapes(jcfg), mesh, jrules)
            z = adamw.opt_pspecs(specs, tmodel.param_shapes(cfg), mesh, rules)
            assert z.master == jax.tree_util.tree_map(_ptuple, jz.master, is_leaf=is_p), arch
            assert z.mu == z.nu == z.master and z.count == tuple(jz.count) == ()


@pytest.mark.parametrize("mesh_shape", MESHES, ids=lambda s: "x".join(map(str, s)))
def test_spec_for_axis_size_and_resolve_match_the_reference(mesh_shape):
    mesh = DuckMesh(mesh_shape)
    rng = np.random.default_rng(3)
    names = [n for n, _ in tsharding.DEFAULT_RULES.rules] + ["unknown"]
    for _ in range(200):
        logical = tuple(rng.choice(names, size=rng.integers(1, 4)))
        shape = tuple(int(rng.choice([1, 2, 3, 4, 6, 8, 12, 16, 32, 48, 64, 512])) for _ in logical)
        for s in (None, shape):
            want = tuple(jsharding.spec_for(logical, jsharding.DEFAULT_RULES, mesh, s))
            assert tsharding.spec_for(logical, tsharding.DEFAULT_RULES, mesh, s) == want
    for name in names[:-1]:
        assert (tsharding.axis_size(name, tsharding.DEFAULT_RULES, mesh)
                == jsharding.axis_size(name, jsharding.DEFAULT_RULES, mesh))
        axes = tsharding.DEFAULT_RULES.table()[name]
        assert tsharding._resolve_axes(axes, mesh) == jsharding._resolve_axes(axes, mesh)
    for spec, shape in ((("data", None), (8, 3)), ((None, None), (6, 5)),
                        ((("pod", "data"), "model"), (64, 32)), ((None,), (7,))):
        want = jadamw.zero_spec(jax.sharding.PartitionSpec(*spec), shape, mesh,
                                jsharding.DEFAULT_RULES)
        assert adamw.zero_spec(spec, shape, mesh, tsharding.DEFAULT_RULES) == tuple(want)


def test_constrain_is_the_identity():
    x = torch.randn(4, 6)
    assert tsharding.constrain(x, ("batch", "none"), tsharding.DEFAULT_RULES,
                               DuckMesh((2, 1))) is x


# -- the mesh ----------------------------------------------------------------------


def _mesh_at(shape, rank, axes=None):
    axes = axes or (("data", "model") if len(shape) == 2 else ("pod", "data", "model"))
    coords = dict(zip(axes, (int(c) for c in np.unravel_index(rank, shape))))
    return tmesh.RankMesh(axes, dict(zip(axes, shape)), rank, coords, ("cpu",) * int(np.prod(shape)))


def test_blocks_go_to_ranks_in_row_major_order():
    """A dim sharded over ("pod", "data") of a (2, 16, 16) mesh: rank r's
    block index is pod * 16 + data, as a NamedSharding places blocks; the
    "model" coordinate does not move it."""
    t = torch.arange(64 * 3).reshape(64, 3)
    seen = {}
    for rank in range(512):
        m = _mesh_at((2, 16, 16), rank)
        idx = m.block_index(("pod", "data"))
        assert idx == m.coords["pod"] * 16 + m.coords["data"]
        seen.setdefault(idx, m.local_block(t, (("pod", "data"), None)))
        assert torch.equal(seen[idx], m.local_block(t, (("pod", "data"), None)))
    assert torch.equal(torch.cat([seen[i] for i in range(32)]), t)
    m = _mesh_at((4, 2), 5)  # data 2, model 1
    w = torch.arange(48).reshape(8, 6)
    assert torch.equal(m.local_block(w, ("data", "model")), w[4:6, 3:6])
    assert not m.owns(("data", None)) and _mesh_at((4, 2), 4).owns(("data", None))
    assert not _mesh_at((4, 2), 4).owns((None, None)) and _mesh_at((4, 2), 0).owns((None, None))
    with pytest.raises(ValueError):
        m.live_axes(("data", "pod"))


def test_world_of_one_and_mesh_size_rules():
    m = tmesh.make_host_mesh(device="cpu")
    assert (m.size, m.shape, m.route, m.group) == (1, {"data": 1, "model": 1}, "none", None)
    t = torch.randn(4, 4)
    assert m.all_gather(t, 0, "data") is t and m.reduce_scatter(t, 0, "data") is t
    assert m.all_reduce(t) is t and m.counters["all_gather"] == 0
    with pytest.raises(ValueError, match="needs 2 ranks"):
        tmesh.make_mesh((2, 1), ("data", "model"), device="cpu")
    with pytest.raises(ValueError, match="256"):
        tmesh.make_production_mesh(device="cpu")
    with pytest.raises(ValueError, match="512"):
        tmesh.make_production_mesh(multi_pod=True, device="cpu")
    with pytest.raises(RuntimeError, match="CUDA"):
        tmesh.make_host_mesh()  # the card by default


@pytest.mark.parametrize("family", list(FAMILIES))
def test_a_mesh_of_one_gives_the_unsharded_bits(family):
    cfg = port_cfg(FAMILIES[family])
    mesh = tmesh.make_host_mesh(device="cpu")
    batch = {k: torch.from_numpy(v) for k, v in global_batch(FAMILIES[family]).items()}
    outs = []
    for m in (None, mesh):
        params = tmodel.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
        step = make_train_step(cfg, adamw.AdamWConfig(**OPT), m)
        p, o, metrics = step(params, adamw.init(params), batch)
        outs.append((p, o, metrics))
    (p1, o1, m1), (p2, o2, m2) = outs
    assert all(torch.equal(m1[k], m2[k]) for k in m1)
    assert _same(p1, p2) and all(_same(getattr(o1, f), getattr(o2, f))
                                 for f in ("master", "mu", "nu"))


# -- the step across ranks ----------------------------------------------------------------


def test_the_reference_ran_on_four_forced_devices(runs):
    assert runs["ref"]["n_devices"] == 4
    for world in WORLDS:
        assert [r["world"] for r in runs["port"][str(world)]] == [world] * world
        assert {r["route"] for r in runs["port"][str(world)]} == {"gloo"}


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("family", list(FAMILIES))
def test_one_step_matches_the_reference(runs, world, family):
    n = world if family == "moe" else 1
    want_m = runs["ref"][f"{n}/{family}"]
    for r in runs["port"][str(world)]:
        got = r["steps"][family]
        assert got["loss"] == pytest.approx(want_m["loss"], rel=LOSS_TOL)
        assert got["grad_norm"] == pytest.approx(want_m["grad_norm"], rel=LOSS_TOL)
        assert got["lr"] == pytest.approx(want_m["lr"], rel=1e-6)
    tmp = runs["tmp"]
    gap, where = _worst_gap(_load(tmp / f"port-{world}-{family}.npz"),
                            _load(tmp / f"ref-{n}-{family}.npz"))
    assert gap <= STATE_TOL, (gap, where)


@pytest.mark.parametrize("world", WORLDS)
def test_every_rank_reports_the_same_metrics(runs, world):
    ranks = runs["port"][str(world)]
    for family in FAMILIES:
        assert len({(r["steps"][family]["loss"], r["steps"][family]["grad_norm"])
                    for r in ranks}) == 1


def test_the_same_bits_twice_at_world_two(runs):
    for r in runs["port"]["2"]:
        assert all(r["steps"][f]["same_bits_twice"] for f in FAMILIES)


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("family", list(FAMILIES))
def test_collective_bytes_equal_the_count_from_the_specs(runs, world, family):
    for r in runs["port"][str(world)]:
        case = r["steps"][family]
        assert case["counters"]["host_staged"] == 0  # gloo on host tensors: nothing staged
        assert {k: case["counters"][k] for k in case["model"]} == case["model"]
        assert case["model"]["all_gather"] > 0 and case["model"]["reduce_scatter"] > 0


# -- the trainer across ranks -----------------------------------------------------


@pytest.fixture(scope="module")
def world_one(runs):
    """The world of one's 5-step trainer, and the world-2 checkpoint
    restored at world 1."""
    tmp = runs["tmp"]
    t = make_trainer(str(tmp / "w1"))
    init = dict(state_arrays(t.params, t.opt_state))
    hist = t.run()
    like = (t.params, t.opt_state)
    (p, o), step, _ = CheckpointManager(str(tmp / "a")).restore(like, device="cpu")
    return {"trainer": t, "init": init, "history": hist, "restored": state_arrays(p, o),
            "restored_step": step, "restored_count": int(o.count)}


def test_trainer_at_world_two_starts_from_the_world_of_ones_bits(runs, world_one):
    got = _load(runs["tmp"] / "trainer-2-init.npz")
    for k, v in got.items():
        assert np.array_equal(v, world_one["init"][k]), k


def test_trainer_at_world_two_matches_the_world_of_one(runs, world_one):
    want = world_one["history"]
    for r in runs["port"]["2"]:
        hist = r["trainer"]["history"]
        assert [h["step"] for h in hist] == list(range(TRAIN_STEPS))
        for h, w in zip(hist, want):
            assert h["loss"] == pytest.approx(w["loss"], rel=LOSS_TOL)
            assert h["grad_norm"] == pytest.approx(w["grad_norm"], rel=GNORM_TOL)
            assert h["all_gather_bytes"] > 0 and h["reduce_scatter_bytes"] > 0
    got = _load(runs["tmp"] / "trainer-2.npz")
    t = world_one["trainer"]
    want_p = state_arrays(t.params, t.opt_state)
    for k in got:
        if k.startswith("params/"):
            assert np.abs(got[k] - want_p[k]).max() <= PARAM_TOL * np.abs(want_p[k]).max(), k


def test_a_killed_world_two_run_resumes_to_the_uninterrupted_bits(runs):
    for r in runs["port"]["2"]:
        tr = r["trainer"]
        assert tr["killed"] and tr["resumed_at"] == KILL_AT // CKPT_EVERY * CKPT_EVERY
        assert tr["resumed_bits_equal"]


def test_the_world_two_checkpoint_restores_at_worlds_one_and_four(runs, world_one):
    tmp = runs["tmp"]
    final = _load(tmp / "trainer-2.npz")
    four = _load(tmp / "restore-4.npz")
    assert world_one["restored_step"] == TRAIN_STEPS == world_one["restored_count"]
    for k, v in final.items():
        assert np.array_equal(world_one["restored"][k], v), k
        assert np.array_equal(four[k], v), k
    for r in runs["port"]["4"]:
        assert r["restore"]["step"] == TRAIN_STEPS and r["restore"]["count"] == TRAIN_STEPS
        # the blocks were cut for 4 ranks: lm_head's d rows, the table's ZeRO rows
        cfg = port_cfg("repro-100m")
        assert r["restore"]["param_block_rows"] == cfg.d_model // 4
        assert r["restore"]["master_block_rows"] == cfg.padded_vocab // 4


def test_the_reference_manager_reads_the_world_two_checkpoint(runs):
    tmp = runs["tmp"]
    final = _load(tmp / "trainer-2.npz")
    jcfg = ref_cfg("repro-100m")
    shapes = jmodel.param_shapes(jcfg)
    f32 = jax.tree_util.tree_map(lambda s: jax.ShapeDtypeStruct(s.shape, np.float32), shapes)
    like = (shapes, jadamw.OptState(f32, f32, f32, jax.ShapeDtypeStruct((), np.int32)))
    (p, o), step, _ = JCheckpointManager(str(tmp / "a")).restore(like)
    assert step == TRAIN_STEPS and int(o.count) == TRAIN_STEPS
    for part, tree in (("params", p), ("master", o.master), ("mu", o.mu), ("nu", o.nu)):
        for name, leaf in zip(flat_names(tree), jax.tree_util.tree_leaves(tree)):
            assert np.array_equal(np.asarray(leaf, np.float32), final[f"{part}/{name}"]), name


def test_chip_smoke_defines_every_phase_before_it_runs_main():
    """``python3 chip_smoke.py`` runs ``main()`` where the main guard stands:
    every function main calls must be defined above it (the guard is the
    script's last statement)."""
    import ast

    tree = ast.parse((ROOT / "chip_smoke.py").read_text())
    last = tree.body[-1]
    assert isinstance(last, ast.If) and "__main__" in ast.unparse(last.test)
    defined = {n.name for n in tree.body if isinstance(n, ast.FunctionDef)}
    main = next(n for n in tree.body if isinstance(n, ast.FunctionDef) and n.name == "main")
    called = {n.func.id for n in ast.walk(main) if isinstance(n, ast.Call)
              and isinstance(n.func, ast.Name)} | {
        n.id for n in ast.walk(main) if isinstance(n, ast.Name) and n.id.startswith("phase")}
    assert {c for c in called if c.startswith("phase")} <= defined
    assert "phase25_train_ranks" in called
