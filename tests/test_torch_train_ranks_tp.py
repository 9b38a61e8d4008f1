"""LM training on meshes with a model axis on the CPU: the sharded train
step under ``RULES_TRAIN`` (ZeRO over the data axis, tensor-, sequence-,
context- and expert-parallel layers and the Mamba-2 layers over their
heads on the model axis, every collective's backward its adjoint), the
``Trainer`` and its checkpoints on a ``(2, 2)`` mesh, against the JAX
package.

The port's ranks are CPU processes over gloo, spawned from a port-only
subprocess as ``tests/test_torch_train_ranks.py`` spawns them (its helpers
are imported from there); the reference's ``make_train_step(cfg, mesh,
RULES_TRAIN)`` runs in a subprocess over 4 forced host devices, its
one-device step in the test process meanwhile. Both sides take the
reference's initial parameters as numpy (every rank its blocks through
``convert.lm_params_from_numpy(..., sharding=(mesh, specs))``) and the same
global batch of 4 x 32 tokens.

f32 SMOKE configs: repro-100m (dense, ``"cp"``), zamba2-2.7b (hybrid),
mamba2-1.3b (ssm) and granite-moe-1b-a400m with ``capacity_factor=8.0`` (no
token dropped on any mesh), on the meshes (1, 2), (2, 2) and (1, 4), where
every SMOKE width divides. One step: the loss within 1e-5 relative and the
gathered parameters, master copy, ``mu`` and ``nu`` within 1e-4 of each
leaf's max|reference|. Dense, ssm and hybrid are held to the reference's
step on the same mesh and to its one-device step. The MoE block's
load-balance loss is each token shard's own, averaged over the ranks that
hold different tokens (the reference's ``pmean``), so the MoE step is a
function of the mesh: it is held to the reference's step on the same mesh.

Also: a (2, 1) mesh gives the bits of the data-parallel step written out
here (every leaf gathered whole in its layer, the loss over the batch axes'
size, each gradient to its ZeRO block by its one cut dim); the same bits
twice on (2, 2); each step's payload by kind equals
``collective_bytes_per_step``'s count; a 3-step ``Trainer`` on (2, 2)
against the world of one (losses 1e-5, grad norms 1e-4 relative); the
(2, 2) trainer's checkpoint restored at world 1 and on (1, 2) gathers to
its bits.
"""
import dataclasses
import json
import os
from pathlib import Path

import numpy as np
import pytest
import torch

import test_torch_train_ranks as base
from test_torch_train_ranks import (BATCH, OPT, SEQ, _finish, _load, _same, _start, _whole,
                                    _worst_gap, flat_names, global_batch, port_cfg, state_arrays,
                                    unflatten)

from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.convert import lm_params_from_numpy
from repro_torch.launch import mesh as tmesh
from repro_torch.models import model as tmodel
from repro_torch.models import sharding as tsharding
from repro_torch.optim import adamw
from repro_torch.train.step import collective_bytes_per_step, make_train_step, train_state_specs
from repro_torch.train.trainer import Trainer, TrainerConfig

PORT_ONLY = base.PORT_ONLY  # the port's subprocess and its ranks skip the JAX package
if not PORT_ONLY:
    import jax

FAMILIES = {"dense": "repro-100m", "hybrid": "zamba2-2.7b", "ssm": "mamba2-1.3b",
            "moe": "granite-moe-1b-a400m"}
MESHES = {2: ((1, 2),), 4: ((2, 2), (1, 4))}  # by world
TP_MESHES = [m for ms in MESHES.values() for m in ms]
LOSS_TOL, STATE_TOL, GNORM_TOL = 1e-5, 1e-4, 1e-4
TRAIN_STEPS = 3
TRAINER_MESH, RESTORE_MESH = (2, 2), (1, 2)


def mesh_id(shape) -> str:
    return "x".join(map(str, shape))


def trainer_cfg(directory: str) -> TrainerConfig:
    tcfg = TrainerConfig(total_steps=TRAIN_STEPS, log_every=1000,
                         opt=adamw.AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=TRAIN_STEPS),
                         checkpoint_dir=directory)
    tcfg.ft = dataclasses.replace(tcfg.ft, retry_backoff_s=0.0)
    return tcfg


def make_trainer(directory: str, mesh=None) -> Trainer:
    from repro_torch.configs.base import ShapeConfig

    return Trainer(port_cfg("repro-100m"), ShapeConfig("t", SEQ, BATCH, "train"),
                   trainer_cfg(directory), device="cpu", mesh=mesh, rules=tsharding.RULES_TRAIN)


# -- the ranks -----------------------------------------------------------------


def _start_state(mesh, arch: str, tmp: str):
    """This rank's blocks of the reference's parameters, a fresh AdamW state
    and its rows of the global batch."""
    rules = tsharding.RULES_TRAIN
    cfg = port_cfg(arch)
    with np.load(Path(tmp, f"params-{arch}.npz")) as f:
        numpy_params = unflatten(dict(f), "", tmodel.param_defs(cfg))
    pspecs = tmodel.param_pspecs(cfg, rules, mesh)
    zspecs = adamw.opt_pspecs(pspecs, tmodel.param_shapes(cfg), mesh, rules).master
    params = lm_params_from_numpy(numpy_params, cfg, "cpu", sharding=(mesh, pspecs))
    opt = adamw.init(params, mesh, pspecs, zspecs)
    rows = tsharding.spec_for(("batch",), rules, mesh, (BATCH,))
    batch = {k: mesh.local_block(torch.from_numpy(v), rows)
             for k, v in global_batch(arch).items()}
    return cfg, params, opt, batch, pspecs, zspecs


def _data_parallel_step(cfg, mesh, params, opt, batch):
    """The sharded step on a mesh whose model axis is 1, written out as a
    data-parallel step: the top leaves and each layer's leaves gathered
    whole (the layers inside their remat bodies), the unsharded blocks, the
    loss scaled by 1 / |batch axes|, each gradient to its ZeRO block by its
    one cut dim (the gather's backward, a reduce-scatter, or an
    all-reduce over every axis), the blocks gathered back."""
    rules = tsharding.RULES_TRAIN
    pspecs = tmodel.param_pspecs(cfg, rules, mesh)
    zspecs = adamw.opt_pspecs(pspecs, tmodel.param_shapes(cfg), mesh, rules).master

    def cut_dim(spec):
        dims = [(d, axes) for d, axes in enumerate(spec) if mesh.live_axes(axes)]
        assert len(dims) <= 1, spec
        return dims[0] if dims else None

    inner = {"layers": adamw.map_tree(lambda s: s[1:], pspecs["layers"]),
             "shared": pspecs.get("shared")}
    flat = [p.detach().requires_grad_() for p in adamw.leaves(params)]
    with torch.enable_grad():
        p = adamw.rebuild(params, flat)
        p = {**p, **{k: tmodel.gather_params(p[k], pspecs[k], mesh) for k in tmodel.TOP_LEAVES}}
        x = tmodel._embed(cfg, p, batch.get("tokens"), batch.get("embeds"))
        positions = torch.arange(x.shape[1], dtype=torch.int32)
        x, aux = tmodel._train_stack(cfg, p, x, positions,
                                     lambda q, key: tmodel.gather_params(q, inner[key], mesh))
        loss = tmodel.loss_from_hidden(cfg, p, x, batch["labels"], aux)
        n = mesh.axes_size(mesh.live_axes(("pod", "data") if "pod" in mesh.shape else "data"))
        grads = torch.autograd.grad(loss * (1.0 / n), flat, materialize_grads=True,
                                    allow_unused=True)
    zgrads, moves = [], []
    for g, ps, zs in zip(grads, adamw.leaves(pspecs), adamw.leaves(zspecs)):
        move = None if cut_dim(ps) else cut_dim(zs) or "all_reduce"
        if move == "all_reduce":
            g = mesh.all_reduce(g)
        elif move is not None:
            g = mesh.reduce_scatter(g, *move)
        zgrads.append(g)
        moves.append(move)
    blocks, opt, metrics = adamw.apply(adamw.AdamWConfig(**OPT), adamw.rebuild(params, zgrads),
                                       opt, mesh, zspecs)
    new = [mesh.all_gather(b, *m) if isinstance(m, tuple) else b
           for b, m in zip(adamw.leaves(blocks), moves)]
    metrics["loss"] = mesh.all_reduce(loss.detach()) / mesh.size
    return adamw.rebuild(params, new), opt, metrics


def _step(mesh, arch: str, tmp: str) -> tuple:
    cfg, params, opt, batch, pspecs, zspecs = _start_state(mesh, arch, tmp)
    step = make_train_step(cfg, adamw.AdamWConfig(**OPT), mesh, tsharding.RULES_TRAIN)
    mesh.reset_counters()
    params, opt, metrics = step(params, opt, batch)
    return metrics, params, opt, dict(mesh.counters), pspecs, zspecs


def _whole_state(mesh, params, opt, pspecs, zspecs) -> dict:
    return state_arrays(_whole(mesh, params, pspecs), adamw.OptState(
        _whole(mesh, opt.master, zspecs), _whole(mesh, opt.mu, zspecs),
        _whole(mesh, opt.nu, zspecs), opt.count))


def _mesh_cases(rank: int, mesh, tmp: str) -> dict:
    """Every family's step on ``mesh``: metrics, counters, the count from
    the specs; rank 0 writes the whole new state."""
    out = {}
    for family, arch in FAMILIES.items():
        metrics, params, opt, counters, pspecs, zspecs = _step(mesh, arch, tmp)
        whole = _whole_state(mesh, params, opt, pspecs, zspecs)
        out[family] = {"loss": float(metrics["loss"]), "grad_norm": float(metrics["grad_norm"]),
                       "lr": float(metrics["lr"]), "counters": counters,
                       "model": collective_bytes_per_step(port_cfg(arch), mesh,
                                                          tsharding.RULES_TRAIN, BATCH, SEQ)}
        if mesh.shape == {"data": 2, "model": 2}:  # the same step again: the same bits
            _, p2, o2, _, _, _ = _step(mesh, arch, tmp)
            out[family]["same_bits_twice"] = _same(params, p2) and all(
                _same(getattr(opt, f), getattr(o2, f)) for f in ("master", "mu", "nu"))
        if rank == 0:
            np.savez(Path(tmp, f"port-{mesh_id(mesh.shape.values())}-{family}.npz"), **whole)
    return out


def _rank(rank: int, world: int, store: str, tmp: str) -> None:
    base._init(rank, world, store)
    out = {"rank": rank, "world": world, "meshes": {}}
    for shape in MESHES[world]:
        mesh = tmesh.make_mesh(shape, ("data", "model"), device="cpu")
        out["meshes"][mesh_id(shape)] = {"coords": mesh.coords, "route": mesh.route,
                                         "steps": _mesh_cases(rank, mesh, tmp)}
    if world == 4:  # the trainer on (2, 2), its last checkpoint under tmp/trainer
        mesh = tmesh.make_mesh(TRAINER_MESH, ("data", "model"), device="cpu")
        t = make_trainer(str(Path(tmp, "trainer")), mesh)
        p0, _ = t.whole_state()
        hist = t.run()
        pw, ow = t.whole_state()
        out["trainer"] = {"history": hist}
        if rank == 0:
            np.savez(Path(tmp, "trainer-final.npz"), **state_arrays(pw, ow))
            np.savez(Path(tmp, "trainer-init.npz"),
                     **{f"params/{n}": a.numpy() for n, a in zip(flat_names(p0),
                                                                  adamw.leaves(p0))})
    if world == 2:
        # the data-parallel step's bits on (2, 1)
        mesh = tmesh.make_mesh((2, 1), ("data", "model"), device="cpu")
        same = {}
        for family, arch in FAMILIES.items():
            _, p1, o1, _, _, _ = _step(mesh, arch, tmp)
            cfg, params, opt, batch, _, _ = _start_state(mesh, arch, tmp)
            p2, o2, _ = _data_parallel_step(cfg, mesh, params, opt, batch)
            same[family] = _same(p1, p2) and all(_same(getattr(o1, f), getattr(o2, f))
                                                 for f in ("master", "mu", "nu"))
        out["data_parallel_bits"] = same
        # the (2, 2) trainer's checkpoint cut for (1, 2) and gathered
        mesh = tmesh.make_mesh(RESTORE_MESH, ("data", "model"), device="cpu")
        like, shardings = train_state_specs(port_cfg("repro-100m"), mesh)
        (p, o), step, _ = CheckpointManager(str(Path(tmp, "trainer"))).restore(
            like, device="cpu", shardings=shardings)
        pspecs = adamw.map_tree(lambda s: s.spec, shardings[0])
        zspecs = adamw.map_tree(lambda s: s.spec, shardings[1].master)
        out["restore"] = {"step": step, "count": int(o.count),
                          "lm_head_block": list(p["lm_head"]["w"].shape)}
        whole = _whole_state(mesh, p, o, pspecs, zspecs)
        if rank == 0:
            np.savez(Path(tmp, "restore-1x2.npz"), **whole)
    Path(tmp, f"ranks-{world}-r{rank}.json").write_text(json.dumps(out))


def main(tmp: str) -> None:
    """The port's side, in a subprocess: 4 ranks (the (2, 2) and (1, 4)
    meshes, the trainer), then 2 ranks ((1, 2), (2, 1), the restore)."""
    import torch.multiprocessing as mp

    out = {}
    for world in (4, 2):
        mp.start_processes(_rank, args=(world, os.path.join(tmp, f"store-{world}"), tmp),
                           nprocs=world, start_method="spawn")
        out[str(world)] = [json.loads(Path(tmp, f"ranks-{world}-r{r}.json").read_text())
                           for r in range(world)]
    print(json.dumps(out))


# -- the reference -------------------------------------------------------------------


def reference_step(tmp: str, family: str, shape) -> dict:
    """The reference's ``make_train_step(cfg, mesh, RULES_TRAIN)`` of
    ``family`` on a ``("data", "model")`` mesh of ``shape``; writes the new
    state as numpy and returns the metrics."""
    import jax.numpy as jnp
    from jax.sharding import Mesh

    from repro.models.sharding import RULES_TRAIN
    from repro.optim import adamw as jadamw
    from repro.train.step import make_train_step as jmake_train_step

    arch = FAMILIES[family]
    jcfg = base.ref_cfg(arch)
    with np.load(Path(tmp, f"params-{arch}.npz")) as f:
        flat = dict(f)
    n = int(np.prod(shape))
    mesh = Mesh(np.array(jax.devices()[:n]).reshape(shape), ("data", "model"))
    pshard = base.jmodel.param_shardings(jcfg, RULES_TRAIN, mesh)
    params = jax.tree_util.tree_map(lambda a, s: jax.device_put(jnp.asarray(a), s),
                                    unflatten(flat, "", base.jmodel.param_defs(jcfg)), pshard)
    step = jax.jit(jmake_train_step(jcfg, mesh, RULES_TRAIN, jadamw.AdamWConfig(**OPT)))
    p, o, m = step(params, jadamw.init(params),
                   {k: jnp.asarray(v) for k, v in global_batch(arch).items()})
    arrays = {}
    for part, tree in (("params", p), ("master", o.master), ("mu", o.mu), ("nu", o.nu)):
        for name, leaf in zip(flat_names(tree), jax.tree_util.tree_leaves(tree)):
            arrays[f"{part}/{name}"] = np.asarray(leaf, np.float32)
    np.savez(Path(tmp, f"ref-{mesh_id(shape)}-{family}.npz"), **arrays)
    return {k: float(v) for k, v in m.items()}


def reference(tmp: str, shape) -> None:
    """Every family's step on the mesh ``shape``, in a subprocess with 4
    forced host devices (one subprocess a mesh, side by side)."""
    out = {f"n_devices/{mesh_id(shape)}": len(jax.devices())}
    for family in FAMILIES:
        out[f"{mesh_id(shape)}/{family}"] = reference_step(tmp, family, shape)
    print(json.dumps(out))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both sides' runs, their subprocesses side by side, from the
    reference's initial parameters written here as numpy; the reference's
    one-device steps and the port's world-1 trainer in this process
    meanwhile."""
    tmp = tmp_path_factory.mktemp("train-ranks-tp")
    for arch in FAMILIES.values():
        jparams = base.jmodel.init_params(base.ref_cfg(arch), jax.random.PRNGKey(0))
        leaves = jax.tree_util.tree_leaves(jparams)
        np.savez(tmp / f"params-{arch}.npz",
                 **{n: np.asarray(a) for n, a in zip(flat_names(jparams), leaves)})
    port = _start(f"import test_torch_train_ranks_tp as t; t.main({str(tmp)!r})",
                  {"TRAIN_RANKS_PORT_ONLY": "1"})
    refs = [_start(f"import test_torch_train_ranks_tp as t; t.reference({str(tmp)!r}, {shape})",
                   {"XLA_FLAGS": "--xla_force_host_platform_device_count=4",
                    "JAX_PLATFORMS": "cpu"}) for shape in TP_MESHES]
    one = {f"1x1/{family}": reference_step(str(tmp), family, (1, 1))
           for family in ("dense", "hybrid", "ssm")}
    t = make_trainer(str(tmp / "w1"))
    init = state_arrays(t.params, t.opt_state)
    hist = t.run()
    ref = dict(one)
    for proc in refs:
        ref.update(_finish(proc))
    return {"tmp": tmp, "port": _finish(port), "ref": ref,
            "world_one": {"init": init, "history": hist}}


def _ranks(runs, shape) -> list:
    world = int(np.prod(shape))
    return [r for r in runs["port"][str(world)]]


# -- the step ---------------------------------------------------------------------


def test_the_reference_ran_on_four_forced_devices(runs):
    assert all(runs["ref"][f"n_devices/{mesh_id(shape)}"] == 4 for shape in TP_MESHES)
    for world in MESHES:
        ranks = runs["port"][str(world)]
        assert [r["world"] for r in ranks] == [world] * world
        for shape in MESHES[world]:
            coords = {tuple(r["meshes"][mesh_id(shape)]["coords"].values()) for r in ranks}
            assert len(coords) == world  # every rank its own coordinate
            assert {r["meshes"][mesh_id(shape)]["route"] for r in ranks} == {"gloo"}


@pytest.mark.parametrize("family", list(FAMILIES))
@pytest.mark.parametrize("shape", TP_MESHES, ids=mesh_id)
def test_one_step_matches_the_reference_on_the_same_mesh(runs, shape, family):
    want = runs["ref"][f"{mesh_id(shape)}/{family}"]
    for r in _ranks(runs, shape):
        got = r["meshes"][mesh_id(shape)]["steps"][family]
        assert got["loss"] == pytest.approx(want["loss"], rel=LOSS_TOL)
        assert got["grad_norm"] == pytest.approx(want["grad_norm"], rel=LOSS_TOL)
        assert got["lr"] == pytest.approx(want["lr"], rel=1e-6)
    tmp = runs["tmp"]
    gap, where = _worst_gap(_load(tmp / f"port-{mesh_id(shape)}-{family}.npz"),
                            _load(tmp / f"ref-{mesh_id(shape)}-{family}.npz"))
    assert gap <= STATE_TOL, (gap, where)


@pytest.mark.parametrize("family", ["dense", "hybrid", "ssm"])
@pytest.mark.parametrize("shape", TP_MESHES, ids=mesh_id)
def test_one_step_matches_the_references_one_device_step(runs, shape, family):
    want = runs["ref"][f"1x1/{family}"]
    for r in _ranks(runs, shape):
        got = r["meshes"][mesh_id(shape)]["steps"][family]
        assert got["loss"] == pytest.approx(want["loss"], rel=LOSS_TOL)
        assert got["grad_norm"] == pytest.approx(want["grad_norm"], rel=LOSS_TOL)
    tmp = runs["tmp"]
    gap, where = _worst_gap(_load(tmp / f"port-{mesh_id(shape)}-{family}.npz"),
                            _load(tmp / f"ref-1x1-{family}.npz"))
    assert gap <= STATE_TOL, (gap, where)


@pytest.mark.parametrize("shape", TP_MESHES, ids=mesh_id)
def test_every_rank_reports_the_same_metrics(runs, shape):
    for family in FAMILIES:
        assert len({(r["meshes"][mesh_id(shape)]["steps"][family]["loss"],
                     r["meshes"][mesh_id(shape)]["steps"][family]["grad_norm"])
                    for r in _ranks(runs, shape)}) == 1


@pytest.mark.parametrize("family", list(FAMILIES))
def test_the_same_bits_twice_on_two_by_two(runs, family):
    for r in _ranks(runs, (2, 2)):
        assert r["meshes"]["2x2"]["steps"][family]["same_bits_twice"]


@pytest.mark.parametrize("family", list(FAMILIES))
def test_a_model_axis_of_one_gives_the_data_parallel_bits(runs, family):
    for r in runs["port"]["2"]:
        assert r["data_parallel_bits"][family]


@pytest.mark.parametrize("family", list(FAMILIES))
@pytest.mark.parametrize("shape", TP_MESHES, ids=mesh_id)
def test_collective_bytes_equal_the_count(runs, shape, family):
    for r in _ranks(runs, shape):
        case = r["meshes"][mesh_id(shape)]["steps"][family]
        assert case["counters"]["host_staged"] == 0  # gloo on host tensors: nothing staged
        assert {k: case["counters"][k] for k in case["model"]} == case["model"]
        # the model axis moves activations in every family, and the
        # embedding's columns into the residual through an all-to-all
        assert case["model"]["all_to_all"] > 0 and case["model"]["reduce_scatter"] > 0


def test_the_count_needs_the_shape_on_a_model_axis():
    mesh = base._mesh_at((2, 2), 0)
    with pytest.raises(ValueError, match="global batch"):
        collective_bytes_per_step(port_cfg("repro-100m"), mesh)
    assert collective_bytes_per_step(port_cfg("repro-100m"), base._mesh_at((2, 1), 0)) == \
        collective_bytes_per_step(port_cfg("repro-100m"), base._mesh_at((2, 1), 0),
                                  tsharding.RULES_TRAIN, BATCH, SEQ)


# -- the trainer and its checkpoint ----------------------------------------------------------


def test_trainer_on_two_by_two_starts_from_the_world_of_ones_bits(runs):
    got = _load(runs["tmp"] / "trainer-init.npz")
    want = runs["world_one"]["init"]
    for k, v in got.items():
        assert np.array_equal(v, want[k]), k


def test_trainer_on_two_by_two_matches_the_world_of_one(runs):
    want = runs["world_one"]["history"]
    for r in runs["port"]["4"]:
        hist = r["trainer"]["history"]
        assert [h["step"] for h in hist] == list(range(TRAIN_STEPS))
        for h, w in zip(hist, want):
            assert h["loss"] == pytest.approx(w["loss"], rel=LOSS_TOL)
            assert h["grad_norm"] == pytest.approx(w["grad_norm"], rel=GNORM_TOL)
            assert h["all_to_all_bytes"] > 0 and h["reduce_scatter_bytes"] > 0


def test_the_two_by_two_checkpoint_restores_at_world_one_and_on_one_by_two(runs):
    tmp = runs["tmp"]
    final = _load(tmp / "trainer-final.npz")
    t = make_trainer(str(tmp / "w1-restore"))
    (p, o), step, _ = CheckpointManager(str(tmp / "trainer")).restore(
        (t.params, t.opt_state), device="cpu")
    assert step == TRAIN_STEPS == int(o.count)
    one = state_arrays(p, o)
    two = _load(tmp / "restore-1x2.npz")
    for k, v in final.items():
        assert np.array_equal(one[k], v), k
        assert np.array_equal(two[k], v), k
    cfg = port_cfg("repro-100m")
    for r in runs["port"]["2"]:
        assert r["restore"]["step"] == TRAIN_STEPS == r["restore"]["count"]
        # cut for (1, 2): lm_head's vocab columns over the model axis
        assert r["restore"]["lm_head_block"] == [cfg.d_model, cfg.padded_vocab // 2]
