"""Snapshot and resume state of the segmented sweep loop.

Port of ``repro.tucker.snapshot``, with its format: after every
``SnapshotSpec.every_n_sweeps`` sweeps the whole carry (factors, core, the
convergence state, the fit history so far) is copied to the host once and
written atomically through
:class:`repro_torch.checkpoint.manager.CheckpointManager`.
:func:`load_snapshot` reverses it with no state in the process: the manifest
records every leaf's shape and dtype, so the ``like`` tree that
:meth:`CheckpointManager.restore` wants is rebuilt from the checkpoint
itself. A snapshot written by either package loads in the other.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from repro_torch.checkpoint.manager import CheckpointManager

__all__ = [
    "SNAPSHOT_FORMAT",
    "SnapshotState",
    "check_compatible",
    "load_snapshot",
    "save_snapshot",
]

SNAPSHOT_FORMAT = 1


@dataclasses.dataclass
class SnapshotState:
    """One restored snapshot (host numpy state).

    Attributes:
      factors: the factor matrices U_n after ``sweeps_done`` sweeps.
      core: the core after ``sweeps_done`` sweeps (all zeros when the
        snapshot predates the first sweep).
      prev_err: the relative error of the last completed sweep (+inf before
        the first): the ``tol`` rule compares against it on resume, so the
        resumed run converges as the uninterrupted one does.
      done: whether the ``tol`` early exit had already fired.
      sweeps_done: completed ALS sweeps.
      fit_history: the relative errors of the completed sweeps.
      meta: the manifest's ``extra`` (spec fields, snapshot interval,
        format version).
      step: the checkpoint step this state was loaded from.
    """

    factors: List[np.ndarray]
    core: np.ndarray
    prev_err: float
    done: bool
    sweeps_done: int
    fit_history: List[float]
    meta: Dict
    step: int


def _spec_meta(spec: Any) -> Dict:
    """The spec fields a resume must agree on, and context worth keeping."""
    snap = spec.snapshot
    return {
        "shape": list(spec.shape),
        "ranks": list(spec.ranks),
        "method": spec.method,
        "algorithm": spec.algorithm,
        "n_iter": int(spec.n_iter),
        "tol": float(spec.tol),
        "dtype": spec.dtype,
        "every_n_sweeps": (int(snap.every_n_sweeps)
                           if snap and snap.every_n_sweeps is not None else None),
        "every_seconds": (float(snap.every_seconds)
                          if snap and snap.every_seconds is not None else None),
    }


def _to_host(tensors: List[Any]) -> List[Any]:
    """``tensors`` on the host: the device tensors of each dtype in one
    copy (a sweep's carry is a core and N small factors), host arrays as
    they are."""
    out = list(tensors)
    on_device = [i for i, t in enumerate(tensors)
                 if isinstance(t, torch.Tensor) and t.device.type != "cpu"]
    for dt in {tensors[i].dtype for i in on_device}:
        ids = [i for i in on_device if tensors[i].dtype == dt]
        flat = torch.cat([tensors[i].reshape(-1) for i in ids]).cpu()
        for i, part in zip(ids, torch.split(flat, [tensors[i].numel() for i in ids])):
            out[i] = part.view(tensors[i].shape)
    return out


def save_snapshot(mgr: CheckpointManager, spec: Any, *, factors: Any, core: Any,
                  prev_err: Any, done: Any, sweeps_done: int, fit_history: Any,
                  mesh_fp: Optional[str] = None) -> str:
    """Write one snapshot at checkpoint step ``sweeps_done``: the tensors
    through the manager's atomic npz path (each copied to the host once),
    the sweep count, fit history and spec fields in the manifest's
    ``extra``. ``mesh_fp`` stays ``None`` until the port shards."""
    host = _to_host([core] + list(factors))
    state = {
        "core": host[0],
        "done": np.asarray(bool(done)),
        "factors": host[1:],
        "prev_err": np.asarray(float(prev_err), dtype=np.float32),
    }
    extra = {
        "format": SNAPSHOT_FORMAT,
        "kind": "tucker-sweep",
        "sweeps_done": int(sweeps_done),
        "fit_history": [float(h) for h in fit_history],
        "spec": _spec_meta(spec),
        "mesh": mesh_fp,
    }
    return mgr.save(int(sweeps_done), state, extra=extra)


def load_snapshot(directory: str, step: Optional[int] = None) -> SnapshotState:
    """The latest (or the given step's) snapshot in ``directory``, as host
    numpy state, with no prior knowledge of shapes or dtypes."""
    mgr = CheckpointManager(directory)
    manifest = mgr.read_manifest(step)
    extra = manifest.get("extra", {})
    if extra.get("kind") != "tucker-sweep":
        raise ValueError(
            f"checkpoint step {manifest['step']} in {directory} is not a "
            f"tucker sweep snapshot (kind={extra.get('kind')!r})"
        )
    by_name = {leaf["name"]: leaf for leaf in manifest["leaves"]}

    def spec_of(name: str):
        leaf = by_name[name]
        dt = torch.bfloat16 if leaf["dtype"] == "bfloat16" else getattr(torch, leaf["dtype"])
        return (tuple(leaf["shape"]), dt)

    n_factors = sum(1 for n in by_name if n.startswith("factors/"))
    like = {
        "core": spec_of("core"),
        "done": spec_of("done"),
        "factors": [spec_of(f"factors/{i}") for i in range(n_factors)],
        "prev_err": spec_of("prev_err"),
    }
    restored, step, extra = mgr.restore(like, step=manifest["step"])
    return SnapshotState(
        factors=[f.numpy() for f in restored["factors"]],
        core=restored["core"].numpy(),
        prev_err=float(restored["prev_err"]),
        done=bool(restored["done"]),
        sweeps_done=int(extra["sweeps_done"]),
        fit_history=[float(h) for h in extra.get("fit_history", [])],
        meta=extra,
        step=step,
    )


def check_compatible(spec: Any, state: SnapshotState) -> None:
    """A resume must describe the problem the snapshot came from: shape,
    ranks, method and algorithm decide the carry's shapes and the sweep's
    arithmetic. ``n_iter`` (a longer budget), ``tol`` and the engine may
    change across a resume."""
    want = state.meta.get("spec", {})
    for field in ("shape", "ranks"):
        have = list(getattr(spec, field))
        if want.get(field) is not None and list(want[field]) != have:
            raise ValueError(
                f"cannot resume: snapshot was written for {field}="
                f"{tuple(want[field])}, the spec has {tuple(have)}"
            )
    for field in ("method", "algorithm"):
        have = getattr(spec, field)
        if want.get(field) is not None and want[field] != have:
            raise ValueError(
                f"cannot resume: snapshot was written for {field}="
                f"{want[field]!r}, the spec has {have!r}"
            )
    if int(state.sweeps_done) > int(spec.n_iter) and not state.done:
        raise ValueError(
            f"cannot resume: snapshot already has {state.sweeps_done} sweeps "
            f"but the spec budgets n_iter={spec.n_iter}"
        )
