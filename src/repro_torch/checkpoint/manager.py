"""Checkpoint manager: one npz of leaves plus a JSON manifest per step,
written atomically.

Port of ``repro.checkpoint.manager`` with the same on-disk format, so that a
checkpoint written by either package restores in the other:

  <dir>/step_00000042/
    manifest.json     {"step", "leaves": [{"name", "key", "shape", "dtype"}],
                       "extra"}
    shard_00000.npz   the leaves under keys leaf_00000, leaf_00001, ...

Leaf names are the reference's: a tree of dicts (keys sorted), lists,
tuples and ``NamedTuple``s flattened depth first, the keys, indices and
field names on the path joined by "/" ("factors/0", "1/master/embed/table"
for the ``(params, OptState)`` of a trainer). A bfloat16 leaf is stored as its uint16 bits with the
logical dtype "bfloat16" (npz has no bfloat16). A save goes to
``step_X.tmp`` and is renamed into place, so a reader never sees half a
step; a manager sweeps the stale ``.tmp`` directories a crashed save left,
and keeps the newest ``keep`` steps.
"""
from __future__ import annotations

import dataclasses
import json
import shutil
from pathlib import Path
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

__all__ = ["CheckpointManager"]


def _is_spec(x: Any) -> bool:
    """A ``(shape, dtype)`` leaf of a ``like`` tree: the shape and dtype of a
    tensor to restore, with no data."""
    return (isinstance(x, tuple) and len(x) == 2 and isinstance(x[1], torch.dtype)
            and isinstance(x[0], (tuple, list, torch.Size)))


def _is_namedtuple(x: Any) -> bool:
    return isinstance(x, tuple) and hasattr(type(x), "_fields")


def _flatten_with_names(tree: Any, prefix: str = "") -> List[Tuple[str, Any]]:
    """(name, leaf) pairs of ``tree`` in the reference's order: dict keys
    sorted, sequence items in order, a ``NamedTuple``'s fields in order
    under their names (as ``jax.tree_util`` names them), ``None`` holding
    no leaf."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        items = [(str(k), tree[k]) for k in sorted(tree)]
    elif _is_namedtuple(tree):
        items = list(zip(type(tree)._fields, tree))
    elif isinstance(tree, (list, tuple)) and not _is_spec(tree):
        items = [(str(i), v) for i, v in enumerate(tree)]
    else:
        return [(prefix, tree)]
    out = []
    for key, sub in items:
        out.extend(_flatten_with_names(sub, f"{prefix}/{key}" if prefix else key))
    return out


def _unflatten(like: Any, leaves: List[Any]) -> Any:
    """``like`` with its leaves replaced, in :func:`_flatten_with_names`
    order, by ``leaves`` (consumed from the front)."""
    if like is None:
        return None
    if isinstance(like, dict):
        rebuilt = {k: _unflatten(like[k], leaves) for k in sorted(like)}
        return {k: rebuilt[k] for k in like}
    if isinstance(like, (list, tuple)) and not _is_spec(like):
        items = [_unflatten(v, leaves) for v in like]
        if _is_namedtuple(like):  # its constructor takes the fields one by one
            return type(like)(*items)
        return type(like)(items) if isinstance(like, tuple) else items
    return leaves.pop(0)


def _dtype_name(dtype: Any) -> str:
    """The numpy-style name of a torch or numpy dtype ("float32", "bool")."""
    if isinstance(dtype, torch.dtype):
        return str(dtype).replace("torch.", "")
    return np.dtype(dtype).name


def _to_numpy(leaf: Any) -> Tuple[np.ndarray, str]:
    """(array to store, logical dtype name) of one leaf."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:  # npz has no bfloat16: store the bits
            return t.contiguous().view(torch.int16).numpy().view(np.uint16), "bfloat16"
        return t.numpy(), _dtype_name(t.dtype)
    arr = np.asarray(leaf)
    name = arr.dtype.name
    if name == "bfloat16":  # an ml_dtypes array handed in from elsewhere
        return arr.view(np.uint16), "bfloat16"
    return arr, name


def _from_numpy(arr: np.ndarray, logical: str) -> torch.Tensor:
    if logical == "bfloat16":
        return torch.from_numpy(np.ascontiguousarray(arr).view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(np.ascontiguousarray(arr))


@dataclasses.dataclass
class CheckpointManager:
    directory: str
    keep: int = 3

    def __post_init__(self):
        root = Path(self.directory)
        root.mkdir(parents=True, exist_ok=True)
        # a crashed save leaves step_X.tmp behind, which nothing renames or
        # collects: sweep them here before they accumulate
        for stale in root.glob("step_*.tmp"):
            if stale.is_dir():
                shutil.rmtree(stale, ignore_errors=True)

    # -- write ------------------------------------------------------------
    def save(self, step: int, state: Any, extra: Optional[Dict] = None) -> str:
        """Write ``state`` (a tree of tensors or arrays) as checkpoint
        ``step``, atomically; returns the step's directory."""
        final = Path(self.directory) / f"step_{step:08d}"
        tmp = Path(str(final) + ".tmp")
        if tmp.exists():
            shutil.rmtree(tmp)
        tmp.mkdir(parents=True)
        arrays = {}
        manifest = {"step": step, "leaves": [], "extra": extra or {}}
        for i, (name, leaf) in enumerate(_flatten_with_names(state)):
            arr, logical = _to_numpy(leaf)
            key = f"leaf_{i:05d}"
            arrays[key] = arr
            manifest["leaves"].append(
                {"name": name, "key": key, "shape": list(arr.shape), "dtype": logical})
        np.savez(tmp / "shard_00000.npz", **arrays)
        (tmp / "manifest.json").write_text(json.dumps(manifest))
        if final.exists():
            shutil.rmtree(final)
        tmp.rename(final)
        self._gc()
        return str(final)

    # -- read -------------------------------------------------------------
    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def all_steps(self) -> List[int]:
        out = []
        for p in Path(self.directory).glob("step_*"):
            if p.is_dir() and not p.name.endswith(".tmp"):
                try:
                    out.append(int(p.name.split("_")[1]))
                except (IndexError, ValueError):
                    continue
        return sorted(out)

    def read_manifest(self, step: Optional[int] = None) -> Dict:
        """The manifest of ``step`` (default: the latest): leaf names,
        shapes and dtypes and the saver's ``extra``, with no array read."""
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {self.directory}")
        d = Path(self.directory) / f"step_{step:08d}"
        return json.loads((d / "manifest.json").read_text())

    def restore(self, like: Any, step: Optional[int] = None, device=None,
                shardings: Optional[Any] = None) -> Tuple[Any, int, Dict]:
        """Restore checkpoint ``step`` (default: the latest) into the
        structure of ``like``: a tree of tensors, or of ``(shape, dtype)``
        specs. Each leaf comes back as a tensor of the like leaf's dtype
        (converted through float32 when the stored dtype differs), on
        ``device`` (the CPU by default). Returns ``(tree, step, extra)``; a
        leaf of ``like`` that the checkpoint lacks raises ``KeyError``.

        ``shardings``: a tree of the same structure whose leaves are
        :class:`~repro_torch.models.sharding.NamedSharding` (or None) on the
        *current* mesh: each stored leaf, whole whatever world wrote it, is
        cut to this rank's block of its spec along every dim the spec cuts
        (a ``("data", "model")`` spec on both; the elastic reshard)."""
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {self.directory}")
        d = Path(self.directory) / f"step_{step:08d}"
        manifest = json.loads((d / "manifest.json").read_text())
        by_name = {}
        # the archive's handle closes here: every array is read in this block
        with np.load(d / "shard_00000.npz") as data:
            for leaf in manifest["leaves"]:
                by_name[leaf["name"]] = _from_numpy(data[leaf["key"]], leaf["dtype"])
        cuts = dict(_flatten_with_names(shardings)) if shardings is not None else {}
        leaves = []
        for name, leaf in _flatten_with_names(like):
            if name not in by_name:
                raise KeyError(f"checkpoint missing leaf {name}")
            t = by_name[name]
            if cuts.get(name) is not None:
                t = cuts[name].local(t).clone()
            want = leaf[1] if _is_spec(leaf) else getattr(leaf, "dtype", t.dtype)
            if not isinstance(want, torch.dtype):
                want = getattr(torch, _dtype_name(want))
            if t.dtype != want:
                t = t.to(torch.float32).to(want)
            leaves.append(t.to(device) if device is not None else t)
        return _unflatten(like, leaves), step, manifest.get("extra", {})

    def _gc(self):
        steps = self.all_steps()
        for s in steps[: -self.keep]:
            shutil.rmtree(Path(self.directory) / f"step_{s:08d}", ignore_errors=True)
