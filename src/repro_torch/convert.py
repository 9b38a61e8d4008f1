"""Carry state across from the JAX package as numpy arrays.

``jax.random`` cannot be replayed in torch, so two runs that must start from
the same factors or weights hand them over as numpy: ``np.asarray`` of the
reference's COO arrays, factor matrices, LM parameters or caches goes in,
the port's tensors come out.
"""
from __future__ import annotations

from typing import Any, List, Sequence

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.coo import SparseCOO
from repro_torch.models.mamba2 import SsmState
from repro_torch.models.model import leaf_dtype, param_defs
from repro_torch.optim.adamw import OptState


def coo_from_numpy(indices, values, shape: Sequence[int], device="cpu") -> SparseCOO:
    """The port's COO from (nnz, N) indices and (nnz,) values."""
    return SparseCOO.from_parts(np.asarray(indices), np.asarray(values), shape,
                                device=torch.device(device))


def factors_from_numpy(factors: Sequence, device="cpu") -> List[torch.Tensor]:
    """The port's factor matrices from a list of (I_n, R_n) arrays."""
    return [torch.as_tensor(np.array(f), device=torch.device(device)) for f in factors]


def tensor_from_numpy(a, device="cpu") -> torch.Tensor:
    """One array as a tensor. bf16 arrives as ``ml_dtypes.bfloat16``, which
    torch does not take: it becomes ``torch.bfloat16`` with the same bits."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return bf16_from_bits(a.view(np.uint16), device)
    return torch.from_numpy(np.array(a)).to(device)


def bf16_from_bits(bits, device="cpu") -> torch.Tensor:
    """``torch.bfloat16`` from ``uint16`` bit patterns, the reference's
    storage of bf16 in its caches (``pack_bf16``)."""
    bits = np.asarray(bits)
    if bits.dtype != np.uint16:
        raise ValueError(f"bf16 bit patterns must be uint16, got {bits.dtype}")
    return torch.from_numpy(bits.copy()).view(torch.bfloat16).to(device)


def _block(t: torch.Tensor, sharding, spec) -> torch.Tensor:
    """``t`` whole, or this rank's block of it when ``sharding = (mesh,
    specs)`` was given (``spec`` the leaf's own)."""
    if sharding is None:
        return t
    return sharding[0].local_block(t, spec).clone()


def lm_params_from_numpy(tree, cfg: ModelConfig, device="cpu", sharding=None):
    """The port's LM parameters from the reference's parameter pytree as
    numpy (``jax.tree_util.tree_map(np.asarray, params)``), for any family's
    tree (``models.model.param_defs``), checked leaf by leaf against the
    port's schema for ``cfg`` (keys, shapes, dtypes). With ``sharding =
    (mesh, specs)`` (``models.model.param_pspecs``) each leaf comes back as
    this rank's block."""

    def walk(defs, node, spec, path):
        if isinstance(defs, dict):
            return {k: walk(d, node[k], spec and spec[k], path + (k,))
                    for k, d in defs.items()}
        t = tensor_from_numpy(node, device)
        if tuple(t.shape) != defs.shape or t.dtype != leaf_dtype(cfg, defs):
            raise ValueError(f"{'/'.join(path)}: {tuple(t.shape)} {t.dtype}, the schema "
                             f"says {defs.shape} {leaf_dtype(cfg, defs)}")
        return _block(t, sharding, spec)

    return walk(param_defs(cfg), tree, sharding and sharding[1], ())


def opt_state_from_numpy(tree, cfg: ModelConfig, device="cpu", sharding=None) -> OptState:
    """The port's :class:`OptState` from the reference's ``OptState`` as numpy
    (``jax.tree_util.tree_map(np.asarray, opt_state)``): master, mu and nu
    checked leaf by leaf against the schema's shapes, in f32, and the int32
    count. With ``sharding = (mesh, specs)`` (the ZeRO specs,
    ``adamw.opt_pspecs(...).master``) each leaf comes back as this rank's
    block."""
    master, mu, nu, count = tree

    def walk(defs, node, spec, path):
        if isinstance(defs, dict):
            return {k: walk(d, node[k], spec and spec[k], path + (k,))
                    for k, d in defs.items()}
        t = tensor_from_numpy(node, device)
        if tuple(t.shape) != defs.shape or t.dtype != torch.float32:
            raise ValueError(f"{'/'.join(path)}: {tuple(t.shape)} {t.dtype}, want "
                             f"{defs.shape} torch.float32")
        return _block(t, sharding, spec)

    defs, specs = param_defs(cfg), sharding and sharding[1]
    return OptState(*(walk(defs, part, specs, (name,)) for name, part in
                      (("master", master), ("mu", mu), ("nu", nu))),
                    count=tensor_from_numpy(np.asarray(count, np.int32), device))


def lm_cache_from_numpy(cache: Any, device="cpu", sharding=None):
    """The port's LM cache from the reference's cache as numpy, for every
    ported family: the attention families' ``{"k", "v"}``, the ``ssm``
    family's ``SsmState(conv_x, conv_b, conv_c, h)`` stacked over the
    layers, or the ``hybrid`` family's ``{"ssm": SsmState, "attn": {"k",
    "v"}}``; every entry but ``h`` (f32) as ``uint16`` bf16 bit patterns.
    With ``sharding = (mesh, specs)`` (``specs`` a tree of the cache's
    structure, a spec a leaf: ``models.model.cache_pspecs``) each leaf comes
    back as this rank's block: a decode cache on a mesh is cut by rows over
    the batch axes, its attention entries by positions over the model axes
    (``serve.engine.Engine._pad_cache``), an ``SsmState`` (stacked, or the
    hybrid's ``"ssm"``) by channels and heads over them."""
    specs = sharding and sharding[1]

    def leaf(t, spec):
        return t if spec is None else _block(t, sharding, spec)

    def kv(c, sp):
        return {n: leaf(bf16_from_bits(c[n], device), sp and sp[n]) for n in ("k", "v")}

    def states(c, sp):
        conv_x, conv_b, conv_c, h = c
        sp = sp or (None,) * 4
        return SsmState(*(leaf(bf16_from_bits(a, device), s_) for a, s_ in
                          zip((conv_x, conv_b, conv_c), sp[:3])),
                        h=leaf(tensor_from_numpy(h, device), sp[3]))

    if isinstance(cache, dict) and "attn" in cache:
        return {"ssm": states(cache["ssm"], specs and specs["ssm"]),
                "attn": kv(cache["attn"], specs and specs["attn"])}
    if isinstance(cache, dict):
        return kv(cache, specs)
    return states(cache, specs)
