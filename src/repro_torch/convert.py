"""Carry state across from the JAX package as numpy arrays.

``jax.random`` cannot be replayed in torch, so two runs that must start from
the same factors hand them over as numpy: ``np.asarray`` of the reference's
COO arrays and factor matrices goes in, the port's tensors come out.
"""
from __future__ import annotations

from typing import List, Sequence

import numpy as np
import torch

from repro_torch.core.coo import SparseCOO


def coo_from_numpy(indices, values, shape: Sequence[int], device="cpu") -> SparseCOO:
    """The port's COO from (nnz, N) indices and (nnz,) values."""
    return SparseCOO.from_parts(np.asarray(indices), np.asarray(values), shape,
                                device=torch.device(device))


def factors_from_numpy(factors: Sequence, device="cpu") -> List[torch.Tensor]:
    """The port's factor matrices from a list of (I_n, R_n) arrays."""
    return [torch.as_tensor(np.array(f), device=torch.device(device)) for f in factors]
