"""Reconstruction utilities for Tucker results (Eq. 7)."""
from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from repro_torch.core.ttm import ttm_chain


def reconstruct_dense(core: torch.Tensor, factors: Sequence[torch.Tensor]) -> torch.Tensor:
    """Xhat = G x_1 U_1 x_2 U_2 ... x_N U_N (Eq. 7)."""
    return ttm_chain(core, list(factors), transpose=False)


def compression_ratio(shape: Sequence[int], ranks: Sequence[int],
                      include_factors: bool = True) -> float:
    """Dense storage / Tucker storage; ``include_factors=False`` counts the
    core only (the paper's angiogram convention)."""
    dense = float(np.prod(shape))
    tucker = float(np.prod(ranks))
    if include_factors:
        tucker += float(sum(i * r for i, r in zip(shape, ranks)))
    return dense / tucker
