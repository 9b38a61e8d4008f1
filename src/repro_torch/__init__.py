"""repro_torch — the PyTorch/CUDA port of ``repro``: sparse Tucker (HOOI)
and the LM serving path of the ``hybrid`` family (Zamba2).

The same plan/execute front-end as the JAX package, running on an NVIDIA
card by default:

    from repro_torch import tucker

    res = tucker.decompose(coo, (16, 16, 16), n_iter=5)   # device="cuda"
    res = tucker.decompose(coo, (16, 16, 16), device="cpu")

the same micro-batching decomposition service
(``repro_torch.serve.TuckerService``: each flush of k requests runs as one
batched sweep program) and the same LM serving engine
(``repro_torch.serve.engine.Engine``, greedy ``generate``). On a CUDA device
the hot loops run on hand-written CUDA kernels (``kernels/csrc``); on the
CPU the same code path runs their plain PyTorch versions. The package
imports ``torch`` and ``numpy`` only.
"""
from repro_torch import tucker
from repro_torch.core.coo import SparseCOO
from repro_torch.tucker import (
    ShardSpec,
    TuckerPlan,
    TuckerResult,
    TuckerSpec,
    decompose,
    spec_for,
)

__all__ = [
    "ShardSpec",
    "SparseCOO",
    "TuckerPlan",
    "TuckerResult",
    "TuckerSpec",
    "decompose",
    "spec_for",
    "tucker",
]
