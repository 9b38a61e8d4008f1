"""TuckerSpec — the frozen problem description behind the plan/execute API.

Port of ``repro.tucker.spec``: the same fields, validation and rank clamp.
Values whose code is not ported yet (``shard``, ``snapshot``, ``autotune``,
``use_kron_reuse``) raise ``NotImplementedError`` naming their
``ROADMAP.md`` item; the JAX engine names raise ``ValueError``.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional, Sequence, Tuple

import torch

from repro_torch.core.engine import ENGINES, JAX_ENGINES
from repro_torch.core.hooi import effective_ranks
from repro_torch.base import unported
from repro_torch.kernels.kron_kernel import PRECISIONS

METHODS = ("svd", "householder", "gram")
ALGORITHMS = ("sparse", "dense", "complete")
PIPELINES = ("scan", "python")
DTYPES = ("auto", "float32", "float64")


def _canonical_dtype(dtype: Any) -> str:
    """"auto" (float32 factors, values as given) or a float dtype name."""
    if dtype is None or dtype == "auto":
        return "auto"
    name = str(dtype).replace("torch.", "")
    name = {"float": "float32", "double": "float64"}.get(name, name)
    if name not in DTYPES:
        raise ValueError(f"dtype must be one of {DTYPES}, got {dtype!r}")
    return name


@dataclasses.dataclass(frozen=True)
class TuckerSpec:
    """Frozen, validated description of one Tucker decomposition problem.

    Attributes:
      shape: dense shape (I_1, ..., I_N) of the input tensor.
      ranks: requested multilinear rank, clamped at construction to the
        representable fixpoint R_n <= min(I_n, prod_{t != n} R_t).
      method: factor update — 'householder' (paper QRP), 'gram' or 'svd'.
      engine: 'auto', 'cuda' or 'torch' (see ``repro_torch.core.engine``).
      pipeline: 'scan', the multi-sweep loop of ``core.hooi.run_sweeps``
        (the device's fit history read once), or 'python', the per-sweep
        loop (one read of the fit a sweep; the reference's benchmark
        baseline).
      n_iter: max ALS sweeps.
      tol: early-exit threshold on consecutive fit deltas (0 disables).
      dtype: 'auto' (float32 factors, values as given), 'float32' or
        'float64' (the CPU only).
      precision: 'fp32' or 'bf16_fp32acc' (bf16 operand loads and products
        in the two kernels, f32 sums).
      algorithm: 'sparse' (paper Alg. 2, COO input), 'dense' (Alg. 1,
        dense input) or 'complete' (EM completion, COO input).
      n_rounds: EM rounds for algorithm='complete' (ignored otherwise).
      autotune, use_kron_reuse, shard, snapshot: reference features that
        are not ported yet; only their defaults are accepted. (In the
        reference, autotune, shard and snapshot also need the sparse scan
        path.)
    """

    shape: Tuple[int, ...]
    ranks: Tuple[int, ...]
    method: str = "householder"
    engine: str = "auto"
    pipeline: str = "scan"
    n_iter: int = 5
    tol: float = 0.0
    dtype: str = "auto"
    precision: str = "fp32"
    autotune: bool = False
    use_kron_reuse: bool = False
    algorithm: str = "sparse"
    n_rounds: int = 10
    shard: Optional[Any] = None
    snapshot: Optional[Any] = None

    def __post_init__(self) -> None:
        shape = tuple(int(s) for s in self.shape)
        if not shape or any(s < 1 for s in shape):
            raise ValueError(f"shape must be positive, got {self.shape}")
        ranks = tuple(int(r) for r in self.ranks)
        if len(ranks) != len(shape):
            raise ValueError(f"ranks {ranks} and shape {shape} disagree on tensor order")
        if any(r < 1 for r in ranks):
            raise ValueError(f"ranks must be positive, got {self.ranks}")
        ranks = tuple(effective_ranks(shape, ranks))
        if self.method not in METHODS:
            raise ValueError(f"method must be one of {METHODS}, got {self.method!r}")
        if self.engine in JAX_ENGINES:
            raise ValueError(
                f"engine={self.engine!r} is a JAX engine of the repro package; "
                f"the PyTorch port's engines are {ENGINES}"
            )
        if self.engine not in ENGINES:
            raise ValueError(f"engine must be one of {ENGINES}, got {self.engine!r}")
        if self.pipeline not in PIPELINES:
            raise ValueError(f"pipeline must be one of {PIPELINES}, got {self.pipeline!r}")
        if self.algorithm not in ALGORITHMS:
            raise ValueError(f"algorithm must be one of {ALGORITHMS}, got {self.algorithm!r}")
        if int(self.n_iter) < 1:
            raise ValueError(f"n_iter must be >= 1, got {self.n_iter}")
        if int(self.n_rounds) < 1:
            raise ValueError(f"n_rounds must be >= 1, got {self.n_rounds}")
        if not (float(self.tol) >= 0.0):  # also rejects NaN
            raise ValueError(f"tol must be >= 0, got {self.tol}")
        if self.precision not in PRECISIONS:
            raise ValueError(f"precision must be one of {PRECISIONS}, got {self.precision!r}")
        if self.shard is not None:
            raise unported("shard", "queue 1, item 15: sharding")
        if self.snapshot is not None:
            raise unported("snapshot", "queue 1, item 12: snapshot and resume")
        if self.autotune:
            raise unported("autotune=True", "queue 1, item 14: kernel autotuning")
        if self.use_kron_reuse:
            raise unported("use_kron_reuse=True", "queue 1, item 7: Kron reuse")
        object.__setattr__(self, "shape", shape)
        object.__setattr__(self, "ranks", ranks)
        object.__setattr__(self, "n_iter", int(self.n_iter))
        object.__setattr__(self, "n_rounds", int(self.n_rounds))
        object.__setattr__(self, "tol", float(self.tol))
        object.__setattr__(self, "dtype", _canonical_dtype(self.dtype))

    @property
    def ndim(self) -> int:
        return len(self.shape)

    @property
    def supports_batched_dispatch(self) -> bool:
        """True when plans for this spec run ``TuckerPlan.batch`` as one
        batched sweep program (the micro-batching contract of
        ``repro_torch.serve.TuckerService``), the reference's rule: the
        multi-sweep scan pipeline over sparse COO input, fp32 (the batched
        program is fp32-only), without Kron reuse, sharding or snapshots.
        A prebuilt engine can still rule it out; that is decided at plan
        level (``TuckerPlan.supports_batched_dispatch``)."""
        return (
            self.algorithm == "sparse"
            and self.pipeline == "scan"
            and not self.use_kron_reuse
            and self.shard is None
            and self.snapshot is None
            and self.precision == "fp32"
        )

    def resolved_dtype(self) -> Optional[torch.dtype]:
        """The working dtype, or ``None`` for "auto"."""
        return None if self.dtype == "auto" else getattr(torch, self.dtype)


def spec_for(x: Any, ranks: Sequence[int], **kwargs) -> TuckerSpec:
    """A :class:`TuckerSpec` for tensor ``x``: sparse for a ``SparseCOO``,
    dense for anything else (a numpy array or a tensor)."""
    from repro_torch.core.coo import SparseCOO

    if isinstance(x, SparseCOO):
        kwargs.setdefault("algorithm", "sparse")
        shape = x.shape
    else:
        kwargs.setdefault("algorithm", "dense")
        shape = tuple(x.shape)
    return TuckerSpec(shape=tuple(shape), ranks=tuple(ranks), **kwargs)
