"""TuckerSpec — the frozen problem description behind the plan/execute API.

Port of ``repro.tucker.spec``: the same fields, validation and rank clamp,
:class:`ShardSpec` and :class:`SnapshotSpec`; the JAX engine names raise
``ValueError``.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional, Sequence, Tuple

import torch

from repro_torch.core.engine import ENGINES, JAX_ENGINES
from repro_torch.core.hooi import effective_ranks
from repro_torch.kernels.kron_kernel import PRECISIONS

METHODS = ("svd", "householder", "gram")
ALGORITHMS = ("sparse", "dense", "complete")
PIPELINES = ("scan", "python")
DTYPES = ("auto", "float32", "float64")
FACTOR_POLICIES = ("replicated",)


@dataclasses.dataclass(frozen=True)
class ShardSpec:
    """The sharded-execution axis of a problem: the nonzeros split across
    ``num_devices`` ranks of a ``torch.distributed`` group.

    The paper's hybrid split as data parallelism: each rank runs the
    nnz-scaling Kron accumulation on its contiguous slice of the nonzeros
    (padded to an even :func:`repro_torch.sparse.layout.shard_pad_nnz`
    multiple), one all-reduce per mode per sweep sums the partial
    unfoldings, and the small factor update runs replicated on every rank.
    Hashable, so it rides inside :class:`TuckerSpec` and keys the plan
    cache.

    Attributes:
      num_devices: ranks the nonzeros shard over; it must equal the
        group's world size (``torchrun --nproc-per-node=N``, or
        ``init_process_group(..., world_size=N)``). 1 runs without a group.
      axis: the name of the nonzero axis (it enters the mesh fingerprint).
      factor_policy: how factors are laid out across the ranks. Only
        'replicated' exists (they are small: I_n x R_n). Rank 0's initial
        factors are broadcast once a call; the factor update then gives
        every rank the same bits, so the sweeps broadcast nothing.
    """

    num_devices: int
    axis: str = "nnz"
    factor_policy: str = "replicated"

    def __post_init__(self) -> None:
        if int(self.num_devices) < 1:
            raise ValueError(f"num_devices must be >= 1, got {self.num_devices}")
        if not self.axis or not isinstance(self.axis, str):
            raise ValueError(f"axis must be a non-empty string, got {self.axis!r}")
        if self.factor_policy not in FACTOR_POLICIES:
            raise ValueError(
                f"factor_policy must be one of {FACTOR_POLICIES}, got {self.factor_policy!r}"
            )
        object.__setattr__(self, "num_devices", int(self.num_devices))


@dataclasses.dataclass(frozen=True)
class SnapshotSpec:
    """The fault-tolerance axis of a problem: snapshot the sweep carry every
    ``every_n_sweeps`` ALS sweeps, so that a job that dies resumes from its
    latest snapshot (``tucker.resume``) instead of starting over.

    The sweeps run in segments of ``segment_len`` sweeps
    (``core.hooi.run_segment``, the same per-sweep operations as the
    unsegmented loop); after each segment the carry (factors, core,
    convergence state) is copied to the host once and may be written
    atomically through
    :class:`repro_torch.checkpoint.manager.CheckpointManager`. Hashable, so
    it rides inside :class:`TuckerSpec` and keys the plan cache.

    The cadence is sweep-count based (``every_n_sweeps``), wall-clock based
    (``every_seconds``), or both: with ``every_seconds`` the loop still runs
    segments of ``segment_len`` sweeps but writes a snapshot at a boundary
    only once the interval has passed since the last write. The initial
    (step-0) and final snapshots are always written. At least one cadence
    must be set.

    Attributes:
      every_n_sweeps: sweeps per segment, or None for a wall-clock cadence.
      directory: checkpoint root, one job per directory (two jobs in one
        directory would interleave their steps).
      every_seconds: least seconds between two writes, or None for a
        sweep-count cadence; 0.0 writes at every boundary.
      keep: snapshots kept (older ones are removed).
      max_retries: retries of a segment that fails with a transient
        ``RuntimeError`` (``runtime.fault_tolerance.run_with_retries``); 0
        fails at once and relies on resume.
      retry_backoff_s: base of the exponential retry backoff.
    """

    every_n_sweeps: Optional[int] = None
    directory: str = ""
    every_seconds: Optional[float] = None
    keep: int = 3
    max_retries: int = 0
    retry_backoff_s: float = 0.05

    @property
    def segment_len(self) -> int:
        """Sweeps per segment: ``every_n_sweeps`` when set, else 1 (the
        wall-clock cadence then decides at each boundary whether to write)."""
        return self.every_n_sweeps if self.every_n_sweeps is not None else 1

    def __post_init__(self) -> None:
        if self.every_n_sweeps is None and self.every_seconds is None:
            raise ValueError(
                "SnapshotSpec needs a cadence: set every_n_sweeps, every_seconds, or both")
        if self.every_n_sweeps is not None and int(self.every_n_sweeps) < 1:
            raise ValueError(f"every_n_sweeps must be >= 1, got {self.every_n_sweeps}")
        if self.every_seconds is not None and not (float(self.every_seconds) >= 0.0):
            raise ValueError(f"every_seconds must be >= 0, got {self.every_seconds}")
        if not self.directory or not isinstance(self.directory, str):
            raise ValueError(f"directory must be a non-empty string, got {self.directory!r}")
        if int(self.keep) < 1:
            raise ValueError(f"keep must be >= 1, got {self.keep}")
        if int(self.max_retries) < 0:
            raise ValueError(f"max_retries must be >= 0, got {self.max_retries}")
        if not (float(self.retry_backoff_s) >= 0.0):  # also rejects NaN
            raise ValueError(f"retry_backoff_s must be >= 0, got {self.retry_backoff_s}")
        if self.every_n_sweeps is not None:
            object.__setattr__(self, "every_n_sweeps", int(self.every_n_sweeps))
        if self.every_seconds is not None:
            object.__setattr__(self, "every_seconds", float(self.every_seconds))
        object.__setattr__(self, "keep", int(self.keep))
        object.__setattr__(self, "max_retries", int(self.max_retries))
        object.__setattr__(self, "retry_backoff_s", float(self.retry_backoff_s))


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
      autotune: search the sweep kernels' launch parameters
        (``repro_torch.kernels.autotune.BlockConfig``: the schedule's bn and
        bi, kernels 1 and 5's row split, the split or fused core update) at
        the plan's first execution, through the on-disk tuning table (a
        warm entry costs no search). Needs the sparse algorithm.
      algorithm: 'sparse' (paper Alg. 2, COO input), 'dense' (Alg. 1,
        dense input) or 'complete' (EM completion, COO input).
      n_rounds: EM rounds for algorithm='complete' (ignored otherwise).
      shard: a :class:`ShardSpec` to split the nonzeros across the ranks of
        a process group (one all-reduce per mode per sweep), or None. Needs
        the sparse algorithm on the scan pipeline in fp32, without Kron
        reuse. Each rank runs the resolved engine on its slice: the CUDA
        kernels on the card, their plain versions on the CPU.
      snapshot: a :class:`SnapshotSpec` to run the sweeps in segments with
        the carry checkpointed (resumable through ``tucker.resume``), or
        None. Needs the sparse algorithm on the scan pipeline.
      use_kron_reuse: the paper's Sec. III-C Kron-row dedup (each distinct
        non-mode coordinate tuple's Kronecker row computed once), honoured
        on the torch engine and ignored on ``cuda``, as the reference
        honours it on XLA and ignores it on Pallas
        (``tucker.engine_for_spec``). Not with ``shard``.
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
    shard: Optional[ShardSpec] = None
    snapshot: Optional[SnapshotSpec] = None

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
        if self.autotune and self.algorithm != "sparse":
            raise ValueError(
                "autotune requires algorithm='sparse' (only the sparse sweep "
                "kernels have tunable block shapes)"
            )
        if self.shard is not None:
            if not isinstance(self.shard, ShardSpec):
                raise TypeError(
                    f"shard must be a ShardSpec or None, got {type(self.shard).__name__}"
                )
            if self.algorithm != "sparse":
                raise ValueError(
                    f"shard requires algorithm='sparse' (only COO nonzeros have an "
                    f"nnz axis to shard), got {self.algorithm!r}"
                )
            if self.pipeline != "scan":
                raise ValueError(
                    "shard requires pipeline='scan': the sharded path is the "
                    "multi-sweep loop with one all-reduce per mode"
                )
            if self.use_kron_reuse:
                raise ValueError(
                    "shard is incompatible with use_kron_reuse: the dedup plan is a "
                    "per-tensor host artifact that cannot shard along the nnz axis"
                )
            if self.precision != "fp32":
                raise ValueError(
                    "shard requires precision='fp32': the sharded path runs at full "
                    "working precision (mixed precision is a kernel-engine axis)"
                )
        if self.snapshot is not None:
            if not isinstance(self.snapshot, SnapshotSpec):
                raise TypeError(
                    f"snapshot must be a SnapshotSpec or None, got "
                    f"{type(self.snapshot).__name__}"
                )
            if self.algorithm != "sparse":
                raise ValueError(
                    f"snapshot requires algorithm='sparse' (only the sweep loop "
                    f"has a resumable carry), got {self.algorithm!r}"
                )
            if self.pipeline != "scan":
                raise ValueError(
                    "snapshot requires pipeline='scan': the snapshot layer runs "
                    "the multi-sweep loop in resumable segments"
                )
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
