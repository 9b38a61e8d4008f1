"""Math layer of the port: the paper's sparse Tucker decomposition in
PyTorch, the twin of ``repro.core``.

Modules mirror the reference's:
  coo.py          COO storage (Sec. III-A, Table I)
  ttm.py          dense TTM, module 1 (Sec. III-B, Alg. 3)
  kron.py         sparse Kron accumulation, module 2 (Sec. III-C, Alg. 4)
  qrp.py          QR with column pivoting, module 3 (Sec. III-D)
  hooi.py         the sweep machinery and the deprecated entry-point shims (the
                  public front end is repro_torch.tucker's plan/execute API)
  engine.py       sweep engines: the CUDA kernels or their plain versions,
                  and the sharded engine over a process group
  reconstruct.py  Eq. 7 reconstruction and error metrics
  distributed.py  sharded sparse HOOI over torch.distributed

The names below are the reference's re-exports, as far as the port has
them (the Kron-reuse functions come with ``use_kron_reuse``). As in the
reference, ``qrp`` and ``ttm`` here are the functions: reach their modules
through ``importlib.import_module("repro_torch.core.qrp")``.
"""
from repro_torch.core.coo import SparseCOO, fold_dense, unfold_dense
from repro_torch.core.distributed import hooi_sparse_distributed
from repro_torch.core.engine import (
    ENGINES,
    SweepEngine,
    available_engines,
    make_engine,
    resolve_engine,
)
from repro_torch.core.hooi import (
    HooiResult,
    effective_ranks,
    hooi_dense,
    hooi_sparse,
    init_factors,
    sparse_sweep,
    tucker_complete_dense,
)
from repro_torch.core.kron import kron_rows, sparse_ttm_chain
from repro_torch.core.qrp import factor_update, qrp, qrp_gram, qrp_householder, svd_factor
from repro_torch.core.reconstruct import (
    compression_ratio,
    reconstruct_at,
    reconstruct_dense,
    relative_error_dense,
)
from repro_torch.core.ttm import ttm, ttm_chain, ttm_unfolded

__all__ = [
    "ENGINES",
    "HooiResult",
    "SparseCOO",
    "SweepEngine",
    "available_engines",
    "compression_ratio",
    "effective_ranks",
    "factor_update",
    "fold_dense",
    "hooi_dense",
    "hooi_sparse",
    "hooi_sparse_distributed",
    "init_factors",
    "kron_rows",
    "make_engine",
    "qrp",
    "qrp_gram",
    "qrp_householder",
    "reconstruct_at",
    "reconstruct_dense",
    "relative_error_dense",
    "resolve_engine",
    "sparse_sweep",
    "sparse_ttm_chain",
    "svd_factor",
    "ttm",
    "ttm_chain",
    "ttm_unfolded",
    "tucker_complete_dense",
    "unfold_dense",
]
