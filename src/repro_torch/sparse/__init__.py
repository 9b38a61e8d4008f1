"""Sparse-tensor generators, the paper's Table V tensors, the per-mode
sweep schedule and the Kron-reuse dedup."""
from repro_torch.sparse.datasets import (
    PAPER_DATASETS,
    amazon_like,
    angiogram_like,
    matmul_tensor,
    nell2_like,
)
from repro_torch.sparse.generators import low_rank_sparse_tensor, random_sparse_tensor
from repro_torch.sparse.layout import (
    DeviceSchedule,
    KronReusePlan,
    SortedCOO,
    build_kron_reuse,
    build_mode_layout,
    build_schedule,
    layout_padding_fraction,
    visited_row_mask,
)
