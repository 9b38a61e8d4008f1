"""The paper's four real-world tensors (Section IV-C, Table V), rebuilt at
the paper's published shapes and sparsities.

Port of ``repro.sparse.datasets``. The Amazon and NELL-2 dumps are not in
the repository: those two are synthesized with the published shape,
sparsity, value distribution and sweep count, which fix every cost the
paper reports (nnz, Kron, QRP and TTM calls, unfolding sizes). The
parallel-matmul tensor is exact (it follows from its definition), and the
retinal angiogram is a synthetic 130x150 vessel-like image at the paper's
0.18 density. Every function here draws in numpy first, with the reference's
draws in the reference's order, so its indices and values equal the
reference's bit for bit; ``device`` then says where the tensor lives (the
CPU by default).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Tuple

import numpy as np

from repro_torch.core.coo import SparseCOO
from repro_torch.sparse.generators import random_sparse_tensor


@dataclasses.dataclass(frozen=True)
class PaperDataset:
    name: str
    shape: Tuple[int, ...]
    sparsity: float
    ranks: Tuple[int, ...]
    n_iter: int  # power-iteration sweeps the paper reports
    build: Callable[..., SparseCOO]  # build(device=None)
    exact: bool  # True if it is the paper's tensor itself


def _on(coo: SparseCOO, device) -> SparseCOO:
    return coo if device is None else coo.to(device)


def amazon_like(scale: float = 1.0, seed: int = 7, device=None) -> SparseCOO:
    """Amazon Reviews portion [34]: 20000^3 at sparsity 1.128e-10 (~902
    nonzeros, counts of a word in a review). Dense it would be 32 TB."""
    dim = int(20000 * scale)
    return _on(random_sparse_tensor((dim, dim, dim), 1.128e-10, seed=seed,
                                    value_dist="counts"), device)


def nell2_like(scale: float = 1.0, seed: int = 11, device=None) -> SparseCOO:
    """NELL-2 portion [37]: 1000^3 at sparsity 2.40e-5 (24,000
    entity-relation-entity tuples, values uniform in [0.1, 10))."""
    dim = int(1000 * scale)
    return _on(random_sparse_tensor((dim, dim, dim), 2.40e-5, seed=seed,
                                    value_dist="uniform"), device)


def matmul_tensor(m: int = 5, k: int = 5, n: int = 5, device=None) -> SparseCOO:
    """The binary tensor of the classical matrix product [35], [36], exact:
    x[i1, i2, i3] = 1 iff A-entry i1 (row-major) times B-entry i2
    (row-major) is summed into C-entry i3 (column-major). nnz = M K N."""
    rows = [(i * k + kk, kk * n + j, j * m + i)
            for i in range(m) for kk in range(k) for j in range(n)]
    idx = np.asarray(rows, dtype=np.int32)
    vals = np.ones((idx.shape[0],), dtype=np.float32)
    return _on(SparseCOO.from_parts(idx, vals, (m * k, k * n, m * n)), device)


def angiogram_like(seed: int = 3, device=None) -> SparseCOO:
    """A synthetic 130x150 retinal angiogram [38]: bright branching vessel
    curves on a dark background, thresholded to the paper's 0.18 density.
    2-way; the paper's ranks are (30, 35)."""
    h, w = 130, 150
    rng = np.random.default_rng(seed)
    img = np.zeros((h, w), dtype=np.float32)
    yy, xx = np.mgrid[0:h, 0:w]
    for _ in range(40):  # smooth vessel segments: quadratic curves with a width
        x0, y0 = rng.uniform(0, w), rng.uniform(0, h)
        ang = rng.uniform(0, 2 * np.pi)
        curv = rng.uniform(-0.01, 0.01)
        length = rng.uniform(30, 90)
        width = rng.uniform(0.8, 2.2)
        t = np.linspace(0, length, int(length * 2))
        cx = x0 + t * np.cos(ang) + curv * t**2
        cy = y0 + t * np.sin(ang) + curv * t**2 * 0.5
        for px, py in zip(cx, cy):
            if 0 <= px < w and 0 <= py < h:
                d2 = (xx - px) ** 2 + (yy - py) ** 2
                img += np.exp(-d2 / (2 * width**2)).astype(np.float32)
    img = img / img.max()
    thresh = np.quantile(img, 1.0 - 0.18)
    img = np.where(img > thresh, img, 0.0).astype(np.float32)
    return _on(SparseCOO.from_dense(img), device)


PAPER_DATASETS: Dict[str, PaperDataset] = {
    "amazon": PaperDataset(name="amazon", shape=(20000, 20000, 20000), sparsity=1.128e-10,
                           ranks=(32, 32, 32), n_iter=2, build=amazon_like, exact=False),
    "nell2": PaperDataset(name="nell2", shape=(1000, 1000, 1000), sparsity=2.40e-5,
                          ranks=(16, 16, 16), n_iter=5, build=nell2_like, exact=False),
    "matmul": PaperDataset(name="matmul", shape=(25, 25, 25), sparsity=8e-3,
                           ranks=(5, 5, 5), n_iter=3, build=matmul_tensor, exact=True),
    "angiogram": PaperDataset(name="angiogram", shape=(130, 150), sparsity=0.18,
                              ranks=(30, 35), n_iter=12, build=angiogram_like, exact=False),
}
