"""QR decomposition with column pivoting — the paper's module 3 (Sec. III-D).

Port of ``repro.core.qrp``. QRP has no kernel of its own in the reference:
these are torch ops on the sweep's device. The reference's ``fori_loop``
chains become Python loops of R steps whose bounds are host ints, so no step
reads a device value back (pivots stay one-element device tensors).

Tie-breaking follows the reference: ``argmax`` picks the first maximal
column.
"""
from __future__ import annotations

from typing import Tuple

import torch

_EPS = 1e-12


def _swap(t: torch.Tensor, j: int, p: torch.Tensor, dim: int) -> torch.Tensor:
    """Swap index ``j`` and the one-element device index ``p`` of ``t``
    along ``dim``, in place (a no-op when they coincide)."""
    idx = torch.cat([torch.full((1,), j, dtype=p.dtype, device=p.device), p])
    src = t.index_select(dim, idx.flip(0))
    return t.index_copy_(dim, idx, src)


def qrp_householder(a: torch.Tensor, r: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Column-pivoted Householder QR, truncated to ``r`` reflections.

    Args:
      a: (m, n) matrix (the unfolding Y_(n)).
      r: number of orthonormal columns wanted (the Tucker rank R_n).

    Returns:
      (q, piv): q (m, r) with orthonormal columns; piv (r,) int64 the pivot
      columns in selection order.
    """
    m, n = a.shape
    r = min(r, m, n)
    dt = torch.promote_types(a.dtype, torch.float32)
    dev = a.device
    a_work = a.to(dt).clone()
    vs = torch.zeros((m, r), dtype=dt, device=dev)
    piv = torch.zeros((r,), dtype=torch.int64, device=dev)
    used = torch.zeros((n,), dtype=torch.bool, device=dev)
    col_ids = torch.arange(n, device=dev)
    neg_inf = torch.full((), float("-inf"), dtype=dt, device=dev)
    for j in range(r):
        # norms of the trailing (rows >= j) block; the heaviest unused
        # column is the next pivot (Eq. 15).
        norms = torch.sum(torch.square(a_work[j:]), dim=0)
        # pivots stay (1,) device tensors, indexed through index_* ops:
        # indexing with a 0-d tensor would read it back to the host.
        p = torch.argmax(torch.where(used, neg_inf, norms)).reshape(1)
        piv[j:j + 1] = col_ids.index_select(0, p)  # the ORIGINAL column id
        used.index_fill_(0, p, True)
        _swap(a_work, j, p, 1)
        _swap(used, j, p, 0)
        _swap(col_ids, j, p, 0)
        # Householder vector of column j, rows >= j (Eqs. 17-18).
        col = a_work[:, j].clone()
        col[:j] = 0.0
        norm_c = torch.linalg.vector_norm(col)
        sign = torch.where(col[j] >= 0, 1.0, -1.0).to(dt)
        v = col
        v[j] = v[j] + sign * norm_c
        vnorm = torch.linalg.vector_norm(v)
        safe = vnorm > _EPS
        ej = torch.zeros((m,), dtype=dt, device=dev)
        ej[j] = 1.0
        v = torch.where(safe, v / torch.where(safe, vnorm, 1.0), ej)
        a_work = a_work - 2.0 * torch.outer(v, v @ a_work)
        vs[:, j] = v
    # Q[:, :r] = H_1 ... H_r I[:, :r] (reflections applied in reverse).
    q = torch.eye(m, r, dtype=dt, device=dev)
    for j in range(r - 1, -1, -1):
        v = vs[:, j]
        q = q - 2.0 * torch.outer(v, v @ q)
    return q, piv


def pivoted_cholesky(g: torch.Tensor, r: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Rank-r pivoted Cholesky of an SPSD (K, K) matrix: (l, piv) with
    l (K, r) in original row indexing, g ~= l @ l.T on the pivots."""
    k = g.shape[0]
    r = min(r, k)
    dt = torch.promote_types(g.dtype, torch.float32)
    g = g.to(dt)
    l = torch.zeros((k, r), dtype=dt, device=g.device)
    d = torch.diagonal(g).clone()  # remaining diagonal
    piv = torch.zeros((r,), dtype=torch.int64, device=g.device)
    for j in range(r):
        p = torch.argmax(d).reshape(1)
        piv[j:j + 1] = p
        root = torch.sqrt(torch.clamp(d.index_select(0, p), min=0.0) + _EPS)
        col = (g.index_select(1, p)[:, 0] - l @ l.index_select(0, p)[0]) / root
        l[:, j] = col
        d = torch.clamp(d - torch.square(col), min=0.0)
        d.index_fill_(0, p, float("-inf"))  # never re-pick
    return l, piv


def qrp_gram(a: torch.Tensor, r: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """QRP through the Gram matrix: pivoted Cholesky of A^T A picks the
    pivots, Q = A_S inv(L_S^T), then one thin QR for conditioning.

    Returns NaN on a rank-deficient A, like the reference (its Cholesky
    step divides by a vanishing pivot)."""
    m, n = a.shape
    r = min(r, m, n)
    a32 = a.to(torch.promote_types(a.dtype, torch.float32))
    l, piv = pivoted_cholesky(a32.T @ a32, r)
    l_s = l[piv, :]
    a_s = a32[:, piv]
    # the reference solves X @ U^T = A_S with U the UPPER triangle of L_S
    # (``lower=False``); mirrored here so both packages agree.
    q = torch.linalg.solve_triangular(torch.triu(l_s).T, a_s, upper=False, left=False)
    q, _ = torch.linalg.qr(q)
    return q, piv


def qrp(a: torch.Tensor, r: int, method: str = "householder") -> torch.Tensor:
    """Factor update U_n <- QRP(Y_(n), R_n) (Alg. 2 line 7)."""
    if method == "householder":
        q, _ = qrp_householder(a, r)
    elif method == "gram":
        q, _ = qrp_gram(a, r)
    else:
        raise ValueError(f"unknown QRP method: {method}")
    return q


def svd_factor(a: torch.Tensor, r: int) -> torch.Tensor:
    """R leading left singular vectors (the baseline the paper replaces).

    On the card this asks cuSOLVER for its QR-based ``gesvd``: the default
    Jacobi ``gesvdj`` trades accuracy for speed, and on a rank-16 unfolding
    in f32 it left Table II's dense error at 1.7e-4 against LAPACK's 1.2e-6
    on the CPU (an H100, 200^3)."""
    kw = {"driver": "gesvd"} if a.is_cuda else {}
    u, _, _ = torch.linalg.svd(
        a.to(torch.promote_types(a.dtype, torch.float32)), full_matrices=False, **kw
    )
    return u[:, :r]


def factor_update(y_n: torch.Tensor, r: int, method: str) -> torch.Tensor:
    """HOOI factor update U_n <- orth(Y_(n), R_n): 'svd' (Alg. 1 line 5) or
    'householder' / 'gram' (Alg. 2 line 7)."""
    if method == "svd":
        return svd_factor(y_n, r)
    return qrp(y_n, r, method=method)


def qrp_flops(m: int, n: int) -> int:
    """The paper's QRP flop model: 2mn^2 - 2n^3/3."""
    return int(2 * m * n * n - 2 * n**3 // 3)


def svd_flops(m: int, n: int) -> int:
    """The paper's SVD flop model: 2mn^2 + 11n^3."""
    return int(2 * m * n * n + 11 * n**3)
