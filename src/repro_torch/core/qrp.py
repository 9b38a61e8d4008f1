"""QR decomposition with column pivoting — the paper's module 3 (Sec. III-D).

Port of ``repro.core.qrp``. QRP has no kernel of its own in the reference:
these are torch ops on the sweep's device. The reference's ``fori_loop``
chains become Python loops of R steps whose bounds are host ints, so no step
reads a device value back (pivots stay (k, 1) device tensors).

Every function takes a matrix or a (k, m, n) batch of matrices, each
reduced on its own with one set of launches for the whole batch (the
batched sweeps of ``TuckerPlan.batch``); a matrix is the batch of one.

Tie-breaking follows the reference: ``argmax`` picks the first maximal
column, per member.
"""
from __future__ import annotations

from typing import Tuple

import torch

_EPS = 1e-12


def _batch(a: torch.Tensor) -> Tuple[torch.Tensor, bool]:
    """``a`` with a leading batch axis, and whether it came with one."""
    if a.dim() == 3:
        return a, True
    if a.dim() == 2:
        return a[None], False
    raise ValueError(f"expected a matrix or a batch of matrices, got shape {tuple(a.shape)}")


def qrp_householder(a: torch.Tensor, r: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Column-pivoted Householder QR, truncated to ``r`` reflections.

    Args:
      a: (m, n) matrix (the unfolding Y_(n)), or a (k, m, n) batch of them,
        each reduced on its own.
      r: number of orthonormal columns wanted (the Tucker rank R_n).

    Returns:
      (q, piv): q (m, r) with orthonormal columns; piv (r,) int64 the pivot
      columns in selection order; each with the batch axis of ``a``.

    The pivot columns are swapped to the front as the reference swaps them,
    so the first j columns are exactly the used ones and the next pivot is
    the heaviest of columns j.. (the first of equals, in swapped order).
    """
    a3, batched = _batch(a)
    k, m, n = a3.shape
    r = min(r, m, n)
    dt = torch.promote_types(a.dtype, torch.float32)
    dev = a.device
    a_work = a3.to(dt).clone()
    vs = torch.zeros((k, r, m), dtype=dt, device=dev)
    piv = torch.empty((k, r), dtype=torch.int64, device=dev)
    col_ids = torch.arange(n, device=dev).repeat(k, 1)
    e = torch.zeros((r, m), dtype=dt, device=dev)  # e[j]: the j-th unit vector
    e.diagonal().fill_(1.0)
    for j in range(r):
        # norms of the trailing (rows >= j) block over the unused columns;
        # each member's heaviest is its next pivot (Eq. 15). Pivots stay
        # (k, 1) device tensors, used through gather/scatter: indexing with
        # a device scalar would read it back to the host.
        norms = torch.sum(torch.square(a_work[:, j:, j:]), dim=1)
        p = torch.argmax(norms, dim=1, keepdim=True) + j
        # swap column j with each member's pivot column p
        ids_j = col_ids[:, j:j + 1].clone()
        ids_p = col_ids.gather(1, p)
        piv[:, j:j + 1] = ids_p  # the ORIGINAL column id
        col_ids[:, j:j + 1] = ids_p
        col_ids.scatter_(1, p, ids_j)
        p3 = p[:, None, :].expand(k, m, 1)
        col_j = a_work[:, :, j:j + 1].clone()
        col = a_work.gather(2, p3)
        a_work[:, :, j:j + 1] = col
        a_work.scatter_(2, p3, col_j)
        # Householder vector of the pivot column, rows >= j (Eqs. 17-18).
        v = col[:, :, 0]
        v[:, :j] = 0.0
        norm_c = torch.linalg.vector_norm(v, dim=1)
        sign = torch.where(v[:, j] >= 0, 1.0, -1.0).to(dt)
        v[:, j].addcmul_(sign, norm_c)
        vnorm = torch.linalg.vector_norm(v, dim=1, keepdim=True)
        safe = vnorm > _EPS
        v = torch.where(safe, v / torch.where(safe, vnorm, 1.0), e[j])
        # A <- (I - 2 v v^T) A, the outer product as one batched product
        a_work = torch.baddbmm(a_work, v[:, :, None], torch.bmm(v[:, None, :], a_work),
                               alpha=-2.0)
        vs[:, j] = v
    # Q[:, :r] = H_1 ... H_r I[:, :r] (reflections applied in reverse).
    q = torch.eye(m, r, dtype=dt, device=dev).expand(k, m, r)
    for j in range(r - 1, -1, -1):
        v = vs[:, j]
        q = torch.baddbmm(q, v[:, :, None], torch.bmm(v[:, None, :], q), alpha=-2.0)
    return (q, piv) if batched else (q[0], piv[0])


def pivoted_cholesky(g: torch.Tensor, r: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Rank-r pivoted Cholesky of an SPSD (K, K) matrix, or of each of a
    (k, K, K) batch: (l, piv) with l (K, r) in original row indexing,
    g ~= l @ l.T on the pivots; each with the batch axis of ``g``."""
    g3, batched = _batch(g)
    k, kk = g3.shape[0], g3.shape[1]
    r = min(r, kk)
    dt = torch.promote_types(g.dtype, torch.float32)
    g3 = g3.to(dt)
    l = torch.zeros((k, kk, r), dtype=dt, device=g.device)
    d = torch.diagonal(g3, dim1=1, dim2=2).clone()  # remaining diagonal
    piv = torch.zeros((k, r), dtype=torch.int64, device=g.device)
    for j in range(r):
        p = torch.argmax(d, dim=1, keepdim=True)
        piv[:, j:j + 1] = p
        root = torch.sqrt(torch.clamp(d.gather(1, p), min=0.0) + _EPS)
        g_col = g3.gather(2, p[:, None, :].expand(k, kk, 1))
        l_row = l.gather(1, p[:, :, None].expand(k, 1, r))
        col = (g_col - torch.bmm(l, l_row.mT))[:, :, 0] / root
        l[:, :, j] = col
        d = torch.clamp(d - torch.square(col), min=0.0)
        d.scatter_(1, p, float("-inf"))  # never re-pick
    return (l, piv) if batched else (l[0], piv[0])


def qrp_gram(a: torch.Tensor, r: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """QRP through the Gram matrix: pivoted Cholesky of A^T A picks the
    pivots, Q = A_S inv(L_S^T), then one thin QR for conditioning. ``a`` is
    a matrix or a (k, m, n) batch; the outputs carry its batch axis.

    Returns NaN on a rank-deficient A, like the reference (its Cholesky
    step divides by a vanishing pivot)."""
    a3, batched = _batch(a)
    k, m, n = a3.shape
    r = min(r, m, n)
    a32 = a3.to(torch.promote_types(a.dtype, torch.float32))
    l, piv = pivoted_cholesky(a32.mT @ a32, r)
    l_s = l.gather(1, piv[:, :, None].expand(k, r, r))
    a_s = a32.gather(2, piv[:, None, :].expand(k, m, r))
    # the reference solves X @ U^T = A_S with U the UPPER triangle of L_S
    # (``lower=False``); mirrored here so both packages agree.
    q = torch.linalg.solve_triangular(torch.triu(l_s).mT, a_s, upper=False, left=False)
    q, _ = torch.linalg.qr(q)
    return (q, piv) if batched else (q[0], piv[0])


def qrp(a: torch.Tensor, r: int, method: str = "householder") -> torch.Tensor:
    """Factor update U_n <- QRP(Y_(n), R_n) (Alg. 2 line 7), of a matrix or
    of each of a batch."""
    if method == "householder":
        q, _ = qrp_householder(a, r)
    elif method == "gram":
        q, _ = qrp_gram(a, r)
    else:
        raise ValueError(f"unknown QRP method: {method}")
    return q


def svd_factor(a: torch.Tensor, r: int) -> torch.Tensor:
    """R leading left singular vectors (the baseline the paper replaces), of
    a matrix or of each of a batch.

    On the card this asks cuSOLVER for its QR-based ``gesvd``: the default
    Jacobi ``gesvdj`` trades accuracy for speed, and on a rank-16 unfolding
    in f32 it left Table II's dense error at 1.7e-4 against LAPACK's 1.2e-6
    on the CPU (an H100, 200^3)."""
    kw = {"driver": "gesvd"} if a.is_cuda else {}
    u, _, _ = torch.linalg.svd(
        a.to(torch.promote_types(a.dtype, torch.float32)), full_matrices=False, **kw
    )
    return u[..., :r]


def factor_update(y_n: torch.Tensor, r: int, method: str) -> torch.Tensor:
    """HOOI factor update U_n <- orth(Y_(n), R_n): 'svd' (Alg. 1 line 5) or
    'householder' / 'gram' (Alg. 2 line 7). ``y_n`` is one unfolding (m, n)
    or a (k, m, n) batch of them; the result has its batch axis."""
    if method == "svd":
        return svd_factor(y_n, r)
    return qrp(y_n, r, method=method)


def qrp_flops(m: int, n: int) -> int:
    """The paper's QRP flop model: 2mn^2 - 2n^3/3."""
    return int(2 * m * n * n - 2 * n**3 // 3)


def svd_flops(m: int, n: int) -> int:
    """The paper's SVD flop model: 2mn^2 + 11n^3."""
    return int(2 * m * n * n + 11 * n**3)
