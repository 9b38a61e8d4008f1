"""The Mamba-2 SSD within-chunk block and chunk states, on the card.

Port of ``repro.kernels.ssd_scan``. Per (batch*head, chunk) of length L:

  diag block : y[i] = sum_{j<=i} exp(A[i]-A[j]) (c_i . b_j) x_j
  chunk state: S    = sum_j exp(A[L-1]-A[j]) b_j x_j^T          (N x P)

:func:`ssd_chunk` launches the CUDA kernel of ``csrc/ssd_chunk.cu`` for
CUDA tensors and runs :func:`ssd_chunk_plain` for CPU tensors; nothing else
picks between them. The inter-chunk recurrence stays in the model
(``models/mamba2.py``).

Training differentiates through :class:`SsdChunk`, an
``autograd.Function``, which :func:`ssd_chunk` takes when grad mode is on
and an operand requires grad; the gradient of both outputs is
:func:`ssd_chunk_bwd`, the kernel of ``csrc/ssd_chunk_bwd.cu`` on the card
and :func:`ssd_chunk_bwd_plain` on the CPU. Under ``torch.no_grad()``
(serving) the same kernel is launched as before, once a call.
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from repro_torch.kernels import _build, launch_count

MAX_CHUNK = 1024  # L: the kernel walks (L / 64)^2 / 2 tile pairs a chunk
MAX_WIDTH = 128  # N and P: a warp keeps the state of at most two 64-row blocks of N


def _acc_dtype(x: torch.Tensor) -> torch.dtype:
    """What the plain versions compute in: f32, or f64 for f64 operands
    (``torch.autograd.gradcheck``)."""
    return torch.float64 if x.dtype == torch.float64 else torch.float32


def _decay(a: torch.Tensor) -> torch.Tensor:
    """exp(a_i - a_j) for j <= i, 0 above the diagonal: the difference is
    masked to -inf before ``exp`` (above the diagonal ``exp`` may overflow,
    and ``inf * 0`` would be NaN, in the product and in its gradient)."""
    n = a.shape[-1]
    causal = torch.ones((n, n), dtype=torch.bool, device=a.device).tril()
    return torch.exp((a[..., :, None] - a[..., None, :]).masked_fill(~causal, float("-inf")))


def ssd_chunk_plain(x: torch.Tensor, a_cumsum: torch.Tensor, b_mat: torch.Tensor,
                    c_mat: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of :func:`ssd_chunk`, in f32 (f64 for f64
    operands), as ``_ssd_kernel`` computes it: the operands (B and C may be
    bf16) are widened to f32 first, and the decay is taken only on and below
    the diagonal (:func:`_decay`)."""
    acc = _acc_dtype(x)
    x, a, bm, cm = (t.to(acc) for t in (x, a_cumsum, b_mat, c_mat))
    decay = _decay(a)
    y = ((cm @ bm.transpose(-1, -2)) * decay) @ x
    state_decay = torch.exp(a[..., -1:] - a)  # (BH, C, L)
    s = (bm * state_decay[..., None]).transpose(-1, -2) @ x
    return y, s


def ssd_chunk_bwd_plain(x: torch.Tensor, a_cumsum: torch.Tensor, b_mat: torch.Tensor,
                        c_mat: torch.Tensor, dy: torch.Tensor, ds: torch.Tensor):
    """Plain PyTorch version of :func:`ssd_chunk_bwd`, in f32 (f64 for f64
    operands). With D the masked decay, M = (C B^T) o D and w_j =
    exp(a_{L-1} - a_j):

      dx = M^T dy + diag(w) B dS,     dG = (dy x^T) o D
      dC = dG B,                      dB = dG^T C + diag(w) x dS^T
      da_i += sum_j dG_ij G_ij,  da_j -= sum_i dG_ij G_ij
      da_j -= w_j dw_j,  da_{L-1} += sum_j w_j dw_j,  dw_j = x_j . (B dS)_j

    Returns (dx, da) in f32 and (dB, dC) in B's dtype."""
    acc = _acc_dtype(x)
    x, a, bm, cm, dy, ds = (t.to(acc) for t in (x, a_cumsum, b_mat, c_mat, dy, ds))
    decay = _decay(a)
    g = cm @ bm.transpose(-1, -2)
    dg = (dy @ x.transpose(-1, -2)) * decay  # dM masked, times D
    w = torch.exp(a[..., -1:] - a)  # (BH, C, L)
    bds = bm @ ds  # (BH, C, L, P)
    dx = (g * decay).transpose(-1, -2) @ dy + w[..., None] * bds
    dc = dg @ bm
    db = dg.transpose(-1, -2) @ cm + w[..., None] * (x @ ds.transpose(-1, -2))
    e = dg * g  # dM o M
    wdw = w * (x * bds).sum(dim=-1)
    da = e.sum(dim=-1) - e.sum(dim=-2) - wdw
    da[..., -1] += wdw.sum(dim=-1)
    return dx, da, db.to(b_mat.dtype), dc.to(b_mat.dtype)


def _lib():
    fn = _build.load("ssd_chunk").ssd_chunk_launch
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p] * 6 + [ctypes.c_longlong] + [i] * 4 + [p]
        fn.restype = ctypes.c_int
    return fn


def _bwd_lib():
    fn = _build.load("ssd_chunk_bwd").ssd_chunk_bwd_launch
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p] * 10 + [ctypes.c_longlong] + [i] * 4 + [p]
        fn.restype = ctypes.c_int
    return fn


def ssd_chunk(x: torch.Tensor, a_cumsum: torch.Tensor, b_mat: torch.Tensor,
              c_mat: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Batched within-chunk SSD.

    Args:
      x:        (BH, C, L, P)  inputs (already multiplied by dt).
      a_cumsum: (BH, C, L)     within-chunk cumulative sum of log decay.
      b_mat:    (BH, C, L, N)  input projections B.
      c_mat:    (BH, C, L, N)  output projections C.

    Returns ``y`` (BH, C, L, P), the diagonal-block outputs, and ``s``
    (BH, C, N, P), each chunk's outgoing state, both f32. B and C are
    bfloat16 or float32 (the same for both), x and a_cumsum float32. CPU
    tensors run the plain version; contiguous CUDA tensors launch the kernel
    of ``csrc/ssd_chunk.cu`` or raise. With grad mode on and an operand that
    requires grad the call goes through :class:`SsdChunk`.
    """
    if torch.is_grad_enabled() and any(t.requires_grad for t in (x, a_cumsum, b_mat, c_mat)):
        return SsdChunk.apply(x, a_cumsum, b_mat, c_mat)
    return _forward(x, a_cumsum, b_mat, c_mat)


def _check_operands(name: str, x, a_cumsum, b_mat, c_mat) -> Tuple[int, int, int, int, int]:
    """(BH, C, L, P, N) of operands that the kernels take; raises otherwise."""
    if x.dim() != 4 or a_cumsum.dim() != 3 or b_mat.dim() != 4 or c_mat.dim() != 4:
        raise ValueError(f"{name}: x, b, c must be 4-D and a_cumsum 3-D")
    bh, c, n_l, p = x.shape
    n = b_mat.shape[3]
    if (tuple(a_cumsum.shape) != (bh, c, n_l) or tuple(b_mat.shape) != (bh, c, n_l, n)
            or c_mat.shape != b_mat.shape):
        raise ValueError(f"{name}: x {tuple(x.shape)}, a_cumsum {tuple(a_cumsum.shape)}, "
                         f"b {tuple(b_mat.shape)}, c {tuple(c_mat.shape)} do not fit")
    if b_mat.dtype not in (torch.float32, torch.bfloat16) or c_mat.dtype != b_mat.dtype:
        raise ValueError(f"{name}: b and c must both be float32 or both bfloat16, got "
                         f"{b_mat.dtype}, {c_mat.dtype}")
    for what, t in (("x", x), ("a_cumsum", a_cumsum), ("b_mat", b_mat), ("c_mat", c_mat)):
        if t.device != x.device or not t.is_cuda:
            raise ValueError(f"{name}: {what} on {t.device}, x on {x.device}")
        if what in ("x", "a_cumsum") and t.dtype != torch.float32:
            raise ValueError(f"{name}: {what} must be float32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {what} must be contiguous")
    if not (1 <= n_l <= MAX_CHUNK and 1 <= n <= MAX_WIDTH and 1 <= p <= MAX_WIDTH):
        raise ValueError(f"{name}: L {n_l}, N {n}, P {p} outside 1..{MAX_CHUNK}, "
                         f"1..{MAX_WIDTH}, 1..{MAX_WIDTH}")
    return bh, c, n_l, p, n


def _forward(x, a_cumsum, b_mat, c_mat):
    """:func:`ssd_chunk` without autograd: the plain version on the CPU,
    else one launch of ``csrc/ssd_chunk.cu``."""
    if x.device.type == "cpu":
        return ssd_chunk_plain(x, a_cumsum, b_mat, c_mat)
    bh, c, n_l, p, n = _check_operands("ssd_chunk", x, a_cumsum, b_mat, c_mat)
    y = torch.empty_like(x)
    s = torch.empty((bh, c, n, p), dtype=torch.float32, device=x.device)
    if bh * c == 0:
        return y, s
    fn = _lib()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = fn(x.data_ptr(), a_cumsum.data_ptr(), b_mat.data_ptr(), c_mat.data_ptr(),
                y.data_ptr(), s.data_ptr(), bh * c, n_l, n, p,
                int(b_mat.dtype == torch.bfloat16), stream)
    if rc != 0:
        raise RuntimeError(f"ssd_chunk_launch failed at x {tuple(x.shape)}, N {n}: "
                           f"CUDA error {rc}")
    launch_count.count(ssd_chunk)
    return y, s


def ssd_chunk_bwd(x: torch.Tensor, a_cumsum: torch.Tensor, b_mat: torch.Tensor,
                  c_mat: torch.Tensor, dy: torch.Tensor, ds: torch.Tensor):
    """(dx, da_cumsum, db, dc) of :func:`ssd_chunk` at its operands, given
    the gradients ``dy`` (BH, C, L, P) and ``ds`` (BH, C, N, P) of its two
    outputs (f32): dx and da in f32, db and dc in B's dtype. CPU tensors run
    :func:`ssd_chunk_bwd_plain`; contiguous CUDA tensors launch the kernel of
    ``csrc/ssd_chunk_bwd.cu`` or raise."""
    if x.device.type == "cpu":
        return ssd_chunk_bwd_plain(x, a_cumsum, b_mat, c_mat, dy, ds)
    bh, c, n_l, p, n = _check_operands("ssd_chunk_bwd", x, a_cumsum, b_mat, c_mat)
    for what, t, shape in (("dy", dy, (bh, c, n_l, p)), ("ds", ds, (bh, c, n, p))):
        if (tuple(t.shape) != shape or t.dtype != torch.float32 or t.device != x.device
                or not t.is_contiguous()):
            raise ValueError(f"ssd_chunk_bwd: {what} must be contiguous float32 {shape} on "
                             f"{x.device}, got {t.dtype} {tuple(t.shape)} on {t.device}")
    dx, da = torch.empty_like(x), torch.empty_like(a_cumsum)
    db, dc = torch.empty_like(b_mat), torch.empty_like(c_mat)
    if bh * c == 0:
        return dx, da, db, dc
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = _bwd_lib()(x.data_ptr(), a_cumsum.data_ptr(), b_mat.data_ptr(), c_mat.data_ptr(),
                        dy.data_ptr(), ds.data_ptr(), dx.data_ptr(), da.data_ptr(),
                        db.data_ptr(), dc.data_ptr(), bh * c, n_l, n, p,
                        int(b_mat.dtype == torch.bfloat16), stream)
    if rc != 0:
        raise RuntimeError(f"ssd_chunk_bwd_launch failed at x {tuple(x.shape)}, N {n}: "
                           f"CUDA error {rc}")
    launch_count.count(_SSD_BWD)  # itself, also while a caller wraps the module's name
    return dx, da, db, dc


class SsdChunk(torch.autograd.Function):
    """:func:`ssd_chunk` with its gradient through both outputs (the chunk
    state feeds the inter-chunk scan): the forward saves the operands, the
    backward is :func:`ssd_chunk_bwd` (looked up at call time, so that a
    caller can wrap it)."""

    @staticmethod
    def forward(ctx, x, a_cumsum, b_mat, c_mat):
        y, s = _forward(x, a_cumsum, b_mat, c_mat)
        ctx.save_for_backward(x, a_cumsum, b_mat, c_mat)
        return y, s

    @staticmethod
    def backward(ctx, dy, ds):
        x, a_cumsum, b_mat, c_mat = ctx.saved_tensors
        return ssd_chunk_bwd(x, a_cumsum, b_mat, c_mat, dy.contiguous(), ds.contiguous())


ssd_chunk.launches = 0  # kernel launches since the last reset
ssd_chunk_bwd.launches = 0
_SSD_BWD = ssd_chunk_bwd
