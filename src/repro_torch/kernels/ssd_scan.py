"""The Mamba-2 SSD within-chunk block and chunk states, on the card.

Port of ``repro.kernels.ssd_scan``. Per (batch*head, chunk) of length L:

  diag block : y[i] = sum_{j<=i} exp(A[i]-A[j]) (c_i . b_j) x_j
  chunk state: S    = sum_j exp(A[L-1]-A[j]) b_j x_j^T          (N x P)

:func:`ssd_chunk` launches the CUDA kernel of ``csrc/ssd_chunk.cu`` for
CUDA tensors and runs :func:`ssd_chunk_plain` for CPU tensors; nothing else
picks between them. The inter-chunk recurrence stays in the model
(``models/mamba2.py``).
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from repro_torch.kernels import _build, launch_count

MAX_CHUNK = 1024  # L: the kernel walks (L / 64)^2 / 2 tile pairs a chunk
MAX_WIDTH = 128  # N and P: a warp keeps the state of at most two 64-row blocks of N


def ssd_chunk_plain(x: torch.Tensor, a_cumsum: torch.Tensor, b_mat: torch.Tensor,
                    c_mat: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of :func:`ssd_chunk`, in f32, as ``_ssd_kernel``
    computes it: the operands (B and C may be bf16) are widened to f32 first,
    and the decay is taken only on and below the diagonal (above it ``exp``
    may overflow, and ``inf * 0`` would be NaN)."""
    x, a, bm, cm = (t.to(torch.float32) for t in (x, a_cumsum, b_mat, c_mat))
    n = x.shape[2]
    causal = torch.ones((n, n), dtype=torch.bool, device=x.device).tril()
    decay = torch.where(causal, torch.exp(a[..., :, None] - a[..., None, :]), 0.0)
    y = ((cm @ bm.transpose(-1, -2)) * decay) @ x
    state_decay = torch.exp(a[..., -1:] - a)  # (BH, C, L)
    s = (bm * state_decay[..., None]).transpose(-1, -2) @ x
    return y, s


def _lib():
    fn = _build.load("ssd_chunk").ssd_chunk_launch
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p] * 6 + [ctypes.c_longlong] + [i] * 4 + [p]
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
    of ``csrc/ssd_chunk.cu`` or raise.
    """
    if x.device.type == "cpu":
        return ssd_chunk_plain(x, a_cumsum, b_mat, c_mat)
    if x.dim() != 4 or a_cumsum.dim() != 3 or b_mat.dim() != 4 or c_mat.dim() != 4:
        raise ValueError("ssd_chunk: x, b, c must be 4-D and a_cumsum 3-D")
    bh, c, n_l, p = x.shape
    n = b_mat.shape[3]
    if (tuple(a_cumsum.shape) != (bh, c, n_l) or tuple(b_mat.shape) != (bh, c, n_l, n)
            or c_mat.shape != b_mat.shape):
        raise ValueError(f"ssd_chunk: x {tuple(x.shape)}, a_cumsum {tuple(a_cumsum.shape)}, "
                         f"b {tuple(b_mat.shape)}, c {tuple(c_mat.shape)} do not fit")
    if b_mat.dtype not in (torch.float32, torch.bfloat16) or c_mat.dtype != b_mat.dtype:
        raise ValueError(f"ssd_chunk: b and c must both be float32 or both bfloat16, got "
                         f"{b_mat.dtype}, {c_mat.dtype}")
    for name, t in (("x", x), ("a_cumsum", a_cumsum), ("b_mat", b_mat), ("c_mat", c_mat)):
        if t.device != x.device or not t.is_cuda:
            raise ValueError(f"ssd_chunk: {name} on {t.device}, x on {x.device}")
        if name in ("x", "a_cumsum") and t.dtype != torch.float32:
            raise ValueError(f"ssd_chunk: {name} must be float32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"ssd_chunk: {name} must be contiguous")
    if not (1 <= n_l <= MAX_CHUNK and 1 <= n <= MAX_WIDTH and 1 <= p <= MAX_WIDTH):
        raise ValueError(f"ssd_chunk: L {n_l}, N {n}, P {p} outside 1..{MAX_CHUNK}, "
                         f"1..{MAX_WIDTH}, 1..{MAX_WIDTH}")
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


ssd_chunk.launches = 0  # kernel launches since the last reset
