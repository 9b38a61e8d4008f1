"""The core TTM, G = Y U^T (paper Alg. 3 / Eq. 12), on the card.

Port of ``repro.kernels.ttm_kernel``. :func:`ttm` launches the split-K
CUDA kernel of ``csrc/ttm.cu`` for CUDA tensors and runs :func:`ttm_plain`
for CPU tensors; nothing else picks between them.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.kron_kernel import _cast_operands

_BL, _BR, _BT = 64, 16, 32  # output tile and contraction step of the kernel
_TARGET_CTAS = 264  # two CTAs per SM of a 132-SM card


def ttm_plain(y: torch.Tensor, u: torch.Tensor, *, precision: str = "fp32") -> torch.Tensor:
    """Plain PyTorch version of :func:`ttm`: cast per ``precision``, then an
    f32 matrix product."""
    y, u = _cast_operands(precision, y, u)
    return y.to(torch.float32) @ u.to(torch.float32).T


def _lib():
    fn = _build.load("ttm").ttm_launch
    if fn.argtypes is None:
        ll, i, p = ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p
        fn.argtypes = [p, ll, ll, p, ll, ll, p, p, i, i, i, i, i, i, p]
        fn.restype = ctypes.c_int
    return fn


def split(n_contract: int, n_tiles: int):
    """(chunk, n_chunks): the contraction slices of the split-K pass, about
    ``_TARGET_CTAS`` CTAs in all, each slice a multiple of the staging step."""
    n_chunks = min(max(1, -(-_TARGET_CTAS // n_tiles)), -(-n_contract // _BT))
    chunk = -(-(-(-n_contract // n_chunks)) // _BT) * _BT
    return chunk, -(-n_contract // chunk)


def ttm(y: torch.Tensor, u: torch.Tensor, *, precision: str = "fp32") -> torch.Tensor:
    """``G = Y @ U^T`` (L, R) f32 for y (L, I) and u (R, I).

    Both operands are read through their strides, so transposed views need
    no copy. CPU tensors run the plain version; CUDA tensors launch the
    kernel of ``csrc/ttm.cu`` or raise.
    """
    if y.device.type == "cpu":
        return ttm_plain(y, u, precision=precision)
    if not y.is_cuda or u.device != y.device:
        raise ValueError(f"ttm: y on {y.device}, u on {u.device}")
    if y.dim() != 2 or u.dim() != 2 or y.shape[1] != u.shape[1]:
        raise ValueError(f"ttm: y {tuple(y.shape)} and u {tuple(u.shape)} do not contract")
    y, u = _cast_operands(precision, y, u)
    if y.dtype != u.dtype or y.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"ttm: y, u must share dtype float32 or bfloat16, got {y.dtype}, {u.dtype}")
    if min(y.stride()) < 0 or min(u.stride()) < 0:
        raise ValueError("ttm: negative strides are not supported")
    (n_l, n_i), n_r = y.shape, u.shape[0]
    out = torch.empty((n_l, n_r), dtype=torch.float32, device=y.device)
    if n_l == 0 or n_r == 0 or n_i == 0:
        return out.zero_()
    chunk, n_chunks = split(n_i, -(-n_l // _BL) * -(-n_r // _BR))
    part = torch.empty((n_chunks, n_l, n_r), dtype=torch.float32, device=y.device)
    fn = _lib()
    with torch.cuda.device(y.device):
        stream = torch.cuda.current_stream(y.device).cuda_stream
        rc = fn(y.data_ptr(), y.stride(0), y.stride(1), u.data_ptr(), u.stride(0),
                u.stride(1), part.data_ptr(), out.data_ptr(), n_l, n_i, n_r, chunk,
                n_chunks, int(y.dtype == torch.bfloat16), stream)
    if rc != 0:
        raise RuntimeError(f"ttm_launch failed: CUDA error {rc}")
    ttm.launches += 1
    return out


ttm.launches = 0  # kernel launches since the last reset
