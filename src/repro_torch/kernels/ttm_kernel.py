"""The core TTM, G = Y U^T (paper Alg. 3 / Eq. 12), on the card.

Port of ``repro.kernels.ttm_kernel``. :func:`ttm` launches the one-launch
CUDA kernel of ``csrc/ttm.cu`` for CUDA tensors and runs :func:`ttm_plain`
for CPU tensors; nothing else picks between them. f32 and bf16 operands
give an f32 G, f64 operands an f64 G (the kernel's f64 instantiation).
"""
from __future__ import annotations

import ctypes
import functools
import math
from typing import Dict, List, Tuple

import torch

from repro_torch.kernels import _build, launch_count
from repro_torch.kernels.kron_kernel import _cast_operands, _kind

_BL, _BR, _BT = 256, 16, 32  # output tile and contraction step of the kernel
_SCRATCH: Dict[Tuple[torch.device, torch.dtype], Tuple[torch.Tensor, torch.Tensor]] = {}


def ttm_plain(y: torch.Tensor, u: torch.Tensor, *, precision: str = "fp32") -> torch.Tensor:
    """Plain PyTorch version of :func:`ttm`: cast per ``precision``, then a
    matrix product in f32 (f64 for f64 operands)."""
    y, u = _cast_operands(precision, y, u)
    dt = torch.promote_types(torch.promote_types(y.dtype, u.dtype), torch.float32)
    return y.to(dt) @ u.to(dt).T


def _lib():
    fn = _build.load("ttm").ttm_launch
    if fn.argtypes is None:
        ll, i, p = ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p
        fn.argtypes = [p, ll, ll, p, ll, ll, p, p, p, i, i, i, i, i, i, i, i, p]
        fn.restype = ctypes.c_int
    return fn


def kernels_launched() -> int:
    """Device kernels the library has launched in this process, counted on
    the C side at each ``<<<>>>``: one per :func:`ttm` call on the card."""
    fn = _build.load("ttm").ttm_kernels_launched
    fn.restype = ctypes.c_longlong
    return int(fn())


def n_tiles(n_l: int, n_r: int) -> int:
    """Output tiles of the kernel for an (L, R) result."""
    return -(-n_l // _BL) * -(-n_r // _BR)


def split(n_contract: int, tiles: int, n_sm: int) -> Tuple[int, int, int]:
    """(chunk, n_splits, group): the work split of the one launch. Each of
    the ``tiles`` output tiles gets ``n_splits`` CTAs, about one CTA per SM in
    all; split s reduces contraction indices [s*chunk, min(I, (s+1)*chunk)),
    a whole number of staging steps each but the last. The partials are
    combined in groups of ``group`` consecutive splits, then the groups in
    order."""
    n = min(max(1, n_sm // tiles), -(-n_contract // _BT))
    chunk = -(-(-(-n_contract // n)) // _BT) * _BT
    n_splits = -(-n_contract // chunk)
    group = math.isqrt(n_splits - 1) + 1 if n_splits > 1 else 1  # ceil(sqrt(n_splits))
    return chunk, n_splits, group


def ranges(n_contract: int, chunk: int, n_splits: int) -> List[Tuple[int, int]]:
    """The contraction range [begin, end) of each split, in split order."""
    return [(s * chunk, min(n_contract, (s + 1) * chunk)) for s in range(n_splits)]


def bulk_copies(y: torch.Tensor, u: torch.Tensor) -> bool:
    """Whether the kernel streams y and u by bulk copies: each contraction
    index a unit-stride row of both, every row start and tile segment
    16-byte aligned; any other layout takes the kernel's strided staging."""
    return _bulk(y.shape[0], u.shape[0], y.stride(), u.stride(), y.element_size(),
                 (y.data_ptr() | u.data_ptr()) % 16 == 0)


def _bulk(n_l: int, n_r: int, sy: Tuple[int, int], su: Tuple[int, int], esize: int,
          aligned: bool) -> bool:
    return (aligned and sy[0] == 1 and su[0] == 1
            and (sy[1] * esize) % 16 == 0 and (su[1] * esize) % 16 == 0
            and (n_l * esize) % 16 == 0 and (n_r * esize) % 16 == 0)


@functools.lru_cache(maxsize=256)
def _launch_args(n_l: int, n_i: int, n_r: int, sy: Tuple[int, int], su: Tuple[int, int],
                 esize: int, aligned: bool, index: int) -> Tuple[int, ...]:
    """(chunk, n_splits, group, bulk, slot floats, tickets) for one call's
    shapes and layout on card ``index``: host work done once per layout."""
    tiles = n_tiles(n_l, n_r)
    chunk, n_splits, group = split(
        n_i, tiles, torch.cuda.get_device_properties(index).multi_processor_count)
    n_groups = -(-n_splits // group)
    n_slots = (n_splits + n_groups) * n_l * n_r if n_splits > 1 else 1
    return (chunk, n_splits, group, int(_bulk(n_l, n_r, sy, su, esize, aligned)), n_slots,
            tiles * (n_groups + 1))


def _scratch(device: torch.device, n_slots: int, n_tickets: int,
             dtype: torch.dtype = torch.float32):
    """The slot buffer (of the output's ``dtype``) and the zeroed ticket
    counters of ``device``, kept between calls (the kernel leaves the
    counters at zero) and grown when a call needs more, one pair per output
    dtype. Calls on one device are ordered by its current stream."""
    slots, tickets = _SCRATCH.get((device, dtype), (None, None))
    if slots is None or slots.numel() < n_slots:
        slots = torch.empty(n_slots, dtype=dtype, device=device)
    if tickets is None or tickets.numel() < n_tickets:
        tickets = torch.zeros(n_tickets, dtype=torch.int32, device=device)
    _SCRATCH[(device, dtype)] = (slots, tickets)
    return slots, tickets


def ttm(y: torch.Tensor, u: torch.Tensor, *, precision: str = "fp32") -> torch.Tensor:
    """``G = Y @ U^T`` (L, R) for y (L, I) and u (R, I): f32, or f64 for f64
    operands under ``fp32``.

    Both operands are read through their strides, so transposed views need
    no copy. CPU tensors run the plain version; CUDA tensors launch the
    kernel of ``csrc/ttm.cu`` once or raise.
    """
    if y.device.type == "cpu":
        return ttm_plain(y, u, precision=precision)
    if not y.is_cuda or u.device != y.device:
        raise ValueError(f"ttm: y on {y.device}, u on {u.device}")
    if y.dim() != 2 or u.dim() != 2 or y.shape[1] != u.shape[1]:
        raise ValueError(f"ttm: y {tuple(y.shape)} and u {tuple(u.shape)} do not contract")
    y, u = _cast_operands(precision, y, u)
    if y.dtype != u.dtype or y.dtype not in (torch.float32, torch.bfloat16, torch.float64):
        raise ValueError(f"ttm: y, u must share dtype float32, bfloat16 or float64, got "
                         f"{y.dtype}, {u.dtype}")
    if min(y.stride()) < 0 or min(u.stride()) < 0:
        raise ValueError("ttm: negative strides are not supported")
    dev = y.device  # a CUDA tensor's device always has its index
    if dev.index != torch.cuda.current_device():  # the kernel runs on the current device
        with torch.cuda.device(dev):
            return ttm(y, u, precision=precision)
    (n_l, n_i), n_r = y.shape, u.shape[0]
    odt = torch.float64 if y.dtype == torch.float64 else torch.float32
    out = torch.empty((n_l, n_r), dtype=odt, device=dev)
    if n_l == 0 or n_r == 0 or n_i == 0:
        return out.zero_()
    yp, up = y.data_ptr(), u.data_ptr()
    sy, su = y.stride(), u.stride()
    chunk, n_splits, group, bulk, n_slots, n_tickets = _launch_args(
        n_l, n_i, n_r, sy, su, y.element_size(), (yp | up) % 16 == 0, dev.index)
    slots, tickets = _scratch(dev, n_slots, n_tickets, odt)
    rc = _lib()(yp, sy[0], sy[1], up, su[0], su[1], slots.data_ptr(), tickets.data_ptr(),
                out.data_ptr(), n_l, n_i, n_r, chunk, n_splits, group, bulk,
                _kind(y.dtype), torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"ttm_launch failed: CUDA error {rc}")
    launch_count.count(ttm)
    return out


ttm.launches = 0  # kernel launches since the last reset
