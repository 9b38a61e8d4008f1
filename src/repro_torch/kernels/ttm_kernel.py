"""The core TTM, G = Y U^T (paper Alg. 3 / Eq. 12), on the card.

Port of ``repro.kernels.ttm_kernel``. :func:`ttm` launches the one-launch
CUDA kernel of ``csrc/ttm.cu`` for CUDA tensors and runs :func:`ttm_plain`
for CPU tensors; nothing else picks between them. f32 and bf16 operands
give an f32 G, summed on the CUDA cores; f64 operands an f64 G, the
kernel's f64 instantiation, whose products run on the f64 tensor cores
(DMMA; ``kron_kernel.launch_route``).
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


_LAUNCH = None  # the library's ttm_launch, its argument types set


def _lib():
    global _LAUNCH
    if _LAUNCH is None:
        fn = _build.load("ttm").ttm_launch
        ll, i, p = ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p
        fn.argtypes = [p, ll, ll, p, ll, ll, p, p, p, i, i, i, i, i, i, i, i, p]
        fn.restype = ctypes.c_int
        _LAUNCH = fn
    return _LAUNCH


# the current stream of a card as an int, from its index: one C call
# (``torch.cuda.current_stream`` builds a Stream object and resolves the
# device in Python, ~1/3 of the wrapper's host time on an H100's host)
_raw_stream = getattr(torch._C, "_cuda_getCurrentRawStream", None)


def _stream(index: int) -> int:
    if _raw_stream is not None:
        return _raw_stream(index)
    return torch.cuda.current_stream(index).cuda_stream


def occupancy(dev: torch.device, dtype: torch.dtype) -> dict:
    """The launch :func:`ttm` makes on ``dev`` for operands of ``dtype`` (after
    the precision cast), as ``csrc/ttm.cu`` sizes it: ``threads`` a CTA,
    dynamic ``smem_bytes`` a CTA, the kernel's ``registers`` a thread and the
    CTAs one SM holds (``ctas_per_sm``)."""
    fn = _build.load("ttm").ttm_occupancy
    i, pi = ctypes.c_int, ctypes.POINTER(ctypes.c_int)
    fn.argtypes = [i, pi, ctypes.POINTER(ctypes.c_longlong), pi, pi]
    fn.restype = i
    threads, regs, per_sm, smem = i(0), i(0), i(0), ctypes.c_longlong(0)
    with torch.cuda.device(dev):
        rc = fn(_kind(dtype), ctypes.byref(threads), ctypes.byref(smem), ctypes.byref(regs),
                ctypes.byref(per_sm))
    if rc != 0:
        raise RuntimeError(f"ttm_occupancy for {dtype}: CUDA error {rc}")
    return {"threads": threads.value, "smem_bytes": smem.value, "registers": regs.value,
            "ctas_per_sm": per_sm.value}


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


def split_clusters(n_contract: int, tiles: int, cluster: int,
                   max_clusters: int) -> Tuple[int, int, int]:
    """(chunk, n_splits, group) of the f64 instantiation, whose splits are
    combined in clusters of ``cluster`` CTAs (``group`` = ``cluster``): as
    many clusters a tile as the card holds at once (``max_clusters`` over
    the ``tiles``), ``n_splits`` a multiple of ``cluster``, each split's
    range a multiple of 8 contraction indices (one m16n8k8 k-step); the
    splits past I are empty."""
    n = min(cluster * max(1, max_clusters // tiles), -(-n_contract // 8))
    chunk = -(-(-(-n_contract // n)) // 8) * 8
    need = -(-n_contract // chunk)
    return chunk, -(-need // cluster) * cluster, cluster


def _cluster_capacity(index: int) -> Tuple[int, int]:
    """(CTAs a cluster, clusters card ``index`` holds at once) of the f64
    instantiation (``ttm_cluster_capacity``)."""
    fn = _build.load("ttm").ttm_cluster_capacity
    pi = ctypes.POINTER(ctypes.c_int)
    fn.argtypes, fn.restype = [pi, pi], ctypes.c_int
    cluster, most = ctypes.c_int(0), ctypes.c_int(0)
    with torch.cuda.device(index):
        rc = fn(ctypes.byref(cluster), ctypes.byref(most))
    if rc != 0 or most.value < 1:
        raise RuntimeError(f"ttm: no cluster of {cluster.value} f64 CTAs fits card {index} "
                           f"(CUDA error {rc}, {most.value} clusters)")
    return cluster.value, most.value


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
    shapes and layout on card ``index``: host work done once per layout.
    f64 (``esize`` 8) splits by clusters (:func:`split_clusters`), the
    other types by groups (:func:`split`)."""
    tiles = n_tiles(n_l, n_r)
    if esize == 8:
        chunk, n_splits, group = split_clusters(n_i, tiles, *_cluster_capacity(index))
        n_slots = (n_splits // group) * n_l * n_r if n_splits > group else 1
        n_tickets = tiles * group
    else:
        chunk, n_splits, group = split(
            n_i, tiles, torch.cuda.get_device_properties(index).multi_processor_count)
        n_groups = -(-n_splits // group)
        n_slots = (n_splits + n_groups) * n_l * n_r if n_splits > 1 else 1
        n_tickets = tiles * (n_groups + 1)
    return (chunk, n_splits, group, int(_bulk(n_l, n_r, sy, su, esize, aligned)), n_slots,
            n_tickets)


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
                _kind(y.dtype), _stream(dev.index))
    if rc != 0:
        raise RuntimeError(f"ttm_launch failed: CUDA error {rc}")
    launch_count.count(ttm)
    return out


ttm.launches = 0  # kernel launches since the last reset
