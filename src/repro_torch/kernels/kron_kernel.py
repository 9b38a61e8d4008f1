"""The Kronecker module (paper Alg. 4), its scatter into Y_(n) (Eq. 13) and
the fused core update (Eq. 12) on the card.

Port of ``repro.kernels.kron_kernel``, one wrapper per TPU kernel:

  :func:`kron_contrib`            ``contrib[t] = v[t] * (a[t] (x) b[t])``
                                  (``csrc/kron_contrib.cu``);
  :func:`scatter_rows`            the slot-ordered contrib rows summed into
                                  their rows of Y_(n) (``csrc/scatter_rows.cu``);
  :func:`fused_kron_scatter`      both in one pass, ``Y_(n)[row] += v * (a (x) b)``,
                                  a and b read from the factor matrices
                                  through the schedule (``csrc/kron_scatter.cu``);
  :func:`fused_kron_scatter_ttm`  ``G = U^T Y_(n)`` with Y_(n) rebuilt from
                                  the nonzeros and never stored
                                  (``csrc/kron_scatter_ttm.cu``);
  :func:`fused_kron_chain_scatter`  the order >= 4 unfolding, kernels 3 and
                                  4's chain in one pass,
                                  ``Y_(n)[row] += v * (f_1 (x) ... (x) f_{N-1})``
                                  (``csrc/kron_chain_scatter.cu``).

Rb varies fastest in every Kron row. Each wrapper launches its hand-written
CUDA kernel for CUDA tensors and runs its ``*_plain`` twin for CPU tensors;
nothing else picks between them.

Working precision: float32 operands give f32 results, as in the reference.
float64 operands under ``precision="fp32"`` run the kernels' f64
instantiations and give f64 results (the reference's Pallas kernels compute
in f32 whatever the dtype; its XLA engine keeps f64, and the port's card
runs as that engine does); under ``bf16_fp32acc`` they take the bf16 route
with f32 values and results, as the reference's kernels do. Where each
kernel's products run, by dtype and precision (the f64 tensor cores for
kernels 1 and 5 in f64, the bf16 tensor cores for both under
``bf16_fp32acc``), is :func:`launch_route`'s answer. The plain versions keep
the reference's roundings; kernels 1 and 5 and the chain kernel under
``bf16_fp32acc`` give up one of them on the card (the bf16 rounding of each
product a*b before the f32 scale), so their terms differ from the plain
versions' by up to 2^-8 of a term (see :func:`launch_route`).
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional

import torch

from repro_torch.kernels import _build, launch_count
from repro_torch.sparse.layout import build_schedule, slot_rows, visited_row_mask

# mixed-precision axis: "fp32" keeps everything f32; "bf16_fp32acc" loads
# and multiplies the gathered factor rows in bfloat16 while every sum stays
# f32.
PRECISIONS = ("fp32", "bf16_fp32acc")

# the plain version forms at most this many Kron-row entries at once, so
# that it runs at full size without materialising (nnz, K) in one piece.
PLAIN_CHUNK_ELEMS = 1 << 26

DEFAULT_BN = 128  # nonzeros per block
DEFAULT_BI = 128  # output rows per block


class ScatterPlan(NamedTuple):
    """The nonzeros of one mode grouped by output row block, as tensors on
    the device of the rows they were built from: ``order`` permutes the
    nonzeros so that each BN-slot block targets one BI-row block and blocks
    with one target are consecutive (see ``sparse.layout.build_schedule``)."""

    order: torch.Tensor  # (nnz_padded,) int32 gather index into the nonzeros
    valid: torch.Tensor  # (nnz_padded,) f32 1.0 real / 0.0 padding
    rel_row: torch.Tensor  # (nnz_padded,) int32 row within the target block
    blkmap: torch.Tensor  # (n_blocks,) int32 target row block of each nnz block
    first: torch.Tensor  # (n_blocks,) int32 1 iff first block of its target
    last: torch.Tensor  # (n_blocks,) int32 1 iff last block of its target
    n_row_blocks: int
    bn: int
    bi: int
    # keep-mask over output rows; None when every row block is visited.
    row_mask: Optional[torch.Tensor] = None


def build_scatter_plan(rows, n_rows: int, bn: int = DEFAULT_BN,
                       bi: int = DEFAULT_BI) -> ScatterPlan:
    """The :class:`ScatterPlan` of the mode coordinates ``rows`` (numpy or
    torch) of an ``n_rows``-row mode."""
    order, valid, rel, blkmap, first, last, n_row_blocks, _ = build_schedule(
        torch.as_tensor(rows), n_rows, bn, bi)
    return ScatterPlan(order=order, valid=valid, rel_row=rel, blkmap=blkmap, first=first,
                       last=last, n_row_blocks=n_row_blocks, bn=bn, bi=bi,
                       row_mask=visited_row_mask(blkmap, n_row_blocks, bi, n_rows))


def _cast_operands(precision: str, *tensors):
    """Apply the kernel-input side of the precision axis (bf16 loads)."""
    if precision not in PRECISIONS:
        raise ValueError(f"precision must be one of {PRECISIONS}, got {precision!r}")
    if precision == "bf16_fp32acc":
        return tuple(t.to(torch.bfloat16) for t in tensors)
    return tensors


def result_dtype(dtype: torch.dtype, precision: str) -> torch.dtype:
    """The dtype a Kron kernel accumulates and returns for operands of
    ``dtype`` under ``precision``: float64 for f64 operands at ``fp32``,
    else float32 (bf16 operands always sum in f32)."""
    return torch.float64 if dtype == torch.float64 and precision == "fp32" else torch.float32


def _kind(dtype: torch.dtype) -> int:
    """The CUDA sources' operand code: 0 f32, 1 bf16, 2 f64."""
    return {torch.float32: 0, torch.bfloat16: 1, torch.float64: 2}[dtype]


# the datapaths a kernel's products run on (launch_route): the tensor cores
# in TF32 with both operands split in two (three products) or one operand
# exact and the other split (two), the bf16 tensor cores with one operand
# split into two bf16 parts, the f64 tensor cores (DMMA), and the CUDA cores
ROUTES = ("3xtf32", "2xtf32", "bf16_mma", "dmma", "cuda_cores")
# the walk kernels (kron_walk.cuh and the chain kernel's walk), whose f32
# products run on 3xTF32
_WALK_KERNELS = ("fused_kron_scatter", "fused_kron_scatter_ttm", "fused_kron_chain_scatter")
_ROUTED_KERNELS = _WALK_KERNELS + ("ttm", "kron_contrib", "scatter_rows")
# the kernels whose bf16_fp32acc products run on the tensor cores
_BF16_ROUTES = {"fused_kron_scatter": "bf16_mma", "fused_kron_scatter_ttm": "bf16_mma",
                "fused_kron_chain_scatter": "2xtf32"}
# the kernels whose f64 products run on the f64 tensor cores
_F64_DMMA = ("fused_kron_scatter", "fused_kron_scatter_ttm", "ttm")


def launch_route(kernel: str, dtype: torch.dtype, precision: str = "fp32") -> str:
    """The datapath (one of :data:`ROUTES`) on which the CUDA kernel of the
    wrapper named ``kernel`` runs its products for operands of ``dtype``
    under ``precision``, as its source picks it by the operand code:

    * float64 at ``fp32``: ``"dmma"`` for kernel 1 (``fused_kron_scatter``,
      the walk's f64 tensor-core route), kernel 5 (``fused_kron_scatter_ttm``:
      that walk, and its rounds U_j^T Y_j on DMMA too) and kernel 2
      (``ttm``); ``"cuda_cores"`` for the chain kernel
      (``fused_kron_chain_scatter``);
    * float32 at ``fp32``: ``"3xtf32"`` for the three walk kernels,
      ``"cuda_cores"`` for kernel 2;
    * ``bf16_fp32acc`` (either dtype): ``"bf16_mma"`` for kernels 1 and 5
      (the walk on ``mma.sync`` m16n8k16 bf16: A the bf16 factor rows, B v b
      split into bf16 hi + lo; kernel 5's rounds then take U, exact in
      TF32, times Y split into two TF32 parts), ``"2xtf32"`` for the chain
      kernel (A f_1 exact in TF32, B v (f_2 (x) ...) split into two TF32
      parts); all three give up the plain versions' bf16 rounding of each
      product a*b (up to 2^-8 of a term), and sum nearer the exact sum;
      ``"cuda_cores"`` for kernel 2;
    * kernels 3 and 4 (``kron_contrib``, ``scatter_rows``): ``"cuda_cores"``.
    """
    if kernel not in _ROUTED_KERNELS:
        raise ValueError(f"launch_route: unknown kernel {kernel!r}, one of {_ROUTED_KERNELS}")
    if precision not in PRECISIONS:
        raise ValueError(f"precision must be one of {PRECISIONS}, got {precision!r}")
    if dtype not in (torch.float32, torch.float64):
        raise ValueError(f"launch_route: operands must be float32 or float64, got {dtype}")
    if kernel in ("kron_contrib", "scatter_rows"):
        return "cuda_cores"
    if precision == "bf16_fp32acc":
        return _BF16_ROUTES.get(kernel, "cuda_cores")
    if dtype == torch.float64:
        return "dmma" if kernel in _F64_DMMA else "cuda_cores"
    return "3xtf32" if kernel in _WALK_KERNELS else "cuda_cores"


def _mask_unvisited(out: torch.Tensor, sched) -> torch.Tensor:
    """Zero the rows of row blocks that no nnz block targets
    (``sched.row_mask``; ``None`` means every block is visited)."""
    if sched.row_mask is None:
        return out
    return torch.where(sched.row_mask[:, None], out, 0.0)


def fused_kron_scatter_plain(fa, fb, sched, n_rows: int, *,
                             precision: str = "fp32") -> torch.Tensor:
    """Plain PyTorch version of :func:`fused_kron_scatter`: the factor rows
    gathered in the schedule's slot order, then their Kron rows
    ``index_add_``-ed into their rows and the row mask applied. ``fa`` rows
    by ``sched.idx[:, 0]``, ``fb`` rows by ``sched.idx[:, 1]`` (a column of
    ones when ``fb`` is None, the 2-way case)."""
    dt = result_dtype(fa.dtype, precision)
    a = fa.index_select(0, sched.idx[:, 0])
    b = (torch.ones((a.shape[0], 1), dtype=a.dtype, device=a.device) if fb is None
         else fb.index_select(0, sched.idx[:, 1]))
    a, b = _cast_operands(precision, a, b)
    v, k = sched.vals, a.shape[1] * b.shape[1]
    rows = slot_rows(sched)
    out = torch.zeros((sched.n_row_blocks * sched.bi, k), dtype=dt, device=a.device)
    step = max(1, PLAIN_CHUNK_ELEMS // k)
    for s in range(0, a.shape[0], step):
        kron = (a[s:s + step, :, None] * b[s:s + step, None, :]).reshape(-1, k)
        contrib = kron.to(dt) * v[s:s + step, None].to(dt)
        out.index_add_(0, rows[s:s + step], contrib)
    return _mask_unvisited(out[:n_rows], sched)


def _lib():
    lib = _build.load("kron_scatter")
    fn = lib.kron_scatter_launch
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 9 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def occupancy(dev: torch.device, ra: int, rb: int, dtype: torch.dtype,
              precision: str = "fp32") -> dict:
    """The launch :func:`fused_kron_scatter` makes on ``dev`` at ranks
    (``ra``, ``rb``) (``rb`` = 0: a 2-way tensor) for factors of ``dtype``
    under ``precision``, as ``csrc/kron_scatter.cu`` sizes it: ``threads``
    a CTA, dynamic ``smem_bytes`` a CTA, the kernel's ``registers`` a
    thread and the CTAs one SM holds (``ctas_per_sm``). Raises when the
    ranks exceed one warp's staging."""
    kind = _kind(torch.bfloat16 if precision == "bf16_fp32acc" else dtype)
    per16 = 16 // {0: 4, 1: 2, 2: 8}[kind]
    lda, ldb = -(-ra // per16) * per16, -(-rb // per16) * per16
    fn = _build.load("kron_scatter").kron_scatter_occupancy
    i = ctypes.c_int
    fn.argtypes = [i] * 5 + [ctypes.POINTER(i), ctypes.POINTER(ctypes.c_longlong)] + [
        ctypes.POINTER(i)] * 2
    fn.restype = i
    threads, regs, per_sm, smem = i(0), i(0), i(0), ctypes.c_longlong(0)
    with torch.cuda.device(dev):
        rc = fn(ra, max(rb, 1), lda, ldb, kind, ctypes.byref(threads), ctypes.byref(smem),
                ctypes.byref(regs), ctypes.byref(per_sm))
    if rc != 0:
        raise RuntimeError(f"kron_scatter_occupancy at ranks ({ra}, {rb}): CUDA error {rc}")
    return {"threads": threads.value, "smem_bytes": smem.value, "registers": regs.value,
            "ctas_per_sm": per_sm.value}


def _require(cond: bool, msg: str, kernel: str) -> None:
    if not cond:
        raise ValueError(f"{kernel}: {msg}")


def _stream(dev: torch.device) -> int:
    return torch.cuda.current_stream(dev).cuda_stream


def _n_sms(dev: torch.device) -> int:
    return torch.cuda.get_device_properties(dev).multi_processor_count


def _check_schedule(kernel: str, sched, dev: torch.device, nnzp: int):
    """The schedule tensors a segmented-sum kernel reads, checked against
    the slot count ``nnzp``; returns the row split ``parts``."""
    parts = getattr(sched, "parts", None)
    _require(parts is not None, "sched must be a DeviceSchedule (it carries the row split)",
             kernel)
    for name, t in (("rel_row", sched.rel_row), ("blkmap", sched.blkmap), ("parts", parts)):
        _require(t.device == dev, f"{name} on {t.device}, operands on {dev}", kernel)
        _require(t.is_contiguous(), f"{name} must be contiguous", kernel)
    _require(sched.rel_row.shape[0] == nnzp, "operands and rel_row disagree on nnz", kernel)
    _require(nnzp == sched.blkmap.shape[0] * sched.bn, "blkmap does not cover the slots", kernel)
    _require(sched.rel_row.dtype == torch.int32 and sched.blkmap.dtype == torch.int32
             and parts.dtype == torch.int64, "schedule index dtypes must be int32/int64", kernel)
    _require(int(parts.shape[0]) >= 2, "parts must hold at least one range", kernel)
    return parts


def _check_operands(kernel: str, a, b, v, precision: str):
    """Cast ``a`` and ``b`` per ``precision`` and check the gathered operands
    a Kron kernel reads: CUDA, 2-D, one slot count, contiguous, a and b of
    one dtype (float32, bfloat16 or float64). Returns (a, b, v), v in the
    kernel's value dtype (:func:`result_dtype`)."""
    dt = result_dtype(a.dtype, precision)
    a, b = _cast_operands(precision, a, b)
    _require(a.is_cuda, f"unsupported device {a.device}", kernel)
    dev = a.device
    _require(b.device == dev and v.device == dev,
             f"b on {b.device}, v on {v.device}, a on {dev}", kernel)
    _require(a.dim() == 2 and b.dim() == 2 and v.dim() == 1, "a, b must be 2-D and v 1-D",
             kernel)
    _require(b.shape[0] == a.shape[0] and v.shape[0] == a.shape[0],
             "a, b, v disagree on nnz", kernel)
    _require(a.dtype == b.dtype and a.dtype in (torch.float32, torch.bfloat16, torch.float64),
             f"a, b must share dtype float32, bfloat16 or float64, got {a.dtype}, {b.dtype}",
             kernel)
    _require(v.dtype in (torch.float32, torch.float64),
             f"v must be float32 or float64, got {v.dtype}", kernel)
    v = v.to(dt)  # the values in the kernel's dtype (f32 on the bf16 route)
    for name, t in (("a", a), ("b", b), ("v", v)):
        _require(t.is_contiguous(), f"{name} must be contiguous", kernel)
    return a, b, v


def _padded_factor(f: torch.Tensor) -> torch.Tensor:
    """``f`` (I, R), contiguous and 16-byte aligned, its rows zero-padded to
    a multiple of 16 bytes: the kernel gathers them in 16-byte pieces."""
    per16 = 16 // f.element_size()
    pad = (-f.shape[1]) % per16
    if pad:
        f = torch.nn.functional.pad(f, (0, pad))
    f = f.contiguous()
    return f if f.data_ptr() % 16 == 0 else f.clone()


def _slot_data(kernel: str, sched, dev: torch.device, n_cols: int, dtype: torch.dtype,
               precision: str):
    """The schedule's slot coordinates ``sched.idx`` ((nnzp, ``n_cols``)
    int32), values ``sched.vals`` and row split that the walk kernels read,
    checked against the device and the factors' ``dtype``; the values come
    back in :func:`result_dtype` (f32 on the bf16 route). Returns
    ``(idx, vals, parts)``."""
    dt = result_dtype(dtype, precision)
    parts = _check_schedule(kernel, sched, dev, int(sched.rel_row.shape[0]))
    idx, vals = sched.idx, sched.vals
    nnzp = int(idx.shape[0])
    _require(idx.device == dev and vals.device == dev, "sched.idx, sched.vals off the device",
             kernel)
    _require(idx.dtype == torch.int32 and idx.dim() == 2 and idx.is_contiguous()
             and idx.shape[1] == n_cols,
             f"sched.idx must be a contiguous (nnzp, {n_cols}) int32 tensor, "
             f"got {tuple(idx.shape)} {idx.dtype}", kernel)
    _require(vals.dtype in (torch.float32, torch.float64) and vals.is_contiguous()
             and vals.shape == (nnzp,),
             "sched.vals must be a contiguous (nnzp,) float32 or float64 tensor", kernel)
    _require(vals.dtype == dt or precision == "bf16_fp32acc",
             f"sched.vals are {vals.dtype}, the factors {dtype}", kernel)
    _require(nnzp < 2 ** 31, f"{nnzp} slots: the kernel indexes slots with int32", kernel)
    return idx, vals.to(dt), parts


def _schedule_operands(kernel: str, fa, fb, sched, precision: str):
    """Check and prepare what kernels 1 and 5 read: the factor matrices
    ``fa``, ``fb`` (None for a 2-way tensor), 2-D float32 or float64 of one
    dtype on one CUDA device, cast per ``precision`` and padded by
    :func:`_padded_factor`, and the schedule's slot coordinates and values
    (in :func:`result_dtype`: f32 on the bf16 route) and row split. Returns
    ``(pa, pb, idx, vals, parts)``."""
    _require(fa.is_cuda, f"unsupported device {fa.device}", kernel)
    dev = fa.device
    operands = (fa,) if fb is None else (fa, fb)
    _require(all(f.dim() == 2 and f.dtype == fa.dtype and f.device == dev
                 for f in operands) and fa.dtype in (torch.float32, torch.float64),
             "fa, fb must be 2-D float32 or float64 factor matrices of one dtype on one device",
             kernel)
    operands = _cast_operands(precision, *operands)
    idx, vals, parts = _slot_data(kernel, sched, dev, len(operands), fa.dtype, precision)
    pa = _padded_factor(operands[0])
    pb = None if fb is None else _padded_factor(operands[1])
    return pa, pb, idx, vals, parts


def fused_kron_scatter(fa, fb, sched, n_rows: int, *,
                       precision: str = "fp32") -> torch.Tensor:
    """Y_(n) (n_rows, Ra*Rb) f32 with ``Y[row(t)] += v[t] * (a[t] (x) b[t])``.

    ``fa`` (I_a, Ra) and ``fb`` (I_b, Rb) are the two non-mode factor
    matrices, in :func:`~repro_torch.sparse.layout.operand_modes` order;
    ``fb`` is None for a 2-way tensor (b is then a column of ones).
    ``sched`` is a :class:`~repro_torch.sparse.layout.DeviceSchedule` of the
    mode: slot t reads row ``sched.idx[t, 0]`` of fa, row ``sched.idx[t, 1]``
    of fb and the value ``sched.vals[t]``. Under ``bf16_fp32acc`` the
    factor matrices are rounded to bf16 once; the card's products run on
    the bf16 tensor cores (:func:`launch_route`), each term a b v to about
    2^-16, where the plain version rounds a b to bf16 before the scale (up
    to 2^-8 of the term apart). CPU tensors run the plain version; CUDA
    tensors launch the kernel of ``csrc/kron_scatter.cu``, which gathers the
    rows itself, or raise. f64 factors (``fp32``) give an f64 Y, its
    products on the f64 tensor cores (DMMA, :func:`launch_route`) with each
    term fma(round(v a), b, acc), where the plain version rounds round(a b)
    v: about one f64 ulp of a term apart.
    """
    if fa.device.type == "cpu":
        return fused_kron_scatter_plain(fa, fb, sched, n_rows, precision=precision)
    kernel = "fused_kron_scatter"
    pa, pb, idx, vals, parts = _schedule_operands(kernel, fa, fb, sched, precision)
    ra, rb = fa.shape[1], 1 if fb is None else fb.shape[1]
    out = torch.zeros((n_rows, ra * rb), dtype=vals.dtype, device=pa.device)
    if idx.shape[0] == 0:
        return out
    fn = _lib()
    with torch.cuda.device(pa.device):
        rc = fn(pa.data_ptr(), 0 if pb is None else pb.data_ptr(), idx.data_ptr(),
                vals.data_ptr(), sched.rel_row.data_ptr(), sched.blkmap.data_ptr(),
                parts.data_ptr(), out.data_ptr(), int(parts.shape[0]) - 1, ra, rb,
                pa.shape[1], 0 if pb is None else pb.shape[1], int(idx.shape[1]), sched.bn,
                sched.bi, _kind(pa.dtype), _stream(pa.device))
    if rc != 0:
        raise RuntimeError(f"kron_scatter_launch failed at ranks ({ra}, {rb}): CUDA error "
                           f"{rc} (1: the ranks exceed one warp's shared-memory staging)")
    launch_count.count(fused_kron_scatter)
    return out


fused_kron_scatter.launches = 0  # kernel launches since the last reset


# -- kron_contrib: the per-nonzero Kron rows ----------------------------------

_CONTRIB_CTAS_PER_SM = 8  # 256-thread CTAs of the grid-stride loop per SM


def _kron_rows(a, b, v, precision: str) -> torch.Tensor:
    """``v[t] * (a[t] (x) b[t])`` as kernel 3 rounds it: the outer product in
    the operands' dtype (bf16 under ``bf16_fp32acc``), scaled by the value
    in :func:`result_dtype`."""
    dt = result_dtype(a.dtype, precision)
    a, b = _cast_operands(precision, a, b)
    kron = (a[:, :, None] * b[:, None, :]).reshape(a.shape[0], -1)
    return (kron * v.to(dt)[:, None]).to(dt)


def kron_contrib_plain(a, b, v, *, precision: str = "fp32") -> torch.Tensor:
    """Plain PyTorch version of :func:`kron_contrib`: the outer product in
    the operands' dtype (bf16 under ``bf16_fp32acc``), scaled by the value
    in :func:`result_dtype` (f32, or f64 for f64 operands)."""
    return _kron_rows(a, b, v, precision)


def _contrib_lib():
    fn = _build.load("kron_contrib").kron_contrib_launch
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, p, p, p, ctypes.c_longlong, i, i, i, i, p]
        fn.restype = ctypes.c_int
    return fn


def kron_contrib(a, b, v, *, precision: str = "fp32") -> torch.Tensor:
    """contrib (nnz, Ra*Rb) f32 with ``contrib[t] = v[t] * (a[t] (x) b[t])``
    (f64 for f64 operands under ``fp32``).

    ``a`` (nnz, Ra), ``b`` (nnz, Rb), ``v`` (nnz,). Under ``bf16_fp32acc``
    a and b are rounded to bf16 and so is each product a*b before the f32
    scale. CPU tensors run the plain version; CUDA tensors launch the kernel
    of ``csrc/kron_contrib.cu`` or raise.
    """
    if a.device.type == "cpu":
        return kron_contrib_plain(a, b, v, precision=precision)
    a, b, v = _check_operands("kron_contrib", a, b, v, precision)
    dev = a.device
    (nnz, ra), rb = a.shape, b.shape[1]
    out = torch.empty((nnz, ra * rb), dtype=v.dtype, device=dev)
    if nnz == 0:
        return out
    fn = _contrib_lib()
    with torch.cuda.device(dev):
        rc = fn(a.data_ptr(), b.data_ptr(), v.data_ptr(), out.data_ptr(), nnz, ra, rb,
                _kind(a.dtype), _CONTRIB_CTAS_PER_SM * _n_sms(dev), _stream(dev))
    if rc != 0:
        raise RuntimeError(f"kron_contrib_launch failed: CUDA error {rc}")
    launch_count.count(kron_contrib)
    return out


kron_contrib.launches = 0  # kernel launches since the last reset


# -- scatter_rows: slot-ordered rows summed into Y_(n) ------------------------

_SCATTER_THREADS = 64  # 256-column tiles: four float4 columns per thread


def scatter_rows_plain(contrib, sched, n_rows: int) -> torch.Tensor:
    """Plain PyTorch version of :func:`scatter_rows`: ``index_add_`` of the
    slot rows into their rows (in f64 for f64 rows, else f32), then the row
    mask."""
    dt = result_dtype(contrib.dtype, "fp32")
    out = torch.zeros((sched.n_row_blocks * sched.bi, contrib.shape[1]),
                      dtype=dt, device=contrib.device)
    out.index_add_(0, slot_rows(sched), contrib.to(dt))
    return _mask_unvisited(out[:n_rows], sched)


def _scatter_lib():
    fn = _build.load("scatter_rows").scatter_rows_launch
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, p, p, p, p, i, i, i, i, i, i, i, p]
        fn.restype = ctypes.c_int
    return fn


def scatter_rows(contrib, sched, n_rows: int) -> torch.Tensor:
    """Y_(n) (n_rows, K): the rows of ``contrib`` (nnzp, K), f32 or f64,
    already in the schedule's slot order with padding rows zeroed, summed
    into their rows in the rows' dtype; rows no slot reaches are zero. CPU
    tensors run the plain version; CUDA tensors launch the kernel of
    ``csrc/scatter_rows.cu`` or raise.
    """
    if contrib.device.type == "cpu":
        return scatter_rows_plain(contrib, sched, n_rows)
    kernel = "scatter_rows"
    _require(contrib.is_cuda, f"unsupported device {contrib.device}", kernel)
    _require(contrib.dim() == 2 and contrib.dtype in (torch.float32, torch.float64)
             and contrib.is_contiguous(),
             "contrib must be a contiguous 2-D float32 or float64 tensor", kernel)
    dev = contrib.device
    nnzp, k = contrib.shape
    parts = _check_schedule(kernel, sched, dev, nnzp)
    out = torch.zeros((n_rows, k), dtype=contrib.dtype, device=dev)
    if nnzp == 0 or k == 0:
        return out
    vec = int(k % 4 == 0 and contrib.data_ptr() % 16 == 0)
    fn = _scatter_lib()
    with torch.cuda.device(dev):
        rc = fn(contrib.data_ptr(), sched.rel_row.data_ptr(), sched.blkmap.data_ptr(),
                parts.data_ptr(), out.data_ptr(), int(parts.shape[0]) - 1, k, sched.bn,
                sched.bi, vec, _SCATTER_THREADS, int(contrib.dtype == torch.float64),
                _stream(dev))
    if rc != 0:
        raise RuntimeError(f"scatter_rows_launch failed: CUDA error {rc}")
    launch_count.count(scatter_rows)
    return out


scatter_rows.launches = 0  # kernel launches since the last reset


# -- fused_kron_scatter_ttm: the core update with Y never stored ---------------


def fused_kron_scatter_ttm_plain(fa, fb, u, sched, n_rows: int, *,
                                 precision: str = "fp32") -> torch.Tensor:
    """Plain PyTorch version of :func:`fused_kron_scatter_ttm`: Y_(n) by
    :func:`fused_kron_scatter_plain`, then ``U^T Y`` in Y's dtype (f32, or
    f64 for f64 operands) with U rounded to bf16 first under
    ``bf16_fp32acc``."""
    y = fused_kron_scatter_plain(fa, fb, sched, n_rows, precision=precision)
    (uc,) = _cast_operands(precision, u.to(y.dtype))
    return uc.to(y.dtype).T @ y


def _mega_lib():
    lib = _build.load("kron_scatter_ttm")
    fn, grid = lib.kron_scatter_ttm_launch, lib.kron_scatter_ttm_grid
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p] * 10 + [i] * 11 + [p]
        fn.restype = ctypes.c_int
        grid.argtypes = ([i] * 7 + [ctypes.POINTER(i)] * 4
                         + [ctypes.POINTER(ctypes.c_longlong), ctypes.POINTER(i)])
        grid.restype = ctypes.c_int
    return fn, grid


def mega_grid(dev: torch.device, ra: int, rb: int, lda: int, ldb: int, r: int, kind: int,
              n_parts: int) -> dict:
    """The megakernel's first-pass grid for ``n_parts`` row ranges, as
    ``csrc/kron_scatter_ttm.cu`` computes it from the ranks, the padded
    factor row lengths ``lda`` and ``ldb`` (0 for a 2-way tensor), R and
    the operand code ``kind`` (:func:`_kind`: 0 f32, 1 bf16, 2 f64):
    ``threads`` per CTA, the CTAs one SM holds (``ctas_per_sm``), ``n_ctas``
    CTAs of ``per_cta`` ranges each, ``smem_bytes`` per CTA and the first
    pass's ``registers`` a thread. Raises when no CTA fits an SM."""
    _, fn = _mega_lib()
    ints = [ctypes.c_int(0) for _ in range(4)]
    smem, regs = ctypes.c_longlong(0), ctypes.c_int(0)
    with torch.cuda.device(dev):
        rc = fn(ra, rb, lda, ldb, r, kind, n_parts, *(ctypes.byref(x) for x in ints),
                ctypes.byref(smem), ctypes.byref(regs))
    grid = dict(zip(("threads", "ctas_per_sm", "n_ctas", "per_cta"), (x.value for x in ints)),
                smem_bytes=smem.value, registers=regs.value)
    if rc != 0:
        raise RuntimeError(f"fused_kron_scatter_ttm: no launch for R = {r} at ranks "
                           f"({ra}, {rb}), {grid}: CUDA error {rc} (1: the staging, the held "
                           f"rows and the (R, K) partial do not fit an SM's shared memory)")
    return grid


def fused_kron_scatter_ttm(fa, fb, u, sched, n_rows: int, *,
                           precision: str = "fp32") -> torch.Tensor:
    """G (R, Ra*Rb) = U^T Y_(n), where ``Y[row(t)] += v[t] * (a[t] (x) b[t])``
    is rebuilt row by row from the nonzeros and never stored.

    ``fa``, ``fb`` and ``sched`` as for :func:`fused_kron_scatter` (the
    factor rows are read through the schedule); ``u`` is the (n_rows, R)
    factor of the schedule's mode, of ``fa``'s dtype, rounded to bf16 with
    ``fa`` and ``fb`` under ``bf16_fp32acc``. G is f32, or f64 for f64
    operands at ``fp32`` (:func:`result_dtype`). The walk and the
    contraction run on the tensor cores in every precision: 3xTF32 in f32,
    DMMA in f64, bf16 m16n8k16 and 2xTF32 under ``bf16_fp32acc``, whose
    terms keep each product a*b unrounded (:func:`launch_route`). The first
    pass runs as many
    CTAs as the card holds at once, each taking a run of the row split's
    ranges. CPU tensors run the plain version; CUDA tensors launch the
    kernels of ``csrc/kron_scatter_ttm.cu`` or raise.
    """
    if fa.device.type == "cpu":
        return fused_kron_scatter_ttm_plain(fa, fb, u, sched, n_rows, precision=precision)
    kernel = "fused_kron_scatter_ttm"
    pa, pb, idx, vals, parts = _schedule_operands(kernel, fa, fb, sched, precision)
    dev = pa.device
    _require(u.device == dev and u.dim() == 2 and u.shape[0] == n_rows
             and u.dtype == fa.dtype,
             f"u must be ({n_rows}, R) {fa.dtype} on {dev}, got {tuple(u.shape)} {u.dtype} on "
             f"{u.device}", kernel)
    (u,) = _cast_operands(precision, u)
    u = u.contiguous()
    ra, rb, r = fa.shape[1], 1 if fb is None else fb.shape[1], u.shape[1]
    out = torch.zeros((r, ra * rb), dtype=vals.dtype, device=dev)
    if idx.shape[0] == 0 or r == 0:
        return out
    kind = _kind(pa.dtype)
    lda, ldb = pa.shape[1], 0 if pb is None else pb.shape[1]
    n_parts = int(parts.shape[0]) - 1
    grid = mega_grid(dev, ra, rb, lda, ldb, r, kind, n_parts)
    part = torch.empty((grid["n_ctas"], r, ra * rb), dtype=vals.dtype, device=dev)
    fn, _ = _mega_lib()
    with torch.cuda.device(dev):
        rc = fn(pa.data_ptr(), 0 if pb is None else pb.data_ptr(), idx.data_ptr(),
                vals.data_ptr(), sched.rel_row.data_ptr(), sched.blkmap.data_ptr(),
                parts.data_ptr(), u.data_ptr(), part.data_ptr(), out.data_ptr(), n_parts,
                grid["per_cta"], ra, rb, lda, ldb, int(idx.shape[1]), sched.bn, sched.bi, r,
                kind, _stream(dev))
    if rc != 0:
        raise RuntimeError(f"kron_scatter_ttm_launch failed: CUDA error {rc}")
    launch_count.count(fused_kron_scatter_ttm)
    return out


fused_kron_scatter_ttm.launches = 0  # kernel launches since the last reset


# -- fused_kron_chain_scatter: the order >= 4 unfolding in one pass ------------

# operand factors (N - 1) the kernel is compiled for, orders 4 to 6
# (csrc/kron_chain_scatter.cu, kMaxOps); ops routes higher orders to the
# chain of kernels 3 and 4
MAX_CHAIN_OPERANDS = 5


def fused_kron_chain_scatter_plain(factors, sched, n_rows: int, *,
                                   precision: str = "fp32") -> torch.Tensor:
    """Plain PyTorch version of :func:`fused_kron_chain_scatter`: kernels 3
    and 4's chain of plain versions on slot chunks of at most
    ``PLAIN_CHUNK_ELEMS`` Kron entries. Each chunk's factor rows are
    gathered through ``sched.idx``, their Kron rows formed link by link with
    the chain's roundings (``precision`` on the first link, later links at
    fp32 in its result dtype) and ``index_add_``-ed into their rows in slot
    order, then the row mask is applied: on the CPU the bits of
    ``kron_contrib_plain`` chained into ``scatter_rows_plain``."""
    dt = result_dtype(factors[0].dtype, precision)
    k = 1
    for f in factors:
        k *= f.shape[1]
    dev = factors[0].device
    out = torch.zeros((sched.n_row_blocks * sched.bi, k), dtype=dt, device=dev)
    rows, nnzp = slot_rows(sched), int(sched.idx.shape[0])
    step = max(1, PLAIN_CHUNK_ELEMS // k)
    for s in range(0, nnzp, step):
        ix, v = sched.idx[s:s + step], sched.vals[s:s + step]
        got = [f.index_select(0, ix[:, c]) for c, f in enumerate(factors)]
        contrib = _kron_rows(got[0], got[1], v, precision)
        for extra in got[2:]:
            contrib = _kron_rows(contrib, extra.to(contrib.dtype),
                                 torch.ones_like(v, dtype=contrib.dtype), "fp32")
        out.index_add_(0, rows[s:s + step], contrib)
    return _mask_unvisited(out[:n_rows], sched)


def _chain_lib():
    fn = _build.load("kron_chain_scatter").kron_chain_scatter_launch
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = ([ctypes.POINTER(ctypes.c_void_p), ctypes.POINTER(i), ctypes.POINTER(i), i]
                       + [p] * 5 + [i] + [p] * 3 + [i] * 3 + [p])
        fn.restype = ctypes.c_int
    return fn


def _chain_operands(kernel: str, factors, sched, precision: str):
    """Check and prepare what the chain kernel reads: 3 to
    ``MAX_CHAIN_OPERANDS`` 2-D float32 or float64 factor matrices of one
    dtype on one CUDA device, cast per ``precision`` (under
    ``bf16_fp32acc`` the first two to bf16, the later ones to f32, as the
    chain's later links take them) and padded by :func:`_padded_factor`;
    the schedule's slot coordinates, values (in :func:`result_dtype`) and
    cached equal-length cuts. Returns ``(padded, idx, vals, cuts)``."""
    factors = list(factors)
    _require(len(factors) > 0 and factors[0].is_cuda,
             f"unsupported device {factors[0].device if factors else None}", kernel)
    dev, dtype = factors[0].device, factors[0].dtype
    _require(3 <= len(factors) <= MAX_CHAIN_OPERANDS,
             f"{len(factors)} operand factors: the kernel takes 3 to {MAX_CHAIN_OPERANDS} "
             f"(orders 4 to {MAX_CHAIN_OPERANDS + 1})", kernel)
    _require(all(f.dim() == 2 and f.dtype == dtype and f.device == dev for f in factors)
             and dtype in (torch.float32, torch.float64),
             "factors must be 2-D float32 or float64 matrices of one dtype on one device", kernel)
    dt = result_dtype(dtype, precision)
    factors = list(_cast_operands(precision, *factors[:2])) + [f.to(dt) for f in factors[2:]]
    idx, vals, _ = _slot_data(kernel, sched, dev, len(factors), dtype, precision)
    cuts = getattr(sched, "chain_cuts", None)
    _require(cuts is not None and cuts.device == dev and cuts.dtype == torch.int64
             and cuts.dim() == 1 and cuts.is_contiguous() and cuts.shape[0] >= 2,
             "sched.chain_cuts must be the schedule's (n_ranges + 1,) int64 cuts on the "
             "device (DeviceSchedule.from_layout builds them for order >= 4)", kernel)
    return [_padded_factor(f) for f in factors], idx, vals, cuts


def fused_kron_chain_scatter(factors, sched, n_rows: int, *,
                             precision: str = "fp32") -> torch.Tensor:
    """Y_(n) (n_rows, K) of an order-N tensor, ``N - 1 = len(factors)`` >= 3,
    with ``Y[row(t)] += v[t] * (f_1[t] (x) ... (x) f_{N-1}[t])`` (the last
    factor fastest, K the product of their ranks): kernels 3 and 4's chain
    in one pass, with no (nnz, R) gather and no (nnz, K) contrib.

    ``factors`` are the non-mode factor matrices in
    :func:`~repro_torch.sparse.layout.operand_modes` order; ``sched`` is a
    :class:`~repro_torch.sparse.layout.DeviceSchedule` of the mode: slot t
    reads row ``sched.idx[t, f]`` of factor f and the value
    ``sched.vals[t]``, and the kernel splits the slots at
    ``sched.chain_cuts``. ``precision`` casts as the chain does: under
    ``bf16_fp32acc`` f_1 and f_2 in bf16, the later factors in f32 (the
    reference's later links run at fp32); the plain version also rounds
    f_1 f_2 to bf16, which the card's 2xTF32 products do not (up to 2^-8
    of a term apart, :func:`launch_route`). f64 factors at ``fp32`` give an
    f64 Y, summed on the CUDA cores. CPU tensors run the plain version;
    CUDA tensors launch the kernels of ``csrc/kron_chain_scatter.cu`` (the
    ranges, then the in-order sum of the rows they share) or raise. The
    kernel is compiled for 3 to ``MAX_CHAIN_OPERANDS`` factors (orders 4 to
    6); :func:`repro_torch.kernels.ops.sparse_ttm_chain_device` sends higher
    orders to the chain of kernels 3 and 4.
    """
    if factors[0].device.type == "cpu":
        return fused_kron_chain_scatter_plain(factors, sched, n_rows, precision=precision)
    kernel = "fused_kron_chain_scatter"
    padded, idx, vals, cuts = _chain_operands(kernel, factors, sched, precision)
    ranks = [int(f.shape[1]) for f in factors]
    k = 1
    for r in ranks:
        k *= r
    dev = padded[0].device
    out = torch.zeros((n_rows, k), dtype=vals.dtype, device=dev)
    n_ranges = int(cuts.shape[0]) - 1
    part = torch.empty((2 * n_ranges, k), dtype=vals.dtype, device=dev)
    part_rows = torch.empty((2 * n_ranges,), dtype=torch.int32, device=dev)
    m = len(padded)
    ptrs = (ctypes.c_void_p * m)(*[f.data_ptr() for f in padded])
    c_ranks = (ctypes.c_int * m)(*ranks)
    c_lds = (ctypes.c_int * m)(*[int(f.shape[1]) for f in padded])
    fn = _chain_lib()
    with torch.cuda.device(dev):
        rc = fn(ptrs, c_ranks, c_lds, m, idx.data_ptr(), vals.data_ptr(),
                sched.rel_row.data_ptr(), sched.blkmap.data_ptr(), cuts.data_ptr(), n_ranges,
                out.data_ptr(), part.data_ptr(), part_rows.data_ptr(), sched.bn, sched.bi,
                _kind(padded[0].dtype), _stream(dev))
    if rc != 0:
        raise RuntimeError(f"kron_chain_scatter_launch failed at ranks {ranks}: CUDA error "
                           f"{rc} (1: the ranks exceed one warp's shared-memory staging)")
    launch_count.count(fused_kron_chain_scatter)
    return out


fused_kron_chain_scatter.launches = 0  # kernel launches since the last reset
