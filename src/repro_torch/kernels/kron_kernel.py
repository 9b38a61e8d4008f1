"""The fused Kron-scatter unfolding (paper Alg. 4 + Eq. 13) on the card.

Port of the fused kernel of ``repro.kernels.kron_kernel``:
``Y_(n)[row] += v * (a (x) b)`` (Rb fastest) over the schedule-ordered
nonzeros of one mode. :func:`fused_kron_scatter` launches the hand-written
CUDA kernel of ``csrc/kron_scatter.cu`` for CUDA tensors and runs
:func:`fused_kron_scatter_plain` for CPU tensors; nothing else picks
between them.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.sparse.layout import slot_rows

# mixed-precision axis: "fp32" keeps everything f32; "bf16_fp32acc" loads
# and multiplies the gathered factor rows in bfloat16 while every sum stays
# f32.
PRECISIONS = ("fp32", "bf16_fp32acc")

# the plain version forms at most this many Kron-row entries at once, so
# that it runs at full size without materialising (nnz, K) in one piece.
PLAIN_CHUNK_ELEMS = 1 << 26

_MAX_CHUNK = 64  # schedule slots staged in shared memory per step
_SMEM_LIMIT = 48 * 1024  # static launch limit, no opt-in attribute


def _cast_operands(precision: str, *tensors):
    """Apply the kernel-input side of the precision axis (bf16 loads)."""
    if precision not in PRECISIONS:
        raise ValueError(f"precision must be one of {PRECISIONS}, got {precision!r}")
    if precision == "bf16_fp32acc":
        return tuple(t.to(torch.bfloat16) for t in tensors)
    return tensors


def _mask_unvisited(out: torch.Tensor, sched) -> torch.Tensor:
    """Zero the rows of row blocks that no nnz block targets
    (``sched.row_mask``; ``None`` means every block is visited)."""
    if sched.row_mask is None:
        return out
    return torch.where(sched.row_mask[:, None], out, 0.0)


def fused_kron_scatter_plain(a, b, v, sched, n_rows: int, *,
                             precision: str = "fp32") -> torch.Tensor:
    """Plain PyTorch version of :func:`fused_kron_scatter`: Kron rows in the
    schedule's gather order, ``index_add_`` into their rows, then the row
    mask."""
    a, b = _cast_operands(precision, a, b)
    k = a.shape[1] * b.shape[1]
    rows = slot_rows(sched)
    out = torch.zeros((sched.n_row_blocks * sched.bi, k), dtype=torch.float32,
                      device=a.device)
    step = max(1, PLAIN_CHUNK_ELEMS // k)
    for s in range(0, a.shape[0], step):
        kron = (a[s:s + step, :, None] * b[s:s + step, None, :]).reshape(-1, k)
        contrib = kron.to(torch.float32) * v[s:s + step, None].to(torch.float32)
        out.index_add_(0, rows[s:s + step], contrib)
    return _mask_unvisited(out[:n_rows], sched)


def _lib():
    lib = _build.load("kron_scatter")
    fn = lib.kron_scatter_launch
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 8 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def _require(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(f"fused_kron_scatter: {msg}")


def fused_kron_scatter(a, b, v, sched, n_rows: int, *,
                       precision: str = "fp32") -> torch.Tensor:
    """Y_(n) (n_rows, Ra*Rb) f32 with ``Y[row(t)] += v[t] * (a[t] (x) b[t])``.

    ``a`` (nnzp, Ra), ``b`` (nnzp, Rb) and ``v`` (nnzp,) are already in the
    schedule's slot order with padding values zeroed
    (``ops._gathered_block_rows``); ``sched`` is a
    :class:`~repro_torch.sparse.layout.DeviceSchedule` of the same mode.
    CPU tensors run the plain version; CUDA tensors launch the kernel of
    ``csrc/kron_scatter.cu`` or raise.
    """
    if a.device.type == "cpu":
        return fused_kron_scatter_plain(a, b, v, sched, n_rows, precision=precision)
    a, b = _cast_operands(precision, a, b)
    _require(a.is_cuda, f"unsupported device {a.device}")
    parts = getattr(sched, "parts", None)
    _require(parts is not None, "sched must be a DeviceSchedule (it carries the row split)")
    dev = a.device
    for name, t in (("b", b), ("v", v), ("rel_row", sched.rel_row),
                    ("blkmap", sched.blkmap), ("parts", parts)):
        _require(t.device == dev, f"{name} on {t.device}, a on {dev}")
    _require(a.dim() == 2 and b.dim() == 2 and v.dim() == 1, "a, b must be 2-D and v 1-D")
    nnzp, ra = a.shape
    rb = b.shape[1]
    _require(b.shape[0] == nnzp and v.shape[0] == nnzp
             and sched.rel_row.shape[0] == nnzp, "a, b, v, rel_row disagree on nnz")
    _require(nnzp == sched.blkmap.shape[0] * sched.bn, "blkmap does not cover the slots")
    _require(a.dtype == b.dtype and a.dtype in (torch.float32, torch.bfloat16),
             f"a, b must share dtype float32 or bfloat16, got {a.dtype}, {b.dtype}")
    _require(v.dtype == torch.float32, f"v must be float32, got {v.dtype}")
    _require(sched.rel_row.dtype == torch.int32 and sched.blkmap.dtype == torch.int32
             and parts.dtype == torch.int64, "schedule index dtypes must be int32/int64")
    for name, t in (("a", a), ("b", b), ("v", v), ("rel_row", sched.rel_row),
                    ("blkmap", sched.blkmap), ("parts", parts)):
        _require(t.is_contiguous(), f"{name} must be contiguous")
    _require(int(parts.shape[0]) >= 2, "parts must hold at least one range")
    ra4 = -(-ra // 4) * 4
    chunk = min(_MAX_CHUNK, _SMEM_LIMIT // ((ra4 + rb + 2) * 4))
    _require(chunk >= 1, f"ranks ({ra}, {rb}) exceed the kernel's shared-memory staging")
    n_items = (ra4 // 4) * rb
    threads = min(256, -(-n_items // 32) * 32)
    out = torch.zeros((n_rows, ra * rb), dtype=torch.float32, device=dev)
    if nnzp == 0:
        return out
    fn = _lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = fn(a.data_ptr(), b.data_ptr(), v.data_ptr(), sched.rel_row.data_ptr(),
                sched.blkmap.data_ptr(), parts.data_ptr(), out.data_ptr(),
                int(parts.shape[0]) - 1, ra, rb, sched.bn, sched.bi,
                int(a.dtype == torch.bfloat16), threads, chunk, stream)
    if rc != 0:
        raise RuntimeError(f"kron_scatter_launch failed: CUDA error {rc}")
    fused_kron_scatter.launches += 1
    return out


fused_kron_scatter.launches = 0  # kernel launches since the last reset
