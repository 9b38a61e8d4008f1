"""Blockwise causal GQA attention with an online softmax, on the card.

Port of ``repro.kernels.flash_attention``. :func:`flash_attention` runs
:func:`flash_attention_plain` for CPU tensors and, for CUDA tensors, picks
its kernel by dtype and nothing else (:func:`launch_plan`): bf16 operands
launch the tensor-core kernel of ``csrc/flash_attention_wgmma.cu`` (route
``"wgmma"``), f32 operands the CUDA-core kernel of ``csrc/flash_attention.cu``
(route ``"simt"``). Neither gives way to the other or to the plain version.

The function is the TPU kernel's on operands widened to f32: logits, the
softmax and ``p @ v`` in f32, masked logits set to ``NEG_INF``, the causal
diagonal aligned to the end of the kv axis (query i sees key j iff
``i + (T - S) >= j``), the output in q's dtype. This is also the model's
``gqa_attention``, which widens q, k and v to f32 before the same steps.
"""
from __future__ import annotations

import ctypes
import math
from typing import Optional, Sequence, Tuple

import torch

from repro_torch.kernels import _build, launch_count

NEG_INF = -1e30
# the plain version forms (b, H, rows, T) logits for this many query rows at
# a time, so that it also runs at the serving path's size on the card.
PLAIN_Q_ROWS = 1024
MAX_HEAD_DIM = 128  # both kernels hold an output row's D columns in registers
ROUTES = {torch.bfloat16: "wgmma", torch.float32: "simt"}
TMA_ALIGN = 16  # bytes: TMA's rule for base addresses and strides


def _check_shapes(q_shape, k_shape, v_shape, causal: bool):
    """(b, h, s, d, kvh, t) of fitting q, k, v shapes; raises otherwise."""
    q_shape, k_shape, v_shape = tuple(q_shape), tuple(k_shape), tuple(v_shape)
    if len(q_shape) != 4 or len(k_shape) != 4 or len(v_shape) != 4:
        raise ValueError("flash_attention: q, k, v must be (B, H, S, D), (B, KVH, T, D)")
    b, h, s, d = q_shape
    _, kvh, t, _ = k_shape
    if k_shape != v_shape or k_shape[0] != b or k_shape[3] != d:
        raise ValueError(f"flash_attention: q {q_shape}, k {k_shape} and v {v_shape} do not fit")
    if kvh == 0 or h % kvh:
        raise ValueError(f"flash_attention: {h} query heads are not a multiple of {kvh} kv heads")
    if causal and t < s:
        # the diagonal is aligned to the kv end: a query row before it would
        # see no key at all
        raise ValueError(f"flash_attention: causal attention needs T >= S, got T={t}, S={s}")
    return b, h, s, d, kvh, t


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                          causal: bool = True, scale: Optional[float] = None) -> torch.Tensor:
    """Plain PyTorch version of :func:`flash_attention`: f32 logits, masked
    with ``NEG_INF``, a softmax over the whole kv axis and ``p @ v`` in f32,
    ``PLAIN_Q_ROWS`` query rows at a time."""
    b, h, s, d, kvh, t = _check_shapes(q.shape, k.shape, v.shape, causal)
    g = h // kvh
    scale_ = float(scale) if scale is not None else 1.0 / math.sqrt(d)
    kt = k.to(torch.float32)[:, :, None].transpose(-1, -2)  # (b, kvh, 1, d, t)
    vf = v.to(torch.float32)[:, :, None]  # (b, kvh, 1, t, d)
    kpos = torch.arange(t, device=q.device)
    out = torch.empty((b, h, s, d), dtype=q.dtype, device=q.device)
    for s0 in range(0, s, PLAIN_Q_ROWS):
        rows = min(PLAIN_Q_ROWS, s - s0)
        qc = q[:, :, s0:s0 + rows].to(torch.float32).reshape(b, kvh, g, rows, d)
        logits = (qc @ kt) * scale_  # (b, kvh, g, rows, t)
        if causal:
            qpos = torch.arange(s0, s0 + rows, device=q.device) + (t - s)
            logits = logits.masked_fill(qpos[:, None] < kpos[None, :], NEG_INF)
        p = torch.softmax(logits, dim=-1)
        out[:, :, s0:s0 + rows] = (p @ vf).reshape(b, h, rows, d).to(q.dtype)
    return out


def launch_plan(dtype: torch.dtype, shapes: Sequence[Sequence[int]],
                strides: Sequence[Sequence[int]], addresses: Sequence[int] = (0, 0, 0), *,
                causal: bool = True) -> Tuple[str, Optional[str]]:
    """(route, staging) of the kernel that takes q, k, v of ``dtype`` with
    these shapes, element strides and byte addresses (each given in the
    order q, k, v); raises ``ValueError`` for what no kernel takes.

    The route is the dtype's alone: ``"wgmma"`` for bf16, ``"simt"`` for
    f32. Staging (wgmma only) is ``"tma"`` when every operand meets TMA's
    rules, a 16-byte aligned base and a stride that is a multiple of 16
    bytes on every axis longer than 1, and ``"threads"`` otherwise (the
    producer warp then loads the same tiles with ordinary loads)."""
    if dtype not in ROUTES:
        raise ValueError(f"flash_attention: no kernel for {dtype}; q, k, v must share dtype "
                         f"float32 or bfloat16")
    if len(shapes) != 3 or len(strides) != 3:
        raise ValueError("flash_attention: q, k, v must be (B, H, S, D), (B, KVH, T, D)")
    _, _, _, d, _, t = _check_shapes(*shapes, causal)
    if not 1 <= d <= MAX_HEAD_DIM:
        raise ValueError(f"flash_attention: head dim {d} is outside 1..{MAX_HEAD_DIM}")
    if t == 0:
        raise ValueError("flash_attention: no keys (T = 0)")
    for name, st in zip("qkv", strides):
        if len(st) != 4 or st[3] != 1 or min(st) < 0:
            raise ValueError(f"flash_attention: {name} needs a unit-stride last axis and "
                             f"non-negative strides, got {tuple(st)}")
    route = ROUTES[dtype]
    if route == "simt":
        return route, None
    aligned = all(  # bf16: 2 bytes an element
        addr % TMA_ALIGN == 0
        and all(n == 1 or (2 * st_) % TMA_ALIGN == 0 for n, st_ in zip(shape[:3], st[:3]))
        for shape, st, addr in zip(shapes, strides, addresses))
    return route, ("tma" if aligned else "threads")


def _lib(route: str):
    if route == "wgmma":
        fn = _build.load("flash_attention_wgmma").flash_attention_wgmma_launch
    else:
        fn = _build.load("flash_attention").flash_attention_launch
    if fn.argtypes is None:
        p, ll, i = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
        fn.argtypes = ([p, ll, ll, ll] * 4 + [i] * 7 + [ctypes.c_float, i, p])
        fn.restype = ctypes.c_int
    return fn


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, scale: Optional[float] = None) -> torch.Tensor:
    """Attention output (B, H, S, D) in q's dtype for q (B, H, S, D) and
    k, v (B, KVH, T, D) with H = KVH * G; query head h reads kv head h // G.

    ``scale`` defaults to ``1 / sqrt(D)``. Every tensor is read through its
    strides (the last axis must be unit-stride), so the (b, s, heads, hd)
    projections of the model pass as permuted views without a copy, and the
    output takes q's memory layout. CPU tensors run the plain version; CUDA
    tensors launch the kernel :func:`launch_plan` names or raise.
    """
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal=causal, scale=scale)
    if not q.is_cuda or k.device != q.device or v.device != q.device:
        raise ValueError(f"flash_attention: q on {q.device}, k on {k.device}, v on {v.device}")
    if q.device.index != torch.cuda.current_device():  # kernels run on the current device
        with torch.cuda.device(q.device):
            return flash_attention(q, k, v, causal=causal, scale=scale)
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"flash_attention: q, k, v must share dtype float32 or bfloat16, got "
                         f"{q.dtype}, {k.dtype}, {v.dtype}")
    route, staging = launch_plan(q.dtype, (q.shape, k.shape, v.shape),
                                 (q.stride(), k.stride(), v.stride()),
                                 (q.data_ptr(), k.data_ptr(), v.data_ptr()), causal=causal)
    b, h, s, d = q.shape
    kvh, t = k.shape[1], k.shape[2]
    out = torch.empty_like(q)  # q's strides where q is dense
    if s == 0:
        return out
    if out.stride(3) != 1:
        raise ValueError("flash_attention: out needs a unit-stride last axis")
    scale_ = float(scale) if scale is not None else 1.0 / math.sqrt(d)
    # the last int: bf16 operands for the simt kernel, TMA staging for wgmma
    flag = int(staging == "tma") if route == "wgmma" else 0
    rc = _lib(route)(q.data_ptr(), *q.stride()[:3], k.data_ptr(), *k.stride()[:3],
                     v.data_ptr(), *v.stride()[:3], out.data_ptr(), *out.stride()[:3],
                     b, h, kvh, s, t, d, int(causal), scale_, flag,
                     torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"flash_attention ({route}, {staging}) failed at q {tuple(q.shape)}, "
                           f"k {tuple(k.shape)}: CUDA error {rc}")
    launch_count.count(flash_attention)
    flash_attention.launches_by_route[route] += 1
    return out


# kernel launches since the last reset: in all, and by route
flash_attention.launches = 0
flash_attention.launches_by_route = {"wgmma": 0, "simt": 0}
