"""Blockwise causal GQA attention with an online softmax, on the card.

Port of ``repro.kernels.flash_attention``. :func:`flash_attention` launches
the CUDA kernel of ``csrc/flash_attention.cu`` for CUDA tensors and runs
:func:`flash_attention_plain` for CPU tensors; nothing else picks between
them.

The function is the TPU kernel's on operands widened to f32: logits, the
softmax and ``p @ v`` in f32, masked logits set to ``NEG_INF``, the causal
diagonal aligned to the end of the kv axis (query i sees key j iff
``i + (T - S) >= j``), the output in q's dtype. This is also the model's
``gqa_attention``, which widens q, k and v to f32 before the same steps.
"""
from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from repro_torch.kernels import _build

NEG_INF = -1e30
# the plain version forms (b, H, rows, T) logits for this many query rows at
# a time, so that it also runs at the serving path's size on the card.
PLAIN_Q_ROWS = 1024
MAX_HEAD_DIM = 128  # the kernel keeps D / 16 accumulator columns per thread


def _check_shapes(q, k, v, causal: bool):
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("flash_attention: q, k, v must be (B, H, S, D), (B, KVH, T, D)")
    b, h, s, d = q.shape
    _, kvh, t, _ = k.shape
    if k.shape != v.shape or k.shape[0] != b or k.shape[3] != d:
        raise ValueError(f"flash_attention: q {tuple(q.shape)}, k {tuple(k.shape)} and "
                         f"v {tuple(v.shape)} do not fit")
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
    b, h, s, d, kvh, t = _check_shapes(q, k, v, causal)
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


def _lib():
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
    tensors launch the kernel of ``csrc/flash_attention.cu`` or raise.
    """
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal=causal, scale=scale)
    b, h, s, d, kvh, t = _check_shapes(q, k, v, causal)
    if not q.is_cuda or k.device != q.device or v.device != q.device:
        raise ValueError(f"flash_attention: q on {q.device}, k on {k.device}, v on {v.device}")
    if q.dtype not in (torch.float32, torch.bfloat16) or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"flash_attention: q, k, v must share dtype float32 or bfloat16, got "
                         f"{q.dtype}, {k.dtype}, {v.dtype}")
    if not 1 <= d <= MAX_HEAD_DIM:
        raise ValueError(f"flash_attention: head dim {d} is outside 1..{MAX_HEAD_DIM}")
    if t == 0:
        raise ValueError("flash_attention: no keys (T = 0)")
    out = torch.empty_like(q)  # q's strides where q is dense
    if s == 0:
        return out
    for name, x in (("q", q), ("k", k), ("v", v), ("out", out)):
        if x.stride(3) != 1 or min(x.stride()) < 0:
            raise ValueError(f"flash_attention: {name} needs a unit-stride last axis")
    scale_ = float(scale) if scale is not None else 1.0 / math.sqrt(d)
    fn = _lib()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = fn(q.data_ptr(), *q.stride()[:3], k.data_ptr(), *k.stride()[:3],
                v.data_ptr(), *v.stride()[:3], out.data_ptr(), *out.stride()[:3],
                b, h, kvh, s, t, d, int(causal), scale_, int(q.dtype == torch.bfloat16),
                stream)
    if rc != 0:
        raise RuntimeError(f"flash_attention_launch failed at q {tuple(q.shape)}, "
                           f"k {tuple(k.shape)}: CUDA error {rc}")
    flash_attention.launches += 1
    return out


flash_attention.launches = 0  # kernel launches since the last reset
