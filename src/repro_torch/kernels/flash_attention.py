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

Training differentiates through :class:`FlashAttention`, an
``autograd.Function``: :func:`flash_attention` takes it when grad mode is on
and an operand requires grad. Its forward launches the same kernel with an
extra output, each query row's log-sum-exp; its backward is
:func:`flash_attention_bwd`, which on the card picks its kernels by dtype as
the forward does (:func:`bwd_launch_plan`): bf16 launches the tensor-core
kernels of ``csrc/flash_attention_bwd_wgmma.cu`` (route ``"wgmma"``), f32
the CUDA-core kernels of ``csrc/flash_attention_bwd.cu`` (route ``"simt"``);
on the CPU it runs :func:`flash_attention_bwd_plain`. Under
``torch.no_grad()`` (serving) nothing changes: the same kernel, no
log-sum-exp, one launch a call.
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
BWD_ROW_PAD = 128  # the wgmma backward's scratch rows a (b, head): S rounded up to this


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


def _acc_dtype(x: torch.Tensor) -> torch.dtype:
    """What the plain versions compute in: f32, or f64 for f64 operands
    (``torch.autograd.gradcheck``)."""
    return torch.float64 if x.dtype == torch.float64 else torch.float32


def _masked(logits: torch.Tensor, s0: int, s: int, t: int, fill: float) -> torch.Tensor:
    """``logits`` (..., rows, t) of query rows s0.. with ``fill`` above the
    causal diagonal (aligned to the end of the kv axis)."""
    rows = logits.shape[-2]
    qpos = torch.arange(s0, s0 + rows, device=logits.device) + (t - s)
    kpos = torch.arange(t, device=logits.device)
    return logits.masked_fill(qpos[:, None] < kpos[None, :], fill)


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                          causal: bool = True, scale: Optional[float] = None,
                          return_lse: bool = False):
    """Plain PyTorch version of :func:`flash_attention`: f32 logits (f64 for
    f64 operands), masked with ``NEG_INF``, a softmax over the whole kv axis
    and ``p @ v`` in f32, ``PLAIN_Q_ROWS`` query rows at a time. With
    ``return_lse`` also each row's log-sum-exp of the scaled logits (B, H,
    S), in f32 (f64): what the kernels' forward saves for the backward."""
    b, h, s, d, kvh, t = _check_shapes(q.shape, k.shape, v.shape, causal)
    g = h // kvh
    acc = _acc_dtype(q)
    scale_ = float(scale) if scale is not None else 1.0 / math.sqrt(d)
    kt = k.to(acc)[:, :, None].transpose(-1, -2)  # (b, kvh, 1, d, t)
    vf = v.to(acc)[:, :, None]  # (b, kvh, 1, t, d)
    out = torch.empty((b, h, s, d), dtype=q.dtype, device=q.device)
    lse = torch.empty((b, h, s), dtype=acc, device=q.device) if return_lse else None
    for s0 in range(0, s, PLAIN_Q_ROWS):
        rows = min(PLAIN_Q_ROWS, s - s0)
        qc = q[:, :, s0:s0 + rows].to(acc).reshape(b, kvh, g, rows, d)
        logits = (qc @ kt) * scale_  # (b, kvh, g, rows, t)
        if causal:
            logits = _masked(logits, s0, s, t, NEG_INF)
        p = torch.softmax(logits, dim=-1)
        out[:, :, s0:s0 + rows] = (p @ vf).reshape(b, h, rows, d).to(q.dtype)
        if lse is not None:
            lse[:, :, s0:s0 + rows] = torch.logsumexp(logits, dim=-1).reshape(b, h, rows)
    return (out, lse) if return_lse else out


def flash_attention_bwd_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                              out: torch.Tensor, lse: torch.Tensor, dout: torch.Tensor,
                              causal: bool = True, scale: Optional[float] = None):
    """Plain PyTorch version of :func:`flash_attention_bwd`, in f32 (f64 for
    f64 operands), ``PLAIN_Q_ROWS`` query rows at a time: P recomputed from
    q, k and ``lse``, ``delta = rowsum(dout o out)``, ``dS = P (dP -
    delta)``; dV and dK summed over each kv head's G query heads. Returns
    (dq, dk, dv) in the operands' dtypes."""
    b, h, s, d, kvh, t = _check_shapes(q.shape, k.shape, v.shape, causal)
    g = h // kvh
    acc = _acc_dtype(q)
    scale_ = float(scale) if scale is not None else 1.0 / math.sqrt(d)
    kf = k.to(acc)[:, :, None]  # (b, kvh, 1, t, d)
    vf = v.to(acc)[:, :, None]
    dq = torch.empty((b, h, s, d), dtype=q.dtype, device=q.device)
    dk = torch.zeros((b, kvh, t, d), dtype=acc, device=q.device)
    dv = torch.zeros((b, kvh, t, d), dtype=acc, device=q.device)

    def rows_of(x, s0, rows):
        return x[:, :, s0:s0 + rows].to(acc).reshape(b, kvh, g, rows, -1)

    for s0 in range(0, s, PLAIN_Q_ROWS):
        rows = min(PLAIN_Q_ROWS, s - s0)
        qc, oc, doc = (rows_of(x, s0, rows) for x in (q, out, dout))
        lc = lse[:, :, s0:s0 + rows].to(acc).reshape(b, kvh, g, rows, 1)
        p = torch.exp((qc @ kf.transpose(-1, -2)) * scale_ - lc)  # (b, kvh, g, rows, t)
        if causal:
            p = _masked(p, s0, s, t, 0.0)
        dv += (p.transpose(-1, -2) @ doc).sum(dim=2)
        dp = doc @ vf.transpose(-1, -2)
        ds = p * (dp - (doc * oc).sum(dim=-1, keepdim=True))
        dq[:, :, s0:s0 + rows] = ((ds @ kf) * scale_).reshape(b, h, rows, d).to(q.dtype)
        dk += (ds.transpose(-1, -2) @ qc).sum(dim=2) * scale_
    return dq, dk.to(k.dtype), dv.to(v.dtype)


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
    return route, _staging(shapes, strides, addresses)


def _staging(shapes, strides, addresses) -> str:
    """``"tma"`` when every bf16 operand has a 16-byte aligned base and a
    stride that is a multiple of 16 bytes on every axis longer than 1 (TMA's
    rules), else ``"threads"``."""
    aligned = all(  # bf16: 2 bytes an element
        addr % TMA_ALIGN == 0
        and all(n == 1 or (2 * st_) % TMA_ALIGN == 0 for n, st_ in zip(shape[:3], st[:3]))
        for shape, st, addr in zip(shapes, strides, addresses))
    return "tma" if aligned else "threads"


def bwd_launch_plan(dtype: torch.dtype, shapes: Sequence[Sequence[int]],
                    strides: Sequence[Sequence[int]], addresses: Sequence[int] = (0, 0, 0, 0),
                    *, causal: bool = True) -> Tuple[str, Optional[str]]:
    """(route, staging) of the backward kernels for q, k, v and dout of
    ``dtype`` with these shapes, element strides and byte addresses (each
    given in the order q, k, v, dout); raises ``ValueError`` for what no
    kernel takes. The route is the dtype's, as the forward's: ``"wgmma"``
    (``csrc/flash_attention_bwd_wgmma.cu``) for bf16, ``"simt"``
    (``csrc/flash_attention_bwd.cu``) for f32. Staging (wgmma only) is
    ``"tma"`` when all four operands meet TMA's rules, else ``"threads"``."""
    if len(shapes) != 4 or len(strides) != 4:
        raise ValueError("flash_attention_bwd: q, k, v, dout must be (B, H, S, D), "
                         "(B, KVH, T, D), (B, KVH, T, D), (B, H, S, D)")
    route, _ = launch_plan(dtype, shapes[:3], strides[:3], causal=causal)
    if tuple(shapes[3]) != tuple(shapes[0]):
        raise ValueError(f"flash_attention_bwd: dout {tuple(shapes[3])}, want {tuple(shapes[0])}")
    st = strides[3]
    if len(st) != 4 or st[3] != 1 or min(st) < 0:
        raise ValueError(f"flash_attention_bwd: dout needs a unit-stride last axis and "
                         f"non-negative strides, got {tuple(st)}")
    if route == "simt":
        return route, None
    return route, _staging(shapes, strides, addresses)


def _lib(route: str):
    if route == "wgmma":
        fn = _build.load("flash_attention_wgmma").flash_attention_wgmma_launch
    else:
        fn = _build.load("flash_attention").flash_attention_launch
    if fn.argtypes is None:
        p, ll, i = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
        fn.argtypes = ([p, ll, ll, ll] * 4 + [i] * 7 + [ctypes.c_float, i, p, p])
        fn.restype = ctypes.c_int
    return fn


def _bwd_lib(route: str):
    p, i = ctypes.c_void_p, ctypes.c_int
    if route == "wgmma":
        fn = _build.load("flash_attention_bwd_wgmma").flash_attention_bwd_wgmma_launch
        args = [p] * 11 + [i] * 7 + [ctypes.c_float, i, p]
    else:
        fn = _build.load("flash_attention_bwd").flash_attention_bwd_launch
        args = [p] * 10 + [i] * 7 + [ctypes.c_float, i, p]
    if fn.argtypes is None:
        fn.argtypes = args
        fn.restype = ctypes.c_int
    return fn


def bwd_scratch_floats(b: int, h: int, s: int) -> int:
    """Floats of the wgmma route's scratch: each row's lse log2(e) and
    delta, ``BWD_ROW_PAD``-padded rows a (b, head)."""
    return 2 * b * h * (-(-s // BWD_ROW_PAD) * BWD_ROW_PAD)


def _check_card(name: str, *tensors: torch.Tensor) -> None:
    dev = tensors[0].device
    if not tensors[0].is_cuda or any(t.device != dev for t in tensors):
        raise ValueError(f"{name}: operands on " + ", ".join(str(t.device) for t in tensors))


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, scale: Optional[float] = None) -> torch.Tensor:
    """Attention output (B, H, S, D) in q's dtype for q (B, H, S, D) and
    k, v (B, KVH, T, D) with H = KVH * G; query head h reads kv head h // G.

    ``scale`` defaults to ``1 / sqrt(D)``. Every tensor is read through its
    strides (the last axis must be unit-stride), so the (b, s, heads, hd)
    projections of the model pass as permuted views without a copy, and the
    output takes q's memory layout. CPU tensors run the plain version; CUDA
    tensors launch the kernel :func:`launch_plan` names or raise. With grad
    mode on and an operand that requires grad the call goes through
    :class:`FlashAttention`, and the gradient through
    :func:`flash_attention_bwd`.
    """
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
        return FlashAttention.apply(q, k, v, causal, scale)
    return _forward(q, k, v, causal, scale, want_lse=False)[0]


def _forward(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool,
             scale: Optional[float], want_lse: bool):
    """(out, the rows' log-sum-exp or None) of :func:`flash_attention`: the
    plain version on the CPU, else one launch of the kernel of
    :func:`launch_plan`, which writes the log-sum-exp too when asked."""
    if q.device.type == "cpu":
        if want_lse:
            return flash_attention_plain(q, k, v, causal=causal, scale=scale, return_lse=True)
        return flash_attention_plain(q, k, v, causal=causal, scale=scale), None
    _check_card("flash_attention", q, k, v)
    if q.device.index != torch.cuda.current_device():  # kernels run on the current device
        with torch.cuda.device(q.device):
            return _forward(q, k, v, causal, scale, want_lse)
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"flash_attention: q, k, v must share dtype float32 or bfloat16, got "
                         f"{q.dtype}, {k.dtype}, {v.dtype}")
    route, staging = launch_plan(q.dtype, (q.shape, k.shape, v.shape),
                                 (q.stride(), k.stride(), v.stride()),
                                 (q.data_ptr(), k.data_ptr(), v.data_ptr()), causal=causal)
    b, h, s, d = q.shape
    kvh, t = k.shape[1], k.shape[2]
    out = torch.empty_like(q)  # q's strides where q is dense
    lse = torch.empty((b, h, s), dtype=torch.float32, device=q.device) if want_lse else None
    if s == 0:
        return out, lse
    if out.stride(3) != 1:
        raise ValueError("flash_attention: out needs a unit-stride last axis")
    scale_ = float(scale) if scale is not None else 1.0 / math.sqrt(d)
    # the last int: bf16 operands for the simt kernel, TMA staging for wgmma
    flag = int(staging == "tma") if route == "wgmma" else 0
    rc = _lib(route)(q.data_ptr(), *q.stride()[:3], k.data_ptr(), *k.stride()[:3],
                     v.data_ptr(), *v.stride()[:3], out.data_ptr(), *out.stride()[:3],
                     b, h, kvh, s, t, d, int(causal), scale_, flag,
                     lse.data_ptr() if want_lse else None,
                     torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"flash_attention ({route}, {staging}) failed at q {tuple(q.shape)}, "
                           f"k {tuple(k.shape)}: CUDA error {rc}")
    launch_count.count(flash_attention)
    flash_attention.launches_by_route[route] += 1
    return out, lse


def flash_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, out: torch.Tensor,
                        lse: torch.Tensor, dout: torch.Tensor, causal: bool = True,
                        scale: Optional[float] = None):
    """(dq, dk, dv) of :func:`flash_attention` at q, k, v, given its output
    ``out``, the rows' log-sum-exp ``lse`` (B, H, S) that its forward saved
    and the output's gradient ``dout``; each in its operand's dtype and
    layout. CPU tensors run :func:`flash_attention_bwd_plain`; CUDA tensors
    launch the kernels of the route :func:`bwd_launch_plan` names (bf16:
    ``csrc/flash_attention_bwd_wgmma.cu``, the rows' delta, dK and dV, then
    dQ; f32: ``csrc/flash_attention_bwd.cu``, dK and dV, then dQ; one count
    a call) or raise. Every tensor is read through its strides (unit-stride
    last axes); q, k, v, out and dout share a dtype, f32 or bf16."""
    if q.device.type == "cpu":
        return flash_attention_bwd_plain(q, k, v, out, lse, dout, causal, scale)
    _check_card("flash_attention_bwd", q, k, v, out, lse, dout)
    if q.device.index != torch.cuda.current_device():
        with torch.cuda.device(q.device):
            return flash_attention_bwd(q, k, v, out, lse, dout, causal, scale)
    b, h, s, d, kvh, t = _check_shapes(q.shape, k.shape, v.shape, causal)
    if q.dtype not in ROUTES or any(x.dtype != q.dtype for x in (k, v, out, dout)):
        raise ValueError(f"flash_attention_bwd: q, k, v, out, dout must share dtype float32 or "
                         f"bfloat16, got {[str(x.dtype) for x in (q, k, v, out, dout)]}")
    if tuple(out.shape) != (b, h, s, d) or tuple(dout.shape) != (b, h, s, d):
        raise ValueError(f"flash_attention_bwd: out {tuple(out.shape)}, dout "
                         f"{tuple(dout.shape)}, want {(b, h, s, d)}")
    if lse.dtype != torch.float32 or tuple(lse.shape) != (b, h, s) or not lse.is_contiguous():
        raise ValueError(f"flash_attention_bwd: lse must be contiguous float32 {(b, h, s)}")
    if not 1 <= d <= MAX_HEAD_DIM:
        raise ValueError(f"flash_attention_bwd: head dim {d} is outside 1..{MAX_HEAD_DIM}")
    if dout.stride(3) != 1:
        dout = dout.contiguous()
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    tensors = (q, k, v, out, dout, dq, dk, dv)
    for name, x in zip(("q", "k", "v", "out", "dout", "dq", "dk", "dv"), tensors):
        if x.stride(3) != 1 or min(x.stride()) < 0:
            raise ValueError(f"flash_attention_bwd: {name} needs a unit-stride last axis and "
                             f"non-negative strides, got {tuple(x.stride())}")
    if s == 0 or t == 0:
        return dq.zero_(), dk.zero_(), dv.zero_()
    route, staging = bwd_launch_plan(q.dtype, (q.shape, k.shape, v.shape, dout.shape),
                                     (q.stride(), k.stride(), v.stride(), dout.stride()),
                                     (q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr()),
                                     causal=causal)
    strides = (ctypes.c_longlong * 24)(*(st for x in tensors for st in x.stride()[:3]))
    scale_ = float(scale) if scale is not None else 1.0 / math.sqrt(d)
    pointers = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), dout.data_ptr(),
                lse.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr())
    stream = torch.cuda.current_stream().cuda_stream
    if route == "wgmma":
        scratch = torch.empty(bwd_scratch_floats(b, h, s), dtype=torch.float32, device=q.device)
        rc = _bwd_lib(route)(*pointers, scratch.data_ptr(), strides, b, h, kvh, s, t, d,
                             int(causal), scale_, int(staging == "tma"), stream)
    else:
        rc = _bwd_lib(route)(*pointers, strides, b, h, kvh, s, t, d, int(causal), scale_, 0,
                             stream)
    if rc != 0:
        raise RuntimeError(f"flash_attention_bwd ({route}, {staging}) failed at q "
                           f"{tuple(q.shape)}, k {tuple(k.shape)}: CUDA error {rc}")
    launch_count.count(_FLASH_BWD)  # itself, also while a caller wraps the module's name
    _FLASH_BWD.launches_by_route[route] += 1
    return dq, dk, dv


class FlashAttention(torch.autograd.Function):
    """:func:`flash_attention` with its gradient: the forward saves q, k, v,
    the output and the rows' log-sum-exp, the backward is
    :func:`flash_attention_bwd` (looked up at call time, so that a caller
    can wrap it)."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool, scale: Optional[float]):
        out, lse = _forward(q, k, v, causal, scale, want_lse=True)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal, ctx.scale = causal, scale
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, out, lse, dout, ctx.causal, ctx.scale)
        return dq, dk, dv, None, None


# kernel launches since the last reset: in all, and by route
flash_attention.launches = 0
flash_attention.launches_by_route = {"wgmma": 0, "simt": 0}
flash_attention_bwd.launches = 0
flash_attention_bwd.launches_by_route = {"wgmma": 0, "simt": 0}
_FLASH_BWD = flash_attention_bwd
