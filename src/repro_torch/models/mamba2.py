"""Mamba-2 (SSD / state-space duality) sequence mixer, arXiv:2405.21060.
Port of ``repro.models.mamba2``.

Chunked SSD: the sequence is split into chunks of length ``ssm_chunk``;
the within-chunk quadratic block and each chunk's outgoing state come from
``ops.ssd_chunk`` (the reference computes the same two einsums in jnp), and
the inter-chunk recurrence  h_{c+1} = decay_c * h_c + S_c  is
:func:`associative_scan`, the reference's ``jax.lax.associative_scan`` with
the states carried in bf16 as it carries them.
"""
from __future__ import annotations

from typing import Callable, List, NamedTuple, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops
from repro_torch.models.layers import rmsnorm


class SsmState(NamedTuple):
    conv_x: torch.Tensor  # (b, k-1, d_inner) rolling conv inputs (x stream), bf16
    conv_b: torch.Tensor  # (b, k-1, g*n), bf16
    conv_c: torch.Tensor  # (b, k-1, g*n), bf16
    h: torch.Tensor  # (b, heads, headdim, state), f32


def _depthwise_causal_conv(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x (b, s, c), w (c, k): causal depthwise conv along s, as a sum of k
    shifted scalings; ``w[:, k-1]`` multiplies the current token (the decode
    step's rolling window)."""
    k = w.shape[-1]
    xp = F.pad(x, (0, 0, k - 1, 0))
    out = torch.zeros_like(x)
    for i in range(k):
        out = out + xp[:, i:i + x.shape[1], :] * w[None, None, :, i]
    return out


def associative_scan(fn: Callable, elems: Sequence[torch.Tensor], dim: int) -> List[torch.Tensor]:
    """Inclusive scan of ``fn`` over ``dim`` with the odd/even recursion of
    ``jax.lax.associative_scan`` (Blelloch 1990): the same combines in the
    same tree, so a combine that rounds (the bf16 states below) rounds at
    the same places as the reference. ``fn(a, b)`` combines the lists of
    tensors of an earlier element ``a`` and a later one ``b``."""

    def take(t, sl):
        return t[(slice(None),) * dim + (sl,)]

    def scan(el):
        n = el[0].shape[dim]
        if n < 2:
            return el
        # pairs (0, 1), (2, 3), ... combined, then scanned: the odd prefixes
        odd = scan(fn([take(e, slice(0, -1, 2)) for e in el],
                      [take(e, slice(1, None, 2)) for e in el]))
        # the even prefixes from the odd ones and elements 2, 4, ...
        even = fn([take(o, slice(0, -1)) for o in odd] if n % 2 == 0 else odd,
                  [take(e, slice(2, None, 2)) for e in el])
        out = []
        for e, ev, o in zip(el, even, odd):
            t = e.new_empty(e.shape)
            t[(slice(None),) * dim + (slice(0, None, 2),)] = torch.cat([take(e, slice(0, 1)), ev],
                                                                        dim=dim)
            t[(slice(None),) * dim + (slice(1, None, 2),)] = o
            out.append(t)
        return out

    return scan(list(elems))


def _combine_states(e1, e2):
    """(decay, state) pairs, the earlier e1 then e2: h = s1 * d2 + s2 in f32,
    stored back in bf16, as the reference's ``combine`` does."""
    d1, s1 = e1
    d2, s2 = e2
    s = s1.to(torch.float32) * d2[..., None, None] + s2.to(torch.float32)
    return [d1 * d2, s.to(torch.bfloat16)]


def ssd_mixer(
    cfg: ModelConfig,
    p: dict,
    x: torch.Tensor,  # (b, s, d)
    return_state: bool = False,
) -> Tuple[torch.Tensor, Optional[SsmState]]:
    """Full-sequence (prefill) SSD mixer from a zero state. Returns (y, the
    final state or None). The reference's optional seed state has no caller
    there or here and is left out."""
    b, s_orig, d = x.shape
    h_dim, n_heads = cfg.ssm_headdim, cfg.ssm_nheads
    n_state, n_groups = cfg.ssm_state, cfg.ssm_ngroups
    din = cfg.d_inner
    chunk = min(cfg.ssm_chunk, s_orig)
    # pad seq to a chunk multiple; padded positions are neutralized below
    # (dt = 0 -> no decay, no state contribution), so y[:s] and the final
    # state are exact.
    pad = (-s_orig) % chunk
    if pad:
        x = F.pad(x, (0, 0, 0, pad))
    s = s_orig + pad
    n_chunks = s // chunk

    z = x @ p["wz"]  # (b, s, din)
    streams = [x @ p["wx"], x @ p["wb"], x @ p["wc"]]  # (b, s, din), (b, s, g*n) x 2
    dt = F.softplus(x @ p["wdt"] + p["dt_bias"])  # (b, s, heads)

    xin, bproj, cproj = (F.silu(_depthwise_causal_conv(t, p[w]))
                         for t, w in zip(streams, ("conv_x", "conv_b", "conv_c")))

    xh = xin.reshape(b, s, n_heads, h_dim)
    heads_per_group = n_heads // n_groups
    bm = bproj.reshape(b, s, n_groups, n_state).repeat_interleave(heads_per_group, dim=2)
    cm = cproj.reshape(b, s, n_groups, n_state).repeat_interleave(heads_per_group, dim=2)

    a = -torch.exp(p["a_log"].to(torch.float32))  # (heads,)
    dt32 = dt.to(torch.float32)
    dta = dt32 * a[None, None, :]  # (b, s, heads) log-decay
    xdt = xh.to(torch.float32) * dt32[..., None]
    if pad:
        live = (torch.arange(s, device=x.device) < s_orig)[None, :, None]
        dta = torch.where(live, dta, 0.0)
        xdt = torch.where(live[..., None], xdt, 0.0)

    # ---- chunked SSD, laid out as the kernel takes it: (b*heads, nc, L, .)
    def to_kernel(t):  # (b, s, heads, ...) -> (b*heads, nc, L, ...)
        t = t.reshape(b, n_chunks, chunk, n_heads, *t.shape[3:])
        t = t.movedim(3, 1)
        return t.reshape(b * n_heads, n_chunks, chunk, *t.shape[4:]).contiguous()

    a_cum = torch.cumsum(to_kernel(dta), dim=2)  # (b*h, nc, L) within-chunk log decay
    # B and C go in bf16 or f32 as they are (the kernel widens them inside)
    bc = torch.bfloat16 if bm.dtype == torch.bfloat16 else torch.float32
    y_diag, s_chunk = ops.ssd_chunk(to_kernel(xdt), a_cum, to_kernel(bm.to(bc)),
                                    to_kernel(cm.to(bc)))
    y_diag = y_diag.reshape(b, n_heads, n_chunks, chunk, h_dim).permute(0, 2, 3, 1, 4)
    s_chunk = s_chunk.reshape(b, n_heads, n_chunks, n_state, h_dim).transpose(1, 2)
    a_cum = a_cum.reshape(b, n_heads, n_chunks, chunk).permute(0, 2, 3, 1)  # (b, nc, L, h)

    # inter-chunk recurrence: h_c_out = prod_decay_c * h_c_in + S_c, the
    # states carried in bf16 through the scan as in the reference.
    chunk_decay = torch.exp(a_cum[:, :, -1, :])  # (b, nc, h)
    _, s_scan = associative_scan(
        _combine_states, [chunk_decay, s_chunk.to(torch.bfloat16)], dim=1)
    s_scan = s_scan.to(torch.float32)
    # the scan is inclusive: the state entering chunk c is chunk c-1's
    s_in = torch.cat([torch.zeros_like(s_scan[:, :1]), s_scan[:, :-1]], dim=1)

    # inter-chunk contribution: y_inter[i] = exp(A[i]) * c_i . h_in
    cc = cm.to(torch.float32).reshape(b, n_chunks, chunk, n_heads, n_state)
    in_decay = torch.exp(a_cum)  # (b, nc, L, h)
    y_inter = torch.einsum("bnlhs,bnhsp->bnlhp", cc * in_decay[..., None], s_in)

    y = (y_diag + y_inter).reshape(b, s, n_heads, h_dim)
    y = y + xdt.reshape(b, s, n_heads, h_dim) * p["d_skip"].to(torch.float32)[None, None, :, None]
    y = y.reshape(b, s, din).to(x.dtype)
    if pad:
        y = y[:, :s_orig]
        z = z[:, :s_orig]

    # gated RMSNorm then out projection (Mamba-2 block tail).
    y = rmsnorm(y * F.silu(z), p["norm_w"], cfg.norm_eps)
    out = y @ p["wo"]

    final_state = None
    if return_state:
        # the inclusive scan at the last chunk, and the last k-1 positions of
        # each stream before its conv (the reference projects the unpadded x
        # again for these rows; the rows are the same)
        lo = max(s_orig - (cfg.ssm_conv - 1), 0)
        conv = [t[:, lo:s_orig, :].to(torch.bfloat16) for t in streams]
        final_state = SsmState(*conv, h=s_scan[:, -1].transpose(-1, -2).contiguous())
    return out, final_state


def ssd_decode_step(
    cfg: ModelConfig,
    p: dict,
    x: torch.Tensor,  # (b, 1, d)
    state: SsmState,
) -> Tuple[torch.Tensor, SsmState]:
    """Single-token recurrent step: h' = exp(dt*A) h + dt * B x ; y = C.h."""
    b = x.shape[0]
    h_dim, n_heads = cfg.ssm_headdim, cfg.ssm_nheads
    n_state, n_groups = cfg.ssm_state, cfg.ssm_ngroups
    din = cfg.d_inner

    xt = x[:, 0, :]
    z = xt @ p["wz"]
    xin = xt @ p["wx"]
    bproj = xt @ p["wb"]
    cproj = xt @ p["wc"]
    dt = F.softplus(xt @ p["wdt"] + p["dt_bias"])  # (b, heads)

    def conv_step(stream, prev, w):
        window = torch.cat([prev.to(stream.dtype), stream[:, None, :]], dim=1)  # (b, k, c)
        out = F.silu(torch.einsum("bkc,ck->bc", window, w))
        return out, window[:, 1:, :].to(torch.bfloat16)

    xin, new_cx = conv_step(xin, state.conv_x, p["conv_x"])
    bm_, new_cb = conv_step(bproj, state.conv_b, p["conv_b"])
    cm_, new_cc = conv_step(cproj, state.conv_c, p["conv_c"])
    xin = xin.reshape(b, n_heads, h_dim)
    hpg = n_heads // n_groups
    bm = bm_.reshape(b, n_groups, n_state).repeat_interleave(hpg, dim=1)  # (b, heads, n)
    cm = cm_.reshape(b, n_groups, n_state).repeat_interleave(hpg, dim=1)

    a = -torch.exp(p["a_log"].to(torch.float32))
    dt32 = dt.to(torch.float32)
    decay = torch.exp(dt32 * a[None, :])  # (b, heads)
    xdt = xin.to(torch.float32) * dt32[..., None]  # (b, h, P)
    h_new = state.h * decay[..., None, None] + torch.einsum(
        "bhp,bhn->bhpn", xdt, bm.to(torch.float32))
    y = torch.einsum("bhpn,bhn->bhp", h_new, cm.to(torch.float32))
    y = y + xdt * p["d_skip"].to(torch.float32)[None, :, None]
    y = y.reshape(b, din).to(x.dtype)
    y = rmsnorm(y * F.silu(z), p["norm_w"], cfg.norm_eps)
    out = (y @ p["wo"])[:, None, :]
    return out, SsmState(conv_x=new_cx, conv_b=new_cb, conv_c=new_cc, h=h_new)
