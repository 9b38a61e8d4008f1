"""Mamba-2 (SSD / state-space duality) sequence mixer, arXiv:2405.21060.
Port of ``repro.models.mamba2``.

Chunked SSD: the sequence is split into chunks of length ``ssm_chunk``;
the within-chunk quadratic block and each chunk's outgoing state come from
``ops.ssd_chunk`` (the reference computes the same two einsums in jnp), and
the inter-chunk recurrence  h_{c+1} = decay_c * h_c + S_c  is
:func:`associative_scan`, the reference's ``jax.lax.associative_scan`` with
the states carried in bf16 as it carries them.

On a mesh of ranks (serving, and training under autograd; ``layout``, a
:class:`~repro_torch.models.sharding.ServeLayout` whose model axes are above
1) the mixer is tensor-parallel over the heads, in the layout the
reference's ``_ssm_defs`` and ``cache_specs`` give GSPMD: the normed
residual is gathered at every position; each rank multiplies it by its
column blocks of ``wz``, ``wx``, ``wb``, ``wc`` and ``wdt`` and runs the
depthwise conv on its own channels (per channel: no halo once every
position is present); B and C are made whole after their conv (a block of
``wb`` holds part of a group's state vector) and each local head takes its
group's; kernel 7 and the scan run on the rank's heads; the gated RMSNorm
over the cut ``d_inner`` sums each rank's f32 sum of squares over the model
axes (:func:`~repro_torch.models.layers.rmsnorm_cut`); ``wo``'s row block's
partial product is summed back into the residual's layout. The state is the
rank's block: its channels of the pre-conv streams, its heads of ``h``.
Where the heads do not divide over the model axes, every leaf that arrived
cut is gathered whole and every rank runs every head; ``wo`` then goes
through :meth:`~repro_torch.models.sharding.ServeLayout.row_product`.
Under autograd (a train step) kernel 7 runs forward and backward
(``SsdChunk``) on the rank's heads, the gradients of the whole B and C are
summed back to each rank's columns by the gather's backward, and ``wo``'s
partial products' gradient is all-gathered back by the reduce-scatter's.
"""
from __future__ import annotations

from typing import Callable, Dict, List, NamedTuple, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops
from repro_torch.models.layers import rmsnorm, rmsnorm_cut
from repro_torch.models.sharding import ServeLayout


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


def _on_mesh(layout: Optional[ServeLayout]) -> bool:
    return layout is not None and layout.n > 1


def _tp_widths(cfg: ModelConfig) -> Dict[str, int]:
    """Each leaf of a Mamba layer that the schema cuts over ``"tp"``, with
    the width of its cut dim (``wo``'s rows aside)."""
    din, gn, nh = cfg.d_inner, cfg.ssm_ngroups * cfg.ssm_state, cfg.ssm_nheads
    return {"wz": din, "wx": din, "wb": gn, "wc": gn, "wdt": nh, "dt_bias": nh, "a_log": nh,
            "d_skip": nh, "norm_w": din, "conv_x": din, "conv_b": gn, "conv_c": gn}


def _whole_layer(cfg: ModelConfig, lay: ServeLayout, p: dict) -> dict:
    """The layer's leaves that arrived cut over the model axes, whole (the
    conv weights along their channels, the rest along their last dim);
    ``wo`` keeps this rank's rows, for :meth:`ServeLayout.row_product`."""
    out = dict(p)
    for name, width in _tp_widths(cfg).items():
        if lay.cut(width):
            dim = 0 if name.startswith("conv") else p[name].dim() - 1
            out[name] = lay.mesh.all_gather(p[name], dim, lay.model)
    return out


def _state_cols(cfg: ModelConfig, lay: ServeLayout, st: SsmState, whole: bool) -> SsmState:
    """``st``'s conv entries made whole from this rank's channel blocks
    (``whole``), or cut to them; ``h`` as it is (its heads are whole where
    this is called: they do not divide)."""
    din, gn = cfg.d_inner, cfg.ssm_ngroups * cfg.ssm_state

    def cols(t: torch.Tensor, width: int) -> torch.Tensor:
        if not lay.cut(width):
            return t
        if whole:
            return lay.whole_cols(t, width)
        c0, c1 = lay.block(width)
        return t[..., c0:c1].contiguous()

    return SsmState(cols(st.conv_x, din), cols(st.conv_b, gn), cols(st.conv_c, gn), st.h)


def _per_head(cfg: ModelConfig, t: torch.Tensor, heads: Tuple[int, int], dim: int):
    """``t``'s groups along ``dim`` as the rows of heads ``heads`` = (h0,
    h1): head i takes group i // heads_per_group."""
    hpg = cfg.ssm_nheads // cfg.ssm_ngroups
    if heads == (0, cfg.ssm_nheads):
        return t.repeat_interleave(hpg, dim=dim)
    return t.index_select(dim, torch.arange(*heads, device=t.device) // hpg)


def _same(t: torch.Tensor, width: int) -> torch.Tensor:
    return t


def _ssd_heads(cfg: ModelConfig, p: dict, x: torch.Tensor, heads: Tuple[int, int],
               whole_bc: Callable = _same):
    """The SSD of heads ``heads`` = (h0, h1) over the whole sequence ``x``
    (b, s, d), from ``p``'s blocks of those heads' leaves. Returns (y (b, s,
    heads x headdim) in x's dtype before the gate, z, the three pre-conv
    streams (b, s padded, .), the inclusive scan's last state (b, heads, N,
    P) in f32). ``whole_bc(t, g*n)`` makes B and C whole after their conv
    (:meth:`ServeLayout.whole_cols`)."""
    b, s_orig, d = x.shape
    h_dim, n_state, n_groups = cfg.ssm_headdim, cfg.ssm_state, cfg.ssm_ngroups
    n_heads = heads[1] - heads[0]
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
    bm, cm = (_per_head(cfg, whole_bc(t, n_groups * n_state).reshape(b, s, n_groups, n_state),
                        heads, 2) for t in (bproj, cproj))

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
    y = y.reshape(b, s, n_heads * h_dim).to(x.dtype)
    if pad:
        y = y[:, :s_orig]
        z = z[:, :s_orig]
    return y, z, streams, s_scan[:, -1]


def _final_state(cfg: ModelConfig, streams, h_last: torch.Tensor, s_orig: int) -> SsmState:
    """The inclusive scan at the last chunk, and the last k-1 positions of
    each stream before its conv (the reference projects the unpadded x
    again for these rows; the rows are the same)."""
    lo = max(s_orig - (cfg.ssm_conv - 1), 0)
    conv = [t[:, lo:s_orig, :].to(torch.bfloat16) for t in streams]
    return SsmState(*conv, h=h_last.transpose(-1, -2).contiguous())


def _gated_norm(cfg: ModelConfig, p: dict, y: torch.Tensor, z: torch.Tensor,
                lay: Optional[ServeLayout] = None) -> torch.Tensor:
    """The gated RMSNorm of the block's tail, rmsnorm(y * silu(z)); with a
    ``lay`` whose model axes cut ``d_inner``, over this rank's block of it
    (:func:`rmsnorm_cut`, the sum of squares summed over the model axes)."""
    if lay is None:
        return rmsnorm(y * F.silu(z), p["norm_w"], cfg.norm_eps)
    return rmsnorm_cut(y * F.silu(z), p["norm_w"], cfg.norm_eps, cfg.d_inner, lay.model_sum)


def _out_product(g: torch.Tensor, wo: torch.Tensor) -> torch.Tensor:
    """The block's out projection, ``g @ wo``: the whole product, or on a
    mesh this rank's row block's partial one."""
    return g @ wo


def ssd_mixer(
    cfg: ModelConfig,
    p: dict,
    x: torch.Tensor,  # (b, s, d)
    return_state: bool = False,
    *,
    layout: Optional[ServeLayout] = None,
) -> Tuple[torch.Tensor, Optional[SsmState]]:
    """Full-sequence (prefill) SSD mixer from a zero state. Returns (y, the
    final state or None). The reference's optional seed state has no caller
    there or here and is left out. With a ``layout`` whose model axes are
    above 1: :func:`_mixer_on_mesh`."""
    if _on_mesh(layout):
        return _mixer_on_mesh(cfg, layout, p, x, return_state)
    y, z, streams, h_last = _ssd_heads(cfg, p, x, (0, cfg.ssm_nheads))
    # gated RMSNorm then out projection (Mamba-2 block tail).
    out = _out_product(_gated_norm(cfg, p, y, z), p["wo"])
    return out, _final_state(cfg, streams, h_last, x.shape[1]) if return_state else None


def _mixer_on_mesh(cfg: ModelConfig, lay: ServeLayout, p: dict, x: torch.Tensor,
                   return_state: bool) -> Tuple[torch.Tensor, Optional[SsmState]]:
    """:func:`ssd_mixer` on a mesh (see the module's docstring): ``x`` is
    the normed residual's block (b_rows, positions, d), ``p`` this rank's
    blocks; the output is in the residual's layout, the state this rank's
    blocks under ``model.cache_pspecs``."""
    x = lay.all_positions(x)
    s = x.shape[1]
    if lay.cut(cfg.ssm_nheads):
        y, z, streams, h_last = _ssd_heads(cfg, p, x, lay.block(cfg.ssm_nheads), lay.whole_cols)
        out = lay.reduce_partial(_out_product(_gated_norm(cfg, p, y, z, lay), p["wo"]))
        return out, _final_state(cfg, streams, h_last, s) if return_state else None
    # the heads do not divide: every head on every rank, from whole leaves
    whole = _whole_layer(cfg, lay, p)
    y, z, streams, h_last = _ssd_heads(cfg, whole, x, (0, cfg.ssm_nheads))
    out = lay.row_product(_gated_norm(cfg, whole, y, z), p["wo"], cfg.d_inner)
    if not return_state:
        return out, None
    return out, _state_cols(cfg, lay, _final_state(cfg, streams, h_last, s), whole=False)


def _decode_heads(cfg: ModelConfig, p: dict, x: torch.Tensor, state: SsmState,
                  heads: Tuple[int, int], whole_bc: Callable = _same):
    """One token's recurrent step for heads ``heads`` = (h0, h1) from
    ``p``'s and ``state``'s blocks of them: (y (b, heads x headdim) in x's
    dtype before the gate, z, the new state)."""
    b = x.shape[0]
    h_dim, n_state, n_groups = cfg.ssm_headdim, cfg.ssm_state, cfg.ssm_ngroups
    n_heads = heads[1] - heads[0]

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
    bm, cm = (_per_head(cfg, whole_bc(t, n_groups * n_state).reshape(b, n_groups, n_state),
                        heads, 1) for t in (bm_, cm_))  # (b, heads, n)

    a = -torch.exp(p["a_log"].to(torch.float32))
    dt32 = dt.to(torch.float32)
    decay = torch.exp(dt32 * a[None, :])  # (b, heads)
    xdt = xin.to(torch.float32) * dt32[..., None]  # (b, h, P)
    h_new = state.h * decay[..., None, None] + torch.einsum(
        "bhp,bhn->bhpn", xdt, bm.to(torch.float32))
    y = torch.einsum("bhpn,bhn->bhp", h_new, cm.to(torch.float32))
    y = y + xdt * p["d_skip"].to(torch.float32)[None, :, None]
    y = y.reshape(b, n_heads * h_dim).to(x.dtype)
    return y, z, SsmState(conv_x=new_cx, conv_b=new_cb, conv_c=new_cc, h=h_new)


def ssd_decode_step(
    cfg: ModelConfig,
    p: dict,
    x: torch.Tensor,  # (b, 1, d)
    state: SsmState,
    *,
    layout: Optional[ServeLayout] = None,
) -> Tuple[torch.Tensor, SsmState]:
    """Single-token recurrent step: h' = exp(dt*A) h + dt * B x ; y = C.h.
    With a ``layout`` whose model axes are above 1, ``x`` is the residual's
    block (its rows; a decode step's one position is on every rank) and
    ``state`` this rank's blocks (see the module's docstring)."""
    nh = cfg.ssm_nheads
    if not _on_mesh(layout):
        y, z, new = _decode_heads(cfg, p, x, state, (0, nh))
        return _out_product(_gated_norm(cfg, p, y, z), p["wo"])[:, None, :], new
    lay = layout
    if lay.cut(nh):
        y, z, new = _decode_heads(cfg, p, x, state, lay.block(nh), lay.whole_cols)
        out = _out_product(_gated_norm(cfg, p, y, z, lay), p["wo"])
        return lay.reduce_partial(out[:, None, :]), new
    whole = _whole_layer(cfg, lay, p)
    y, z, new = _decode_heads(cfg, whole, x, _state_cols(cfg, lay, state, whole=True), (0, nh))
    out = lay.row_product(_gated_norm(cfg, whole, y, z)[:, None, :], p["wo"], cfg.d_inner)
    return out, _state_cols(cfg, lay, new, whole=False)
