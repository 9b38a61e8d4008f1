"""The MoE block: a top-k router, capacity-factor slotting and dense expert
SwiGLUs. Port of ``repro.models.moe.moe_block``: on one device, and across
the ranks of a mesh as the reference's ``local_fn`` runs on each device of
its ``shard_map`` (expert parallel).

Routing is gather/scatter, as in the reference: every kept (token, rank)
pair is copied into its own slot of an (E, cap, d) buffer, and no one-hot
einsum dispatches tokens. The capacity is the reference's per-device
capacity (``t = b_loc * s_loc`` local tokens): on one card every token of
the batch is local; on a mesh each rank routes its own rows and positions
(the residual's block), so which pairs drop depends on the mesh, as in the
reference. There the expert shards are cut over the model axes: one
``all_to_all`` sends each rank's slots to the experts' ranks and one brings
their outputs back, and the load-balance loss is averaged over the ranks
that hold different tokens (the reference's ``pmean``). Under autograd (a
train step) both all-to-alls' backward is the reverse all-to-all, and the
aux loss's all-reduce all-reduces its gradient.

``expert_shards`` (grok: 2) splits each expert's d_ff in two: every slot is
sent to both shards of its expert and their outputs are summed.

``repro.models.moe.moe_block_decode_gathered`` gets no twin. It is reached
only when a sharding rules table sets ``moe_decode_gathered``, and no table
of the reference's sets it; decode steps take :func:`moe_block` as in the
reference.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig


def _capacity(tokens_local: int, cfg: ModelConfig) -> int:
    """Slots per expert: ceil(tokens x top_k / E x capacity_factor), at least
    8 and a multiple of 8."""
    c = int(math.ceil(tokens_local * cfg.top_k / cfg.n_experts * cfg.capacity_factor))
    return max(8, -(-c // 8) * 8)


class Routing(NamedTuple):
    """One block's routing of t tokens, each to its top_k experts.

    ``topv`` (t, k) the router's top softmax probabilities (f32),
    renormalised over k; ``tope`` (t, k) their experts, best
    first; ``keep`` (t * k,) whether the (token, rank) pair got a slot, in
    token-major, rank-minor order; ``slot`` (t * k,) its slot in the (E *
    cap) buffer, ``E * cap`` where it was dropped; ``cap`` the slots per
    expert; ``aux`` the Switch load-balance loss."""

    topv: torch.Tensor
    tope: torch.Tensor
    keep: torch.Tensor
    slot: torch.Tensor
    cap: int
    aux: torch.Tensor

    @property
    def dropped_share(self) -> torch.Tensor:
        """The share of routed (token, rank) pairs that found no slot."""
        return 1.0 - self.keep.float().mean()


def route(cfg: ModelConfig, xt: torch.Tensor, wr: torch.Tensor) -> Routing:
    """The reference's routing of the tokens ``xt`` (t, d) by the router
    ``wr`` (d, E), in f32, then the capacity slotting: each (token, rank)
    pair takes the next free slot of its expert in token-major, rank-minor
    order, and pairs at or past ``cap`` are dropped. Ties in the top-k go to
    the lower expert, as ``jax.lax.top_k`` breaks them (a stable sort)."""
    t, e, k = xt.shape[0], cfg.n_experts, cfg.top_k
    cap = _capacity(t, cfg)
    probs = torch.softmax(xt.float() @ wr.float(), dim=-1)  # (t, E)
    topv, tope = torch.sort(probs, dim=-1, descending=True, stable=True)
    topv, tope = topv[:, :k], tope[:, :k]
    topv = topv / topv.sum(dim=-1, keepdim=True)

    me = probs.mean(dim=0)
    ce = F.one_hot(tope[:, 0], e).float().mean(dim=0)
    aux = e * torch.sum(me * ce)

    flat_e = tope.reshape(-1)  # (t * k,)
    # the running count per expert, scanned along the pairs as the inner
    # axis of an (E, t * k) one-hot: the same integers as the reference's
    # scan along axis 0 of a (t * k, E) one, which CUDA's outer-axis scan
    # took ~45 ms a layer to do at granite's width on one H100
    onehot = (flat_e[None, :] == torch.arange(e, device=flat_e.device)[:, None]).to(torch.int32)
    pos = torch.cumsum(onehot, dim=1, dtype=torch.int32).gather(0, flat_e[None, :])[0] - 1
    keep = pos < cap
    slot = torch.where(keep, flat_e * cap + pos, e * cap)
    return Routing(topv, tope, keep, slot, cap, aux)


def dispatch(cfg: ModelConfig, xt: torch.Tensor, r: Routing) -> torch.Tensor:
    """The (E_eff, cap, d) expert inputs in ``xt``'s dtype: each kept pair's
    token row copied into its slot (a slot takes one row, so nothing is
    summed), the empty slots 0, each expert's slots repeated over its
    ``expert_shards``."""
    t, d = xt.shape
    e, cap = cfg.n_experts, r.cap
    tok_ids = torch.arange(t, device=xt.device).repeat_interleave(cfg.top_k)
    buf = xt.new_zeros((e * cap + 1, d))  # the last row takes every dropped pair
    buf.index_copy_(0, r.slot, xt.index_select(0, tok_ids))
    buf = buf[:-1].reshape(e, cap, d)
    if cfg.expert_shards > 1:
        buf = buf.repeat_interleave(cfg.expert_shards, dim=0)
    return buf


def experts(recv: torch.Tensor, wi: torch.Tensor, wg: torch.Tensor,
            wo: torch.Tensor) -> torch.Tensor:
    """Every expert shard's SwiGLU on its slots: (E_eff, cap, d) ->
    (E_eff, cap, d), batched products in the model's dtype. The gate is
    ``jax.nn.silu`` as the reference evaluates it, g * (1 / (1 + exp(-g))),
    each step rounded to the model's dtype (bf16: the reference's bits,
    where one f32 SiLU rounded once lands up to a few ulps away). The steps
    run in place, which keeps at most three (E_eff, cap, ff_s) transients
    alive; under autograd (training) the same steps run out of place, since
    their backward needs the intermediates."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in (recv, wi, wg, wo)):
        g = torch.bmm(recv, wg)
        g = g * torch.reciprocal(torch.exp(torch.neg(g)) + 1)
        return torch.bmm(torch.bmm(recv, wi) * g, wo)
    g = torch.bmm(recv, wg)
    sig = torch.neg(g).exp_().add_(1).reciprocal_()
    g.mul_(sig)
    del sig
    h = torch.bmm(recv, wi).mul_(g)
    del g
    return torch.bmm(h, wo)


def combine(cfg: ModelConfig, y: torch.Tensor, r: Routing, t: int) -> torch.Tensor:
    """(t, d): the shard sum, then each token's kept slots gathered, weighted
    by its top probabilities in the model's dtype and summed over k."""
    e, cap, d = cfg.n_experts, r.cap, y.shape[-1]
    if cfg.expert_shards > 1:
        y = y.reshape(e, cfg.expert_shards, cap, d).sum(dim=1)
    y_flat = torch.cat([y.reshape(e * cap, d), y.new_zeros((1, d))])
    yk = torch.where(r.keep[:, None], y_flat.index_select(0, r.slot), 0)
    yk = yk * r.topv.reshape(-1)[:, None].to(yk.dtype)
    return yk.reshape(t, cfg.top_k, d).sum(dim=1)


def moe_block(cfg: ModelConfig, x: torch.Tensor, wr: torch.Tensor, wi: torch.Tensor,
              wg: torch.Tensor, wo: torch.Tensor, *,
              layout=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (b, s, d), the router ``wr`` (d, E), the expert weights ``wi``,
    ``wg`` (E_eff, d, ff_s) and ``wo`` (E_eff, ff_s, d). Returns (y (b, s,
    d) in x's dtype, the f32 aux loss).

    With a ``layout`` (:class:`~repro_torch.models.sharding.ServeLayout`),
    ``x`` is this rank's block of the residual and the expert weights this
    rank's ``E_eff / |model axes|`` expert shards, whole in d (the caller
    gathers the ``"expert_fsdp"`` blocks over the data axes): the
    reference's ``local_fn``."""
    b, s, d = x.shape
    xt = x.reshape(b * s, d)
    r = route(cfg, xt, wr)
    buf = dispatch(cfg, xt, r)
    aux = r.aux
    ep = layout is not None and layout.n > 1
    if layout is not None:
        mesh = layout.mesh
        # the ranks that hold different tokens average their losses
        axes = tuple(a for a in mesh.axis_names
                     if a in layout.batch or (layout.seq and a in layout.model))
        if axes:
            aux = mesh.all_reduce(aux, axes) / mesh.axes_size(axes)
    if ep:
        if cfg.n_experts_eff % layout.n:
            raise ValueError(f"{cfg.n_experts_eff} expert shards do not divide over the "
                             f"model axes {layout.model} ({layout.n} ranks)")
        buf = layout.mesh.all_to_all(buf, 0, 1, layout.model)  # (E_eff / n, n cap, d)
    y = experts(buf, wi, wg, wo)
    if ep:
        y = layout.mesh.all_to_all(y, 1, 0, layout.model)  # (E_eff, cap, d)
    out = combine(cfg, y, r, b * s)
    return out.reshape(b, s, d).to(x.dtype), aux
