"""Train-step factory: loss -> grads -> AdamW. Port of ``repro.train.step``
on one card.

The reference reduce-scatters the grads onto its ZeRO layout when its mesh
has more than one device, and ``train_state_specs`` returns the state's
shardings beside its shapes; one card has neither, so
:func:`train_state_shapes` returns the ``(shape, dtype)`` leaves alone, which
``CheckpointManager.restore`` takes as its ``like``.
"""
from __future__ import annotations

from typing import Callable

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import model as model_lib
from repro_torch.optim import adamw


def make_train_step(cfg: ModelConfig,
                    opt_cfg: adamw.AdamWConfig = adamw.AdamWConfig()) -> Callable:
    """``train_step(params, opt_state, batch) -> (params, opt_state,
    metrics)``: the loss of :func:`repro_torch.models.model.make_loss_fn`,
    its gradient in every parameter (a parameter the loss does not reach,
    such as the embedding table of a model fed ``embeds``, gets zeros, as
    ``jax.grad`` gives), then one :func:`adamw.apply`. ``metrics`` holds
    ``loss``, ``grad_norm`` and ``lr`` as 0-d f32 tensors. ``batch`` holds
    tensors on the params' device."""
    loss_fn = model_lib.make_loss_fn(cfg)

    def train_step(params, opt_state: adamw.OptState, batch):
        flat = [p.detach().requires_grad_() for p in adamw.leaves(params)]
        with torch.enable_grad():
            loss = loss_fn(adamw.rebuild(params, flat), batch)
            grads = torch.autograd.grad(loss, flat, allow_unused=True, materialize_grads=True)
        del flat
        params, opt_state, metrics = adamw.apply(opt_cfg, adamw.rebuild(params, list(grads)),
                                                 opt_state)
        metrics["loss"] = loss.detach()
        return params, opt_state, metrics

    return train_step


def train_state_shapes(cfg: ModelConfig):
    """``(params, OptState)`` as ``(shape, dtype)`` leaves: the schema's, and
    f32 for the master copy and the moments, int32 for the count. Nothing
    is allocated."""
    meta = model_lib.param_shapes(cfg)
    pshapes = adamw.map_tree(lambda t: (tuple(t.shape), t.dtype), meta)
    f32 = adamw.map_tree(lambda t: (tuple(t.shape), torch.float32), meta)
    return pshapes, adamw.OptState(master=f32, mu=f32, nu=f32, count=((), torch.int32))
