"""Batched serving engine: one prefill, then decode steps against a
pre-allocated KV budget, greedy or sampled at a temperature. Port of
``repro.serve.engine``.

    from repro_torch.configs import get_config
    from repro_torch.models.model import init_params
    from repro_torch.serve.engine import Engine, ServeConfig

    cfg = get_config("zamba2-2.7b")
    params = init_params(cfg, torch.Generator("cuda").manual_seed(0))
    eng = Engine(cfg, params, ServeConfig(max_seq_len=4224, batch_size=4))
    out = eng.generate(prompts, max_new_tokens=64)  # (4, P + 64) int32 numpy
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional

import numpy as np
import torch

from repro_torch.base import resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.models import model as model_lib
from repro_torch.models.mamba2 import SsmState


@dataclasses.dataclass
class ServeConfig:
    max_seq_len: int = 512
    batch_size: int = 4
    temperature: float = 0.0  # <= 0: greedy


class Engine:
    """Generation for one fixed batch of prompts on one device (``"cuda"``
    unless the caller asks for the CPU); ``params`` must live there
    (``model.init_params`` or ``convert.lm_params_from_numpy``). At
    ``temperature > 0`` tokens are drawn from ``generator``, a
    ``torch.Generator`` on that device; without one the engine seeds its
    own from fresh entropy, as the reference's unseeded draws are."""

    def __init__(self, cfg: ModelConfig, params: Any, scfg: ServeConfig = ServeConfig(),
                 device="cuda", generator: Optional[torch.Generator] = None) -> None:
        model_lib.check_ported(cfg)
        self.device = resolve_device(device)
        table = params["embed"]["table"]
        if table.device != self.device:
            raise ValueError(f"params on {table.device}, engine on {self.device}")
        if generator is None:
            generator = torch.Generator(device=self.device)
            generator.seed()
        elif generator.device.type != self.device.type:
            raise ValueError(f"generator on {generator.device}, engine on {self.device}")
        self.cfg, self.scfg, self.params = cfg, scfg, params
        self.generator = generator
        self.prefill = model_lib.make_prefill_step(cfg)
        self.decode = model_lib.make_serve_step(cfg)

    def _pad_cache(self, cache: Any, from_len: int) -> Any:
        """The decode cache: the prefill cache's attention entries, ``k`` and
        ``v`` (layers, b, from_len, kv, hd), grown to the serving budget
        along their sequence axis, and a copy of its SSM states; for every
        ported family's layout (``dense``/``moe``/``audio``/``vlm``: ``{"k",
        "v"}``; ``ssm``: an ``SsmState``; ``hybrid``: ``{"ssm", "attn"}``).
        The entries are chosen by name: the reference picks them by shape
        (``shape[-3] == from_len``), which also catches the conv states when
        the prompt length equals the batch size. Decode steps update the
        returned cache in place and leave ``cache`` as it was."""
        target = self.scfg.max_seq_len

        def grow(t: torch.Tensor) -> torch.Tensor:
            shape = list(t.shape)
            shape[-3] = target
            g = t.new_zeros(shape)
            g[..., :from_len, :, :] = t
            return g

        def kv(c):
            return {name: grow(c[name]) for name in ("k", "v")}

        def states(c):
            return SsmState(*(t.clone() for t in c))

        if isinstance(cache, SsmState):  # ssm
            return states(cache)
        if "attn" in cache:  # hybrid
            return {"ssm": states(cache["ssm"]), "attn": kv(cache["attn"])}
        return kv(cache)  # dense, moe, audio, vlm

    def generate(self, prompts: np.ndarray, max_new_tokens: int = 32,
                 eos_id: Optional[int] = None) -> np.ndarray:
        """prompts: (B, P) token ids, for every ported family (the audio
        and vision families' embeds enter through ``self.prefill``, as in
        the reference). Returns (B, P + max_new_tokens) int32, as the
        reference does: the prompts, then the new tokens (after
        ``eos_id``, a finished row repeats it). The prefill runs even for
        ``max_new_tokens=0``, which returns the prompts. The last token needs
        no decode step after it, so ``max_new_tokens - 1`` decode steps
        follow the prefill."""
        prompts = np.asarray(prompts)
        b, p = prompts.shape
        if b != self.scfg.batch_size:
            raise ValueError(f"{b} prompts, the engine serves batches of {self.scfg.batch_size}")
        if max_new_tokens < 0 or p + max_new_tokens > self.scfg.max_seq_len:
            raise ValueError(f"prompt {p} + {max_new_tokens} new tokens outside the budget of "
                             f"{self.scfg.max_seq_len}")
        tokens = torch.as_tensor(prompts, dtype=torch.long, device=self.device)
        logits, cache = self.prefill(self.params, {"tokens": tokens})
        cache = self._pad_cache(cache, p)
        out = [tokens]
        done = torch.zeros((b,), dtype=torch.bool, device=self.device)
        token = self._sample(logits)
        for i in range(max_new_tokens):
            out.append(token[:, None])
            if i == max_new_tokens - 1:
                break
            if eos_id is not None:
                done = done | (token == eos_id)
            logits, cache = self.decode(self.params, cache, {"token": token[:, None],
                                                             "pos": p + i})
            nxt = self._sample(logits)
            token = torch.where(done, token, nxt) if eos_id is not None else nxt
        return torch.cat(out, dim=1).to(torch.int32).cpu().numpy()

    def _sample(self, logits: torch.Tensor) -> torch.Tensor:
        """The next token of each row of ``logits`` (..., Vp), from its first
        ``vocab_size`` columns: the argmax at ``temperature <= 0``, else a
        draw from softmax(logits / T) by the Gumbel-max rule that
        ``jax.random.categorical`` uses, argmax(logits / T + G) with G
        standard Gumbel noise from the engine's generator. Logits and noise
        are taken in f32, whatever the model's dtype."""
        logits = logits[..., : self.cfg.vocab_size]
        temperature = self.scfg.temperature
        if temperature <= 0:
            return torch.argmax(logits, dim=-1)
        u = torch.rand(logits.shape, generator=self.generator, dtype=torch.float32,
                       device=logits.device)
        gumbel = -torch.log(-torch.log(u.clamp_(min=torch.finfo(torch.float32).tiny)))
        return torch.argmax(logits.float() / temperature + gumbel, dim=-1)
