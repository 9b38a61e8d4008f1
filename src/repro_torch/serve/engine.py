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

Across the ranks of a mesh (``Engine(..., mesh=make_mesh((1, 2), ("data",
"model")), rules=RULES_SERVE)``, on every rank, with the same prompts and
this rank's blocks of the parameters) every rank computes its part of each
step (``models.model``'s serving on a mesh, every family) and ends with the
whole logits, samples the same tokens and returns the same output.
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
from repro_torch.models.sharding import DEFAULT_RULES, ServeLayout, ShardingRules


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
    own from fresh entropy, as the reference's unseeded draws are.

    On a ``mesh`` of more than one rank (a
    :class:`~repro_torch.launch.mesh.RankMesh`; every rank builds its own
    engine) ``params`` are this rank's blocks under
    ``model.param_pspecs(cfg, rules, mesh)`` (``model.init_params(...,
    mesh=, specs=)`` or ``convert.lm_params_from_numpy(..., sharding=)``),
    and every rank is given the same prompts. Each rank's ``generator`` must
    be seeded the same; without one, rank 0's fresh seed seeds every rank's.
    ``rules`` defaults to the reference's ``Engine`` default."""

    def __init__(self, cfg: ModelConfig, params: Any, scfg: ServeConfig = ServeConfig(),
                 device="cuda", generator: Optional[torch.Generator] = None, *,
                 mesh=None, rules: ShardingRules = DEFAULT_RULES) -> None:
        model_lib.check_serving_mesh(cfg, mesh, rules)
        self.device = resolve_device(device)
        self.mesh = mesh if model_lib.on_mesh(mesh) else None
        self.rules = rules
        table = params["embed"]["table"]
        if table.device != self.device:
            raise ValueError(f"params on {table.device}, engine on {self.device}")
        if self.mesh is not None:
            want = model_lib.map_tree(
                lambda d, spec: tuple(self.mesh.local_block(
                    torch.empty(d.shape, device="meta"), spec).shape),
                model_lib.param_defs(cfg), model_lib.param_pspecs(cfg, rules, self.mesh))
            got = model_lib.map_tree(lambda t: tuple(t.shape), params)
            if got != want:
                raise ValueError("params are not this rank's blocks under param_pspecs(cfg, "
                                 "rules, mesh)")
        if generator is None:
            generator = torch.Generator(device=self.device)
            generator.seed()
            if self.mesh is not None:  # one seed for every rank: rank 0's
                mine = generator.initial_seed() % (1 << 62) if self.mesh.rank == 0 else 0
                seed = self.mesh.all_reduce(torch.tensor([mine], device=self.device))
                generator.manual_seed(int(seed.item()))
        elif generator.device.type != self.device.type:
            raise ValueError(f"generator on {generator.device}, engine on {self.device}")
        self.cfg, self.scfg, self.params = cfg, scfg, params
        self.generator = generator
        self.prefill = model_lib.make_prefill_step(cfg, self.mesh, rules)
        self.decode = model_lib.make_serve_step(cfg, self.mesh, rules)

    def _pad_cache(self, cache: Any, from_len: int) -> Any:
        """The decode cache: the prefill cache's attention entries, ``k`` and
        ``v`` (layers, b, from_len, kv, hd), grown to the serving budget
        along their sequence axis, and a copy of its SSM states; for every
        ported family's layout (``dense``/``moe``/``audio``/``vlm``: ``{"k",
        "v"}``; ``ssm``: an ``SsmState``; ``hybrid``: ``{"ssm", "attn"}``).
        The entries are chosen by name: the reference picks them by shape
        (``shape[-3] == from_len``), which also catches the conv states when
        the prompt length equals the batch size. Decode steps update the
        returned cache in place and leave ``cache`` as it was.

        On a mesh the attention entries move to their owners: the prefill
        cache holds this rank's block of the prompt's positions (or all of
        them, where they do not divide over the model axes), the decode
        cache this rank's block of the budget's, the budget rounded up to a
        multiple of the model axes' ranks (the positions past it are never
        written and never live). The SSM states are this rank's blocks (its
        rows, its channels of the conv entries, its heads of ``h``:
        ``model.cache_pspecs``) and have no position dim: each is copied as
        it is."""
        grow = self._grow_on_mesh(from_len) if self.mesh is not None else None
        if grow is None:
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

    def _grow_on_mesh(self, from_len: int):
        """The mesh's ``grow`` of an attention entry (layers, b, positions,
        kv, hd): every prompt position of a layer gathered (where they are
        cut), then this rank's block of the budget kept."""
        lay = ServeLayout.build(self.mesh, self.rules, self.scfg.batch_size, from_len)
        length = -(-self.scfg.max_seq_len // lay.n)
        lo = lay.block(length * lay.n)[0]
        hi = min(lo + length, from_len)

        def grow(t: torch.Tensor) -> torch.Tensor:
            g = t.new_zeros(t.shape[:2] + (length,) + t.shape[3:])
            for i in range(t.shape[0]):  # a layer at a time: one whole prompt alive
                whole = lay.all_positions(t[i])
                if hi > lo:
                    g[i, :, :hi - lo] = whole[:, lo:hi]
            return g

        return grow

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
        out = torch.cat(out, dim=1)
        if self.mesh is not None:  # every rank must have drawn the same tokens
            seen = self.mesh.all_gather(out[None], 0, self.mesh.axis_names)
            if not bool((seen == out).all()):
                raise RuntimeError("the ranks of the mesh generated different tokens")
        return out.to(torch.int32).cpu().numpy()

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
