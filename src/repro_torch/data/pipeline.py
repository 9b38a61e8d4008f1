"""Deterministic synthetic token pipeline (prefetching, resumable).

A copy of ``repro.data.pipeline``, numpy only, so that the port imports
nothing of the reference. No corpus ships with the repo, so the pipeline
synthesises one: a fixed-seed Zipf-ish unigram stream with induced
short-range structure, a pure function of (seed, step). Every restart
reproduces the same global batch, which the trainer's resume relies on;
both packages give the same batches, bit for bit, for the same
``(seed, step)``.
"""
from __future__ import annotations

import dataclasses
import queue
import threading
from typing import Dict, Iterator

import numpy as np

from repro_torch.configs.base import ModelConfig, ShapeConfig


@dataclasses.dataclass(frozen=True)
class DataConfig:
    seed: int = 1234
    zipf_a: float = 1.3
    structure_period: int = 16  # injects learnable periodic structure
    prefetch: int = 2


def _batch_for_step(
    cfg: DataConfig, vocab: int, batch: int, seq: int, step: int
) -> Dict[str, np.ndarray]:
    """The full global batch for a step — pure function of (cfg, step)."""
    rng = np.random.default_rng(np.random.SeedSequence([cfg.seed, step]))
    # zipf-ish unigrams, clipped to vocab
    base = rng.zipf(cfg.zipf_a, size=(batch, seq + 1)).astype(np.int64)
    tokens = (base - 1) % vocab
    # inject deterministic periodic structure: token at t copies t-period/2
    # every `period` positions — gives the model something learnable.
    p = cfg.structure_period
    idx = np.arange(seq + 1)
    copy_from = idx - p // 2
    mask = (idx % p == 0) & (copy_from >= 0)
    tokens[:, mask] = tokens[:, np.where(mask)[0] - p // 2]
    return {
        "tokens": tokens[:, :-1].astype(np.int32),
        "labels": tokens[:, 1:].astype(np.int32),
    }


def _embeds_for_step(cfg: DataConfig, d_model: int, step: int,
                     b: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """The modality stub (audio, vlm): precomputed front-end embeddings,
    deterministic from the token ids, in place of the tokens."""
    rng = np.random.default_rng(np.random.SeedSequence([cfg.seed, step, 7]))
    table = rng.standard_normal((256, d_model)).astype(np.float32)
    return {"embeds": table[b["tokens"] % 256], "labels": b["labels"]}


class TokenPipeline:
    """Iterator of global batches with background prefetch and exact resume.

    ``start_step`` makes restarts deterministic: batch(step) never depends
    on consumption history.
    """

    def __init__(
        self,
        model_cfg: ModelConfig,
        shape: ShapeConfig,
        data_cfg: DataConfig = DataConfig(),
        start_step: int = 0,
        embeds: bool = False,
    ):
        self.model_cfg = model_cfg
        self.shape = shape
        self.cfg = data_cfg
        self.step = start_step
        self.embeds = embeds
        self._q: "queue.Queue" = queue.Queue(maxsize=data_cfg.prefetch)
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()

    def _make(self, step: int) -> Dict[str, np.ndarray]:
        return batch_for_step(self.model_cfg, self.shape, self.cfg, step, self.embeds)

    def _worker(self):
        step = self.step
        while not self._stop.is_set():
            batch = self._make(step)
            while not self._stop.is_set():
                try:
                    self._q.put((step, batch), timeout=0.1)
                    break
                except queue.Full:
                    continue
            step += 1

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        return self

    def __next__(self):
        step, batch = self._q.get()
        self.step = step + 1
        return batch

    def peek_step(self) -> int:
        return self.step

    def close(self):
        self._stop.set()


def batch_for_step(model_cfg, shape, data_cfg, step, embeds=False):
    """Stateless single-batch accessor (used by tests and the trainer's
    deterministic-resume check)."""
    b = _batch_for_step(
        data_cfg, model_cfg.vocab_size, shape.global_batch, shape.seq_len, step
    )
    if embeds:
        b = _embeds_for_step(data_cfg, model_cfg.d_model, step, b)
    return b
