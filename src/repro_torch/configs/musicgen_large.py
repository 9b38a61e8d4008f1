"""MusicGen-large — decoder-only over EnCodec tokens [arXiv:2306.05284; hf].

Backbone only (per assignment): the EnCodec/delay-pattern frontend is a stub —
input_specs() supplies precomputed frame embeddings (batch, seq, d_model).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="musicgen-large", family="audio", n_layers=48, d_model=2048, n_heads=32,
    n_kv_heads=32, d_ff=8192, vocab_size=2048, head_dim=64,
    frontend="audio_frames",
)
SMOKE = ModelConfig(
    name="musicgen-large-smoke", family="audio", n_layers=2, d_model=128,
    n_heads=4, n_kv_heads=4, d_ff=256, vocab_size=256, head_dim=32,
    frontend="audio_frames",
)
