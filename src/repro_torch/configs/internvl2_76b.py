"""InternVL2-76B — InternViT + InternLM2 [arXiv:2404.16821; unverified].

LM backbone only (per assignment): the InternViT patch frontend is a stub —
input_specs() supplies precomputed patch/text embeddings (batch, seq, d_model).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="internvl2-76b", family="vlm", n_layers=80, d_model=8192, n_heads=64,
    n_kv_heads=8, d_ff=28672, vocab_size=128256, head_dim=128,
    frontend="vision_patches",
)
SMOKE = ModelConfig(
    name="internvl2-76b-smoke", family="vlm", n_layers=2, d_model=128,
    n_heads=4, n_kv_heads=2, d_ff=256, vocab_size=512, head_dim=32,
    frontend="vision_patches",
)
