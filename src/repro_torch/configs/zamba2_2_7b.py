"""Zamba2-2.7B — Mamba2 backbone + shared attention blocks
[arXiv:2411.15242; hf].

Structure: 54 Mamba2 layers in groups of ``hybrid_period``=6; one *shared*
full-attention+MLP block (single weight set) is invoked after each group —
9 invocations with distinct KV caches, shared parameters (the Zamba2 idea).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="zamba2-2.7b", family="hybrid", n_layers=54, d_model=2560, n_heads=32,
    n_kv_heads=32, d_ff=10240, vocab_size=32000, head_dim=80,
    ssm_state=64, ssm_headdim=64, ssm_expand=2, ssm_ngroups=1, hybrid_period=6,
)
SMOKE = ModelConfig(
    name="zamba2-2.7b-smoke", family="hybrid", n_layers=4, d_model=64,
    n_heads=4, n_kv_heads=4, d_ff=128, vocab_size=256, head_dim=16,
    ssm_state=16, ssm_headdim=32, ssm_expand=2, ssm_ngroups=1,
    hybrid_period=2, ssm_chunk=32,
)
