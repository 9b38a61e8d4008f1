"""Grok-1 314B — MoE 8 experts top-2 [hf:xai-org/grok-1; unverified].

expert_shards=2: each expert's d_ff is split in two EP shards so the
effective 16 expert-shards map 1:1 onto the 16-way model axis (tokens visit
both shards of their routed expert; results are summed — exact).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="grok-1-314b", family="moe", n_layers=64, d_model=6144, n_heads=48,
    n_kv_heads=8, d_ff=32768, vocab_size=131072, head_dim=128,
    n_experts=8, top_k=2, expert_shards=2,
)
SMOKE = ModelConfig(
    name="grok-1-314b-smoke", family="moe", n_layers=2, d_model=64, n_heads=4,
    n_kv_heads=2, d_ff=128, vocab_size=256, head_dim=16,
    n_experts=4, top_k=2, expert_shards=1,
)
