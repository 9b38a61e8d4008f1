"""Qwen2.5-32B — dense GQA with QKV bias [hf:Qwen/Qwen2.5; hf]."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen2.5-32b", family="dense", n_layers=64, d_model=5120, n_heads=40,
    n_kv_heads=8, d_ff=27648, vocab_size=152064, head_dim=128, qkv_bias=True,
)
SMOKE = ModelConfig(
    name="qwen2.5-32b-smoke", family="dense", n_layers=2, d_model=128, n_heads=4,
    n_kv_heads=2, d_ff=256, vocab_size=512, head_dim=32, qkv_bias=True,
)
