"""Qwen2-7B — dense GQA with QKV bias [arXiv:2407.10671; hf]."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-7b", family="dense", n_layers=28, d_model=3584, n_heads=28,
    n_kv_heads=4, d_ff=18944, vocab_size=152064, head_dim=128, qkv_bias=True,
)
SMOKE = ModelConfig(
    name="qwen2-7b-smoke", family="dense", n_layers=2, d_model=112, n_heads=4,
    n_kv_heads=2, d_ff=224, vocab_size=512, head_dim=28, qkv_bias=True,
)
