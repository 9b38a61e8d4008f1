"""repro-100m — in-house ~100M-param dense config for the end-to-end
training example (examples/train_lm.py). SmolLM-family proportions."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="repro-100m", family="dense", n_layers=12, d_model=768, n_heads=12,
    n_kv_heads=4, d_ff=2048, vocab_size=8192, head_dim=64,
)
SMOKE = ModelConfig(
    name="repro-100m-smoke", family="dense", n_layers=2, d_model=64, n_heads=4,
    n_kv_heads=2, d_ff=128, vocab_size=256, head_dim=16,
)
