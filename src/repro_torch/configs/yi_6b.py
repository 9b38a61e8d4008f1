"""Yi-6B — llama-arch dense GQA [arXiv:2403.04652; hf]."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="yi-6b", family="dense", n_layers=32, d_model=4096, n_heads=32,
    n_kv_heads=4, d_ff=11008, vocab_size=64000, head_dim=128,
)
SMOKE = ModelConfig(
    name="yi-6b-smoke", family="dense", n_layers=2, d_model=128, n_heads=4,
    n_kv_heads=2, d_ff=256, vocab_size=512, head_dim=32,
)
