"""SmolLM-360M — llama-arch small dense GQA [hf:HuggingFaceTB/SmolLM; hf]."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="smollm-360m", family="dense", n_layers=32, d_model=960, n_heads=15,
    n_kv_heads=5, d_ff=2560, vocab_size=49152, head_dim=64,
)
SMOKE = ModelConfig(
    name="smollm-360m-smoke", family="dense", n_layers=2, d_model=96, n_heads=3,
    n_kv_heads=1, d_ff=192, vocab_size=512, head_dim=32,
)
