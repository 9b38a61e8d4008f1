"""Mamba2-1.3B — attention-free SSD (state-space duality)
[arXiv:2405.21060; unverified]."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="mamba2-1.3b", family="ssm", n_layers=48, d_model=2048, n_heads=0,
    n_kv_heads=0, d_ff=0, vocab_size=50280,
    ssm_state=128, ssm_headdim=64, ssm_expand=2, ssm_ngroups=1,
)
SMOKE = ModelConfig(
    name="mamba2-1.3b-smoke", family="ssm", n_layers=2, d_model=64, n_heads=0,
    n_kv_heads=0, d_ff=0, vocab_size=256,
    ssm_state=16, ssm_headdim=32, ssm_expand=2, ssm_ngroups=1, ssm_chunk=32,
)
