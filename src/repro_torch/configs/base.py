"""Model/shape configuration system (a copy of ``repro.configs.base``).

Every assigned architecture is a :class:`ModelConfig`; every benchmark cell
is a (ModelConfig, ShapeConfig) pair. Configs are plain frozen dataclasses,
hashable and printable. The port keeps its own copy because importing
``repro.configs`` runs ``repro/__init__.py``, which imports JAX.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple


def pad_vocab(v: int, multiple: int = 256) -> int:
    """Pad vocab to a lane-friendly multiple (recorded per-config; logits for
    padded ids are masked to -inf in the loss)."""
    return -(-v // multiple) * multiple


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str  # dense | moe | ssm | hybrid | audio | vlm
    n_layers: int
    d_model: int
    n_heads: int  # 0 for attention-free families
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0  # 0 -> d_model // n_heads
    qkv_bias: bool = False
    # MoE
    n_experts: int = 0
    top_k: int = 0
    expert_shards: int = 1  # split each expert's d_ff this many ways (EP fit)
    capacity_factor: float = 1.25
    # SSM (Mamba-2 / SSD)
    ssm_state: int = 0
    ssm_headdim: int = 64
    ssm_expand: int = 2
    ssm_conv: int = 4
    ssm_ngroups: int = 1
    ssm_chunk: int = 256
    # hybrid (zamba2): group ``hybrid_period`` mamba layers per shared
    # attention block invocation (attention weights shared across groups).
    hybrid_period: int = 6
    # modality frontends (stub): 'none' | 'audio_frames' | 'vision_patches'
    frontend: str = "none"
    rope_theta: float = 1e4
    norm_eps: float = 1e-5
    dtype: str = "bfloat16"
    # ---- paper-technique integration --------------------------------------
    tucker_rank: int = 0  # Tucker-factorize embedding + linears when > 0
    # ---- perf knobs (hillclimb levers) ------------------------------------
    remat: str = "full"  # none | full | dots
    attn_chunk: int = 2048  # kv-chunk for blockwise attention (memory bound)
    attn_partitioning: str = "cp"  # cp (context-parallel q) | hp (head-parallel)
    scan_layers: bool = True

    @property
    def resolved_head_dim(self) -> int:
        if self.head_dim:
            return self.head_dim
        return self.d_model // max(self.n_heads, 1)

    @property
    def padded_vocab(self) -> int:
        return pad_vocab(self.vocab_size)

    @property
    def d_inner(self) -> int:  # SSM inner width
        return self.ssm_expand * self.d_model

    @property
    def ssm_nheads(self) -> int:
        return self.d_inner // self.ssm_headdim

    @property
    def conv_dim(self) -> int:
        return self.d_inner + 2 * self.ssm_ngroups * self.ssm_state

    @property
    def n_experts_eff(self) -> int:
        return self.n_experts * self.expert_shards

    def param_count(self) -> int:
        """Analytic parameter count (embedding + blocks + head)."""
        d, ff, l = self.d_model, self.d_ff, self.n_layers
        hd = self.resolved_head_dim
        v = self.padded_vocab
        total = 2 * v * d  # embed + untied head
        if self.family in ("dense", "moe", "audio", "vlm"):
            attn = d * self.n_heads * hd + 2 * d * self.n_kv_heads * hd + self.n_heads * hd * d
            if self.qkv_bias:
                attn += (self.n_heads + 2 * self.n_kv_heads) * hd
            if self.family == "moe":
                mlp = self.n_experts * 3 * d * ff + d * self.n_experts
            else:
                mlp = 3 * d * ff
            total += l * (attn + mlp + 2 * d)
        elif self.family == "ssm":
            din = self.d_inner
            zxbcdt = 2 * din + 2 * self.ssm_ngroups * self.ssm_state + self.ssm_nheads
            blk = d * zxbcdt + self.conv_dim * self.ssm_conv + din * d
            blk += 2 * self.ssm_nheads + din + d
            total += l * blk
        elif self.family == "hybrid":
            din = self.d_inner
            zxbcdt = 2 * din + 2 * self.ssm_ngroups * self.ssm_state + self.ssm_nheads
            blk = d * zxbcdt + self.conv_dim * self.ssm_conv + din * d
            blk += 2 * self.ssm_nheads + din + d
            total += l * blk
            # one shared attention block (+MLP), invoked every hybrid_period
            attn = 2 * d * self.n_heads * hd + 2 * d * self.n_kv_heads * hd
            total += attn + 3 * d * ff + 2 * d
        return int(total)

    def active_param_count(self) -> int:
        """Activated params per token (MoE: top_k of n_experts)."""
        if self.family != "moe":
            return self.param_count()
        d, ff, l = self.d_model, self.d_ff, self.n_layers
        hd = self.resolved_head_dim
        v = self.padded_vocab
        attn = d * self.n_heads * hd + 2 * d * self.n_kv_heads * hd + self.n_heads * hd * d
        mlp = self.top_k * 3 * d * ff + d * self.n_experts
        return int(2 * v * d + l * (attn + mlp + 2 * d))


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode

    @property
    def tokens(self) -> int:
        return self.seq_len * self.global_batch


SHAPES = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524288, 1, "decode"),
}

# long_500k requires sub-quadratic attention: only SSM/hybrid archs run it.
LONG_CONTEXT_FAMILIES = ("ssm", "hybrid")


def shape_applicable(cfg: ModelConfig, shape: ShapeConfig) -> Tuple[bool, str]:
    if shape.name == "long_500k" and cfg.family not in LONG_CONTEXT_FAMILIES:
        return False, (
            "long_500k needs sub-quadratic attention; "
            f"{cfg.name} ({cfg.family}) is pure full-attention"
        )
    return True, ""
