"""Architecture registry: --arch <id> resolution for every launcher."""
from __future__ import annotations

from typing import List

from repro_torch.configs.base import ModelConfig, SHAPES, ShapeConfig, shape_applicable
from repro_torch.configs import (
    yi_6b, smollm_360m, qwen2_7b, qwen2_5_32b, musicgen_large,
    granite_moe_1b, grok_1_314b, mamba2_1_3b, zamba2_2_7b, internvl2_76b,
    repro_100m,
)

_MODULES = {
    "yi-6b": yi_6b,
    "smollm-360m": smollm_360m,
    "qwen2-7b": qwen2_7b,
    "qwen2.5-32b": qwen2_5_32b,
    "musicgen-large": musicgen_large,
    "granite-moe-1b-a400m": granite_moe_1b,
    "grok-1-314b": grok_1_314b,
    "mamba2-1.3b": mamba2_1_3b,
    "zamba2-2.7b": zamba2_2_7b,
    "internvl2-76b": internvl2_76b,
    "repro-100m": repro_100m,
}

ASSIGNED_ARCHS: List[str] = [a for a in _MODULES if a != "repro-100m"]


def get_config(name: str, smoke: bool = False) -> ModelConfig:
    if name not in _MODULES:
        raise KeyError(f"unknown arch '{name}'; known: {sorted(_MODULES)}")
    mod = _MODULES[name]
    return mod.SMOKE if smoke else mod.CONFIG


def get_shape(name: str) -> ShapeConfig:
    return SHAPES[name]


def all_cells(include_inapplicable: bool = False):
    """The 40 (arch x shape) baseline cells; inapplicable cells are yielded
    with applicable=False so harnesses can record the documented skip."""
    for arch in ASSIGNED_ARCHS:
        cfg = get_config(arch)
        for shape in SHAPES.values():
            ok, why = shape_applicable(cfg, shape)
            if ok or include_inapplicable:
                yield cfg, shape, ok, why
