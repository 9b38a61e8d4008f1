"""Model and shape configurations: a copy of ``repro.configs`` (pure data)."""
from repro_torch.configs.base import ModelConfig, ShapeConfig, SHAPES, shape_applicable
from repro_torch.configs.registry import ASSIGNED_ARCHS, all_cells, get_config, get_shape
