from repro_torch.configs.base import (
    ArchConfig, ShapeSpec, SHAPES, param_count, smoke_shape,
)
from repro_torch.configs.registry import (
    get_config, get_shape, list_archs, all_cells,
)

__all__ = [
    "ArchConfig", "ShapeSpec", "SHAPES", "smoke_shape", "param_count",
    "get_config", "get_shape", "list_archs", "all_cells",
]
