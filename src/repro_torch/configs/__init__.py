from repro_torch.configs.base import (ModelConfig, ShapeSpec, SHAPES,
                                applicable_shapes)
from repro_torch.configs.registry import ARCH_IDS, all_configs, get_config
