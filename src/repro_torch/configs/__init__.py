from repro_torch.configs.base import (FrontendConfig, InputShape, MLAConfig,
                                      ModelConfig, MoEConfig, RecurrentConfig)
from repro_torch.configs.registry import ARCHS, get_config, reduced_config
from repro_torch.configs.shapes import INPUT_SHAPES, get_shape

__all__ = [
    "ARCHS", "FrontendConfig", "INPUT_SHAPES", "InputShape", "MLAConfig",
    "ModelConfig", "MoEConfig", "RecurrentConfig", "get_config", "get_shape",
    "reduced_config",
]
