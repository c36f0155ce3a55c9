from repro_torch.configs.base import (ConsistencySpec, FrontendConfig,
                                      InputShape, MLAConfig, ModelConfig,
                                      MoEConfig, RecurrentConfig, TrainConfig)
from repro_torch.configs.registry import ARCHS, get_config, reduced_config
from repro_torch.configs.shapes import INPUT_SHAPES, get_shape

__all__ = [
    "ARCHS", "ConsistencySpec", "FrontendConfig", "INPUT_SHAPES",
    "InputShape", "MLAConfig", "ModelConfig", "MoEConfig", "RecurrentConfig",
    "TrainConfig", "get_config", "get_shape", "reduced_config",
]
