from repro_torch.configs.base import (
    ButterflyConfig,
    INPUT_SHAPES,
    InputShape,
    ModelConfig,
    MoEConfig,
    SSMConfig,
    XLSTMConfig,
    get_config,
    list_archs,
    supports_shape,
)

__all__ = [
    "ButterflyConfig", "INPUT_SHAPES", "InputShape", "ModelConfig",
    "MoEConfig", "SSMConfig", "XLSTMConfig", "get_config", "list_archs",
    "supports_shape",
]
