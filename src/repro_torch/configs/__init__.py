from repro_torch.configs.base import (
    ButterflyConfig,
    ModelConfig,
    get_config,
    list_archs,
)

__all__ = ["ButterflyConfig", "ModelConfig", "get_config", "list_archs"]
