from repro_torch.config.model import (
    ModelConfig,
    MoEConfig,
    RWKVConfig,
    SSMConfig,
    VisionConfig,
    reduce_for_smoke,
)

__all__ = ["ModelConfig", "MoEConfig", "RWKVConfig", "SSMConfig", "VisionConfig", "reduce_for_smoke"]
