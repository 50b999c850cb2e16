from repro_torch.config.model import (
    ModelConfig,
    MoEConfig,
    RWKVConfig,
    SSMConfig,
    VisionConfig,
    reduce_for_smoke,
)
from repro_torch.config.run import (
    MeshConfig,
    ParallelConfig,
    PrecisionConfig,
    SHAPES,
    RunConfig,
    ServeConfig,
    ShapeConfig,
    TrainConfig,
)

__all__ = [
    "MeshConfig",
    "ModelConfig",
    "MoEConfig",
    "ParallelConfig",
    "PrecisionConfig",
    "RWKVConfig",
    "RunConfig",
    "SHAPES",
    "SSMConfig",
    "ServeConfig",
    "ShapeConfig",
    "TrainConfig",
    "VisionConfig",
    "reduce_for_smoke",
]
