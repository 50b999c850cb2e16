from repro_torch.parallel.sharding import ShardingRules, make_rules
from repro_torch.parallel.collectives import (
    CollectiveModel,
    compress_gradients,
    compression_ratio,
    init_compression_state,
)

__all__ = [
    "ShardingRules",
    "make_rules",
    "CollectiveModel",
    "compress_gradients",
    "compression_ratio",
    "init_compression_state",
]
