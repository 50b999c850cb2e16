"""hymba-1.5b — parallel attention + Mamba heads per block [arXiv:2411.13676].

Adaptations, as in the JAX package's copy: the SSM heads use the
Mamba-2/SSD per-head-dt formulation; sliding-window attention stands in for
Hymba's SWA + meta-token scheme (the three global-attention layers and the
128 learnable meta tokens are omitted).
"""

from repro_torch.config import ModelConfig, SSMConfig
from repro_torch.configs import register


@register("hymba-1.5b")
def config() -> ModelConfig:
    return ModelConfig(
        name="hymba-1.5b",
        family="hybrid",
        num_layers=32,
        d_model=1600,
        num_heads=25,
        num_kv_heads=5,
        head_dim=64,  # 25*64 = 1600
        d_ff=5504,
        vocab_size=32001,
        norm="rmsnorm",
        activation="swiglu",
        sliding_window=1024,
        rope_theta=10000.0,
        tie_embeddings=True,
        ssm=SSMConfig(state_size=16, conv_width=4, expand=2, chunk_size=256),
        subquadratic=True,  # SWA + constant SSM state -> long_500k runnable
        source="arXiv:2411.13676; hf",
    )
