"""arctic-480b — 128-expert top-2 MoE + dense residual [hf:Snowflake/snowflake-arctic-base]."""

from repro_torch.config import ModelConfig, MoEConfig
from repro_torch.configs import register


@register("arctic-480b")
def config() -> ModelConfig:
    return ModelConfig(
        name="arctic-480b",
        family="moe",
        num_layers=35,
        d_model=7168,
        num_heads=56,
        num_kv_heads=8,
        head_dim=128,
        d_ff=4864,  # dense-residual FFN width
        vocab_size=32000,
        norm="rmsnorm",
        activation="swiglu",
        rope_theta=10000.0,
        tie_embeddings=False,
        moe=MoEConfig(
            num_experts=128,
            top_k=2,
            expert_d_ff=4864,
            dense_residual=True,  # Arctic's dense-MoE hybrid residual
            capacity_factor=1.25,
            group_size=2048,
        ),
        source="hf:Snowflake/snowflake-arctic-base",
    )
