"""qwen3-moe-235b-a22b — 128-expert top-8 MoE, QK-norm [hf:Qwen/Qwen3-30B-A3B]."""

from repro_torch.config import ModelConfig, MoEConfig
from repro_torch.configs import register


@register("qwen3-moe-235b-a22b")
def config() -> ModelConfig:
    return ModelConfig(
        name="qwen3-moe-235b-a22b",
        family="moe",
        num_layers=94,
        d_model=4096,
        num_heads=64,
        num_kv_heads=4,
        head_dim=128,
        d_ff=1536,  # (= expert width; no dense FFN in this arch)
        vocab_size=151936,
        norm="rmsnorm",
        activation="swiglu",
        qk_norm=True,
        rope_theta=1_000_000.0,
        tie_embeddings=False,
        moe=MoEConfig(
            num_experts=128,
            top_k=8,
            expert_d_ff=1536,
            capacity_factor=1.25,
            group_size=2048,
        ),
        source="hf:Qwen/Qwen3-30B-A3B",
    )
