"""gemma-7b — GeGLU, head_dim=256, scaled embeddings [arXiv:2403.08295]."""

from repro_torch.config import ModelConfig
from repro_torch.configs import register


@register("gemma-7b")
def config() -> ModelConfig:
    return ModelConfig(
        name="gemma-7b",
        family="dense",
        num_layers=28,
        d_model=3072,
        num_heads=16,
        num_kv_heads=16,
        head_dim=256,  # 16*256 = 4096 != 3072 (Gemma decouples head_dim)
        d_ff=24576,
        vocab_size=256000,
        norm="rmsnorm",
        activation="geglu",
        scale_embedding=True,  # x *= sqrt(d_model)
        rope_theta=10000.0,
        tie_embeddings=True,
        source="arXiv:2403.08295; hf",
    )
