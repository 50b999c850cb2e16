"""mistral-nemo-12b — 128k context [hf:mistralai/Mistral-Nemo-Base-2407]."""

from repro_torch.config import ModelConfig
from repro_torch.configs import register


@register("mistral-nemo-12b")
def config() -> ModelConfig:
    return ModelConfig(
        name="mistral-nemo-12b",
        family="dense",
        num_layers=40,
        d_model=5120,
        num_heads=32,
        num_kv_heads=8,
        head_dim=128,  # explicit: 32*128 != 5120 (Nemo decouples head_dim)
        d_ff=14336,
        vocab_size=131072,
        norm="rmsnorm",
        activation="swiglu",
        rope_theta=1_000_000.0,  # 128k-context rope base
        tie_embeddings=False,
        source="hf:mistralai/Mistral-Nemo-Base-2407",
    )
