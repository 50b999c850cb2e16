"""olmo-1b — non-parametric LayerNorm [arXiv:2402.00838]."""

from repro_torch.config import ModelConfig
from repro_torch.configs import register


@register("olmo-1b")
def config() -> ModelConfig:
    return ModelConfig(
        name="olmo-1b",
        family="dense",
        num_layers=16,
        d_model=2048,
        num_heads=16,
        num_kv_heads=16,  # GQA kv=16 (i.e. MHA)
        d_ff=8192,
        vocab_size=50304,
        norm="layernorm_np",  # OLMo: non-parametric LN
        activation="swiglu",
        rope_theta=10000.0,
        tie_embeddings=True,
        source="arXiv:2402.00838; hf",
    )
