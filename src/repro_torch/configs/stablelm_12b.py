"""stablelm-12b — parallel residual, partial rotary [hf:stabilityai/stablelm-2-*]."""

from repro_torch.config import ModelConfig
from repro_torch.configs import register


@register("stablelm-12b")
def config() -> ModelConfig:
    return ModelConfig(
        name="stablelm-12b",
        family="dense",
        num_layers=40,
        d_model=5120,
        num_heads=32,
        num_kv_heads=8,
        d_ff=13824,
        vocab_size=100352,
        norm="layernorm",
        activation="swiglu",
        rotary_pct=0.25,  # StableLM-2 partial rotary
        parallel_residual=True,  # single LN feeds attn + FFN (12b variant)
        rope_theta=10000.0,
        tie_embeddings=False,
        source="hf:stabilityai/stablelm-2-1_6b",
    )
