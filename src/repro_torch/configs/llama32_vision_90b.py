"""llama-3.2-vision-90b — cross-attn image layers [hf:meta-llama/Llama-3.2-11B-Vision].

The vision tower is a stub, as in the JAX package's copy: the model takes
precomputed patch embeddings (B, 1600, d_model) as its cross-attention
keys.  100 decoder layers run as 20 groups of (4 self + 1 cross).
"""

from repro_torch.config import ModelConfig, VisionConfig
from repro_torch.configs import register


@register("llama-3.2-vision-90b")
def config() -> ModelConfig:
    return ModelConfig(
        name="llama-3.2-vision-90b",
        family="vlm",
        num_layers=100,
        d_model=8192,
        num_heads=64,
        num_kv_heads=8,
        d_ff=28672,
        vocab_size=128256,
        norm="rmsnorm",
        activation="swiglu",
        rope_theta=500_000.0,
        tie_embeddings=False,
        vision=VisionConfig(num_image_tokens=1600, cross_attn_every=5),
        source="hf:meta-llama/Llama-3.2-11B-Vision; unverified",
    )
