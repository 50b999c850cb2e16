"""rwkv6-7b — Finch: attention-free, data-dependent decay [arXiv:2404.05892]."""

from repro_torch.config import ModelConfig, RWKVConfig
from repro_torch.configs import register


@register("rwkv6-7b")
def config() -> ModelConfig:
    return ModelConfig(
        name="rwkv6-7b",
        family="ssm",
        num_layers=32,
        d_model=4096,
        num_heads=64,  # d_model / head_size(64)
        num_kv_heads=64,
        head_dim=64,
        d_ff=14336,
        vocab_size=65536,
        norm="layernorm",
        activation="relu2",  # channel-mix uses squared ReLU
        rotary_pct=0.0,  # attention-free: no RoPE
        tie_embeddings=False,
        rwkv=RWKVConfig(head_size=64, lora_rank_decay=64, lora_rank_mix=32, chunk_size=64),
        subquadratic=True,  # O(1)-state decode -> long_500k runnable
        source="arXiv:2404.05892; hf",
    )
