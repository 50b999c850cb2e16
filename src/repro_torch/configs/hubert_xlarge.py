"""hubert-xlarge — encoder-only audio transformer [arXiv:2106.07447].

The conv waveform frontend is a stub, as in the JAX package's copy: the
batch holds precomputed frame embeddings (B, S, d_model); the model applies
a frame projection + learned positions + the 48-layer encoder, predicting
the 504-unit masked-cluster vocabulary.
"""

from repro_torch.config import ModelConfig
from repro_torch.configs import register


@register("hubert-xlarge")
def config() -> ModelConfig:
    return ModelConfig(
        name="hubert-xlarge",
        family="audio",
        num_layers=48,
        d_model=1280,
        num_heads=16,
        num_kv_heads=16,
        d_ff=5120,
        vocab_size=504,
        norm="layernorm",
        activation="gelu",
        use_bias=True,
        causal=False,  # bidirectional encoder
        rotary_pct=0.0,
        learned_pos_embedding=True,
        max_position=32_768,  # covers the prefill_32k cell
        tie_embeddings=False,
        source="arXiv:2106.07447; unverified",
    )
