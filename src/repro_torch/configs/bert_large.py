"""bert-large — the paper's own MLPerf training benchmark (Fig. 8).

Encoder-only, 24L/1024d/16H, GELU, post-LN approximated as parametric LN
(pre-LN form; the distribution/roofline shape is identical).
"""

from repro_torch.config import ModelConfig
from repro_torch.configs import register


@register("bert-large")
def config() -> ModelConfig:
    return ModelConfig(
        name="bert-large",
        family="dense",
        num_layers=24,
        d_model=1024,
        num_heads=16,
        num_kv_heads=16,
        d_ff=4096,
        vocab_size=30522,
        norm="layernorm",
        activation="gelu",
        use_bias=True,
        causal=False,  # bidirectional encoder
        rotary_pct=0.0,
        learned_pos_embedding=True,
        max_position=512,
        tie_embeddings=True,
        source="arXiv:1810.04805; MLPerf v3.1 (paper Fig. 8)",
    )
