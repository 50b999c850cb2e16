"""Dense transformer block (olmo, mistral-nemo, gemma): one layer's specs,
its full-sequence forward (training), and its chunked-prefill and decode
steps against a paged cache."""

from __future__ import annotations

from repro_torch.models.attention import (
    attention_specs,
    paged_chunk_attention,
    paged_decode_attention,
    self_attention,
)
from repro_torch.models.ffn import ffn, ffn_specs
from repro_torch.models.layers import apply_norm, norm_specs


def dense_block_specs(cfg) -> dict:
    return {
        "norm1": norm_specs(cfg),
        "attn": attention_specs(cfg),
        "norm2": norm_specs(cfg),
        "mlp": ffn_specs(cfg),
    }


def _residual(cfg, p, x, h, a, fp8=None):
    if cfg.parallel_residual:
        # GPT-NeoX / StableLM parallel form: one LN, attn + FFN both from it
        return x + a + ffn(cfg, p["mlp"], h, fp8=fp8)
    x = x + a
    return x + ffn(cfg, p["mlp"], apply_norm(cfg, p["norm2"], x), fp8=fp8)


def dense_block(cfg, p, x, *, positions=None, q_chunk=0, attn_impl="torch", fp8=None):
    """Full-sequence forward of one layer (training): x (B, S, D) -> (B, S, D).
    ``fp8``: this layer's FP8 handle, or None."""
    h = apply_norm(cfg, p["norm1"], x)
    a = self_attention(cfg, p["attn"], h, positions=positions, q_chunk=q_chunk, impl=attn_impl, fp8=fp8)
    return _residual(cfg, p, x, h, a, fp8=fp8)


def dense_block_chunk(cfg, p, x, cache, tbl_row, start, *, attn_impl="kernel"):
    """Chunked-prefill step: a C-token chunk written and attended through
    the request's own paged block table."""
    h = apply_norm(cfg, p["norm1"], x)
    a = paged_chunk_attention(cfg, p["attn"], h, cache, tbl_row, start, impl=attn_impl)
    return _residual(cfg, p, x, h, a)


def dense_block_decode(cfg, p, x, cache, pos, *, attn_impl="kernel"):
    h = apply_norm(cfg, p["norm1"], x)
    a = paged_decode_attention(cfg, p["attn"], h, cache, pos, impl=attn_impl)
    return _residual(cfg, p, x, h, a)
