"""Dense transformer block (olmo, mistral-nemo, gemma): one layer's specs,
chunked-prefill step and decode step against a paged cache."""

from __future__ import annotations

from repro_torch.models.attention import attention_specs, paged_chunk_attention, paged_decode_attention
from repro_torch.models.ffn import ffn, ffn_specs
from repro_torch.models.layers import apply_norm, norm_specs


def dense_block_specs(cfg) -> dict:
    return {
        "norm1": norm_specs(cfg),
        "attn": attention_specs(cfg),
        "norm2": norm_specs(cfg),
        "mlp": ffn_specs(cfg),
    }


def _residual(cfg, p, x, h, a):
    if cfg.parallel_residual:
        # GPT-NeoX / StableLM parallel form: one LN, attn + FFN both from it
        return x + a + ffn(cfg, p["mlp"], h)
    x = x + a
    return x + ffn(cfg, p["mlp"], apply_norm(cfg, p["norm2"], x))


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
