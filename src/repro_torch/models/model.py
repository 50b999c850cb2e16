"""The dense model on a paged cache: embedding -> layer loop -> head.

Two entry points, counterparts of the JAX package's ``models/model.py``:

* ``prefill_step`` — one prompt chunk against the paged cache: (logits at
  the chunk's last token, cache)
* ``decode_step``  — one token per batch slot: (logits, cache)

The layer loop is a Python loop over per-layer parameter dicts.  The cache
is updated in place and returned for symmetry with the JAX functions, which
return a new one.
"""

from __future__ import annotations

import math

import torch

from repro_torch.models.attention import ATTN_IMPLS
from repro_torch.models.blocks import dense_block_chunk, dense_block_decode
from repro_torch.models.cache import layer_cache
from repro_torch.models.layers import apply_norm


def _check_impl(cfg, attn_impl: str) -> None:
    if attn_impl not in ATTN_IMPLS:
        raise ValueError(f"attn_impl={attn_impl!r} (choose from {ATTN_IMPLS})")
    if cfg.family != "dense":
        raise NotImplementedError(f"family {cfg.family!r} ({cfg.name}) is not ported yet")


def embed_input(cfg, params, tokens: torch.Tensor, positions: torch.Tensor) -> torch.Tensor:
    """(B, S) tokens at (B, S) positions -> (B, S, D) embeddings."""
    e = params["embed"]
    x = e["tok"][tokens.long()]
    if cfg.learned_pos_embedding:
        x = x + e["pos"][positions.long()].to(x.dtype)
    if cfg.scale_embedding:
        x = x * torch.tensor(math.sqrt(cfg.d_model), dtype=x.dtype, device=x.device)
    return x


def lm_logits(cfg, params, x: torch.Tensor) -> torch.Tensor:
    """Final norm + output projection (tied or untied; padded-vocab mask)."""
    x = apply_norm(cfg, params["final_norm"], x)
    if "lm_head" in params:
        logits = x @ params["lm_head"].to(x.dtype)
    else:
        logits = x @ params["embed"]["tok"].to(x.dtype).T
    logits = logits.float()
    if cfg.padded_vocab != cfg.vocab_size:
        # mask the alignment-padding columns (never predicted)
        logits[..., cfg.vocab_size :] = -1e9
    return logits


def _chunk_stack(cfg, params, cache, tokens, start, tbl_row, *, attn_impl="kernel"):
    """Embed C tokens at ``start + [0, C)``, scatter their K/V into the paged
    cache through ``tbl_row`` and attend causally over the paged history.
    Returns x (B, C, D)."""
    C = tokens.shape[1]
    positions = start[:, None].long() + torch.arange(C, device=tokens.device)[None, :]
    x = embed_input(cfg, params, tokens, positions)
    for layer, p_layer in enumerate(params["blocks"]):
        x = dense_block_chunk(cfg, p_layer, x, layer_cache(cache, layer), tbl_row, start, attn_impl=attn_impl)
    return x


@torch.no_grad()
def prefill_step(cfg, params, cache, tokens, start, tbl_row, *, attn_impl="kernel"):
    """Process one prompt chunk against a paged cache.

    tokens:  (B, C) int32, C consecutive prompt tokens
    start:   (B,) int32 absolute position of the chunk's first token
    tbl_row: (B, nb) int32, the request's block table (the engine's
             ``cache["tbl"]`` rows stay null until the prompt completes, so
             interleaved decode steps can't touch a half-prefilled request).

    Writes the chunk's K/V into the request's blocks, attends causally over
    the paged history [0, start + C) and returns (logits (B, V) at the
    chunk's last token, cache).  Chaining chunks reproduces a whole-prompt
    prefill exactly for the dense family.
    """
    _check_impl(cfg, attn_impl)
    x = _chunk_stack(cfg, params, cache, tokens, start, tbl_row, attn_impl=attn_impl)
    return lm_logits(cfg, params, x[:, -1]), cache


@torch.no_grad()
def decode_step(cfg, params, cache, token, pos, *, attn_impl="kernel"):
    """One decode step.  token: (B, 1) int32; pos: (B,) int32 absolute
    position of this token.  Returns (logits (B, V), cache)."""
    _check_impl(cfg, attn_impl)
    x = embed_input(cfg, params, token, pos[:, None])
    for layer, p_layer in enumerate(params["blocks"]):
        x = dense_block_decode(cfg, p_layer, x, layer_cache(cache, layer), pos, attn_impl=attn_impl)
    return lm_logits(cfg, params, x[:, 0]), cache
