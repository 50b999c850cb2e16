"""Paged KV-cache surgery on the engine's block pools.

``make_table_row`` pads a request's block list into a table row,
``copy_block_rows`` is the copy-on-write step behind partial prefix hits
and ``truncate_block_rows`` the speculative-decoding rollback.
Layout invariants as in the JAX package's ``serving/kvcache.py``: pools are
``(L, num_blocks, block_size, kv_heads, head_dim)``; logical position ``t``
of a request lives in physical block ``tbl_row[t // block_size]`` at offset
``t % block_size``; table entries are ``NULL_BLOCK`` wherever a slot owns no
block.
"""

from __future__ import annotations

import torch

from repro_torch.models.cache import NULL_BLOCK


def make_table_row(blocks, max_blocks_per_seq: int) -> list[int]:
    """Pad a request's block list to a full table row (null-block padded)."""
    return list(blocks) + [NULL_BLOCK] * (max_blocks_per_seq - len(blocks))


def copy_block_rows(pool_cache: dict, src: int, dst: int) -> dict:
    """Copy one physical block's K/V, in every layer, to another block: the
    copy-on-write step behind partial prefix hits.  A request that shares
    only the leading tokens of a cached block gets the block's rows copied
    into a private block, then overwrites from the divergence point; the
    cached original stays immutable for its other sharers.  In place (the
    JAX package returns a new pool from a donated ``.at[].set``)."""
    for name in ("k", "v"):
        leaf = pool_cache[name]  # (L, N, bs, ...)
        leaf[:, dst].copy_(leaf[:, src])
    return pool_cache


def truncate_block_rows(pool_cache: dict, tbl: torch.Tensor, start: torch.Tensor, end: torch.Tensor, *, span: int) -> dict:
    """Zero the K/V rows of logical positions ``[start, end)`` of every row
    at once: the speculative-decoding rollback.  A verify pass writes its
    whole draft window's K/V before accept/reject; the rejected positions
    are zeroed so the pools never carry live-looking rows past a request's
    committed length.

    ``tbl``: (B, nb) int32 block tables; ``start``/``end``: (B,) int32
    per-row ranges (``end <= start`` makes a row a no-op).  ``span`` is the
    static lane count: each row's candidate positions are ``start + [0,
    span)``, and lanes at or past ``end`` write the null block (all zeros,
    so duplicate writes there are harmless in any order).  In place, with
    no host work, so a CUDA graph can capture it; the JAX package returns
    new pools from a donated ``.at[].set``."""
    positions = start[:, None].long() + torch.arange(span, device=start.device)[None, :]  # (B, span)
    bs = pool_cache["k"].shape[2]
    live = positions < end[:, None]
    # dead lanes may index past the table: clamp, their block is replaced
    idx = torch.clamp(positions // bs, max=tbl.shape[1] - 1)
    phys = torch.where(live, torch.gather(tbl.long(), 1, idx), NULL_BLOCK)
    off = positions % bs
    for name in ("k", "v"):
        leaf = pool_cache[name]  # (L, N, bs, ...)
        leaf[:, phys, off] = torch.zeros((), dtype=leaf.dtype, device=leaf.device)
    return pool_cache
