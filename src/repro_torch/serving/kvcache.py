"""Paged KV-cache surgery on the engine's block pools.

``make_table_row`` pads a request's block list into a table row, and
``copy_block_rows`` is the copy-on-write step behind partial prefix hits.
Layout invariants as in the JAX package's ``serving/kvcache.py``: pools are
``(L, num_blocks, block_size, kv_heads, head_dim)``; logical position ``t``
of a request lives in physical block ``tbl_row[t // block_size]`` at offset
``t % block_size``; table entries are ``NULL_BLOCK`` wherever a slot owns no
block.
"""

from __future__ import annotations

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
