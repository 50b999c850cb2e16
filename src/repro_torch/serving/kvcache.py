"""Paged KV-cache surgery on the engine's block pools.

``make_table_row`` pads a request's block list into a table row,
``copy_block_rows`` is the copy-on-write step behind partial prefix hits,
``truncate_block_rows`` the speculative-decoding rollback, and
``gather_block_rows`` / ``restore_block_rows`` the device side of the host
spill tier's demotion and promotion (``serving.spill``).
Layout invariants as in the JAX package's ``serving/kvcache.py``: pools are
``(L, num_blocks, block_size, kv_heads, head_dim)``; logical position ``t``
of a request lives in physical block ``tbl_row[t // block_size]`` at offset
``t % block_size``; table entries are ``NULL_BLOCK`` wherever a slot owns no
block.  Quantized pools carry ``k_scale`` / ``v_scale`` leaves of shape
``(L, num_blocks, block_size, kv_heads, 1)``: every op here that moves K/V
rows moves the scale rows with them.  Every op works in place, so the
fused step's CUDA graphs keep the pools' addresses (``serving.graphs``).
"""

from __future__ import annotations

import torch

from repro_torch.models.cache import NULL_BLOCK

KV_LEAVES = ("k", "v", "k_scale", "v_scale")  # the leaves a block's rows live in


def _row_leaves(pool_cache: dict) -> list[str]:
    return [name for name in KV_LEAVES if name in pool_cache]


def make_table_row(blocks, max_blocks_per_seq: int) -> list[int]:
    """Pad a request's block list to a full table row (null-block padded)."""
    return list(blocks) + [NULL_BLOCK] * (max_blocks_per_seq - len(blocks))


def copy_block_rows(pool_cache: dict, src: int, dst: int) -> dict:
    """Copy one physical block's K/V, in every layer, to another block: the
    copy-on-write step behind partial prefix hits.  A request that shares
    only the leading tokens of a cached block gets the block's rows copied
    into a private block, then overwrites from the divergence point; the
    cached original stays immutable for its other sharers.  Scale rows of
    quantized pools move with their data rows.  In place (the JAX package
    returns a new pool from a donated ``.at[].set``)."""
    for name in _row_leaves(pool_cache):
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
    for name in _row_leaves(pool_cache):
        leaf = pool_cache[name]  # (L, N, bs, ...)
        leaf[:, phys, off] = torch.zeros((), dtype=leaf.dtype, device=leaf.device)
    return pool_cache


def gather_block_rows(pool_cache: dict, block: int) -> dict:
    """One physical block's K/V rows (and scale rows) as a standalone dict of
    ``(L, bs, ...)`` tensors: the device side of a spill-tier demotion,
    called at evict time, before the allocator hands the block out again.

    The rows are copied.  The JAX package's gather returns an immutable
    array that pins the rows while the pool block is reused; ``leaf[:,
    block]`` here would be a view, and the spilled payload would change
    when the block is next written."""
    return {name: pool_cache[name][:, block].clone() for name in _row_leaves(pool_cache)}


def restore_block_rows(pool_cache: dict, blocks: torch.Tensor, rows: dict) -> dict:
    """Scatter previously spilled rows back into the pools: the device side
    of a spill-tier promotion, batched.  ``blocks`` is ``(n,)`` target block
    ids and each ``rows`` leaf ``(L, n, bs, ...)`` (n gathered payloads
    stacked on the block axis), so one call swaps in a whole restore budget.
    Rows are cast to the pool dtype (the spill tier's decompression returns
    fp32; quantized pools carry their scale rows verbatim).  In place, with
    ``index_put_``: the captured graphs keep the pools' addresses."""
    idx = blocks.to(device=pool_cache["k"].device, dtype=torch.long)
    for name, stacked in rows.items():
        leaf = pool_cache[name]  # (L, N, bs, ...)
        leaf[:, idx] = stacked.to(device=leaf.device, dtype=leaf.dtype)
    return pool_cache


def clear_block_row(cfg, pool_cache: dict, slot: int) -> dict:
    """Free a paged request's slot.  The K/V blocks need no wipe: the
    allocator recycles them and the attention masks hide stale positions
    until they are overwritten.  The JAX package resets the hybrid family's
    recurrent states here; the port's dense pools hold none, so nothing
    changes."""
    return pool_cache
