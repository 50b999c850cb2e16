"""Paged KV cache (vLLM-style block pool + per-slot block tables).

The pools are stacked over layers, ``(L, num_blocks, block_size, kv_heads,
head_dim)``, as in the JAX package's ``models/cache.py``; the decode block
table ``tbl`` is one ``(max_batch, max_blocks_per_seq)`` int32 tensor shared
by every layer (the JAX package stacks a copy per layer for its layer
scan).  Physical blocks may appear in several slots' table rows at once:
the prefix cache (``serving/prefix.py``) shares full prompt blocks by
refcount (``serving/paged.py``).  Shared blocks are write-once.
"""

from __future__ import annotations

import math

import torch

from repro_torch.device import resolve_device

NULL_BLOCK = 0  # physical block 0 is never allocated: inactive batch slots
# and padding entries of short block tables point here, so their (masked)
# decode writes/reads can never touch a live request's blocks.


def paged_cache_layout(cfg, num_blocks: int, block_size: int, max_batch: int, max_blocks_per_seq: int, dtype) -> dict:
    """(shape, dtype) of every leaf of the stacked paged cache."""
    if cfg.family != "dense":
        raise NotImplementedError(f"no paged cache for family {cfg.family!r} ({cfg.name}) in the port")
    L, KV, hd = cfg.num_layers, cfg.num_kv_heads, cfg.head_dim
    pool = ((L, num_blocks, block_size, KV, hd), dtype)
    return {"k": pool, "v": pool, "tbl": ((max_batch, max_blocks_per_seq), torch.int32)}


def init_paged_cache(cfg, num_blocks: int, block_size: int, max_batch: int, max_blocks_per_seq: int, dtype, *, device="cuda") -> dict:
    """Zero-initialized paged cache; tables point at the null block."""
    device = resolve_device(device)
    lay = paged_cache_layout(cfg, num_blocks, block_size, max_batch, max_blocks_per_seq, dtype)
    return {name: torch.zeros(shape, dtype=dt, device=device) for name, (shape, dt) in lay.items()}


def paged_cache_bytes(cfg, num_blocks: int, block_size: int, max_batch: int, max_blocks_per_seq: int, dtype) -> int:
    lay = paged_cache_layout(cfg, num_blocks, block_size, max_batch, max_blocks_per_seq, dtype)
    return sum(math.prod(shape) * dt.itemsize for shape, dt in lay.values())


def layer_cache(cache: dict, layer: int) -> dict:
    """One layer's view of the cache: its pools (views into the stacked
    tensors, so in-place writes land in the cache) and the shared table."""
    return {"k": cache["k"][layer], "v": cache["v"][layer], "tbl": cache["tbl"]}
