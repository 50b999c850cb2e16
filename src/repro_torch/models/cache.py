"""Decode caches: the paged KV cache (vLLM-style block pool + per-slot
block tables) and the dense ring cache, for the families the port serves
(``SERVED_FAMILIES``: dense and moe, whose layers cache the same K/V).

The dense ring cache (``init_cache``), as in the JAX package's
``models/cache.py``: per layer ``k``/``v`` ``(B, W, kv_heads, head_dim)``
and ``pos`` ``(B, W)``, stacked over layers, where ``W`` is the run's
length or the sliding window (``cache_window``) and position ``t`` lives in
ring slot ``t % W``; ``pos`` holds the absolute position in each slot, -1
while it is empty.  It backs the engine's ``cache_kind="dense"`` (one row
per batch slot, filled from a whole-prompt ``models.prefill`` by
``serving.kvcache``) and the speculative drafter's per-slot batch=1
caches; ``cache_bytes`` is its size.

The pools are stacked over layers, ``(L, num_blocks, block_size, kv_heads,
head_dim)``, as in the JAX package's ``models/cache.py``; the decode block
table ``tbl`` is one ``(max_batch, max_blocks_per_seq)`` int32 tensor shared
by every layer (the JAX package stacks a copy per layer for its layer
scan).  Physical blocks may appear in several slots' table rows at once:
the prefix cache (``serving/prefix.py``) shares full prompt blocks by
refcount (``serving/paged.py``).  Shared blocks are write-once.

Quantized pools (``quantized="int8"|"fp8"``, ``True`` for int8) store
``k``/``v`` in the ``serving.kvquant`` storage dtype with fp32
per-(token, head) scales in sibling ``k_scale``/``v_scale`` leaves of
shape ``(L, num_blocks, block_size, kv_heads, 1)``.
"""

from __future__ import annotations

import math

import torch

from repro_torch.device import resolve_device

NULL_BLOCK = 0  # physical block 0 is never allocated: inactive batch slots
# and padding entries of short block tables point here, so their (masked)
# decode writes/reads can never touch a live request's blocks.


# growing-KV attention families page their cache; recurrent states are O(1)
# per request and vlm's grouped layers keep the dense layout
PAGED_FAMILIES = ("dense", "moe", "hybrid")
# the families whose serving steps and caches the port has (both cache one
# K/V per layer)
SERVED_FAMILIES = ("dense", "moe")


def supports_paged(cfg) -> bool:
    """Whether ``cfg``'s family pages its KV cache, as in the JAX package."""
    return cfg.family in PAGED_FAMILIES


def cache_window(cfg, seq_len: int) -> int:
    """Slots the attention cache needs for a decode run of length seq_len."""
    if cfg.sliding_window > 0:
        return min(cfg.sliding_window, seq_len)
    return seq_len


def layer_cache_layout(cfg, B: int, seq_len: int, dtype) -> dict:
    """(shape, dtype) of one layer's dense ring cache."""
    if cfg.family not in SERVED_FAMILIES:
        raise NotImplementedError(f"no dense cache for family {cfg.family!r} ({cfg.name}) in the port")
    W, KV, hd = cache_window(cfg, seq_len), cfg.num_kv_heads, cfg.head_dim
    return {"k": ((B, W, KV, hd), dtype), "v": ((B, W, KV, hd), dtype), "pos": ((B, W), torch.int32)}


def init_cache(cfg, B: int, seq_len: int, dtype, *, device="cuda") -> dict:
    """Zero dense ring cache stacked over layers, every slot empty (pos -1)."""
    device = resolve_device(device)
    lay = layer_cache_layout(cfg, B, seq_len, dtype)
    cache = {name: torch.zeros((cfg.num_layers,) + shape, dtype=dt, device=device) for name, (shape, dt) in lay.items()}
    cache["pos"].fill_(-1)
    return cache


def cache_bytes(cfg, B: int, seq_len: int, dtype) -> int:
    """Bytes of the dense ring cache ``init_cache(cfg, B, seq_len, dtype)``
    holds: K/V, positions, every layer."""
    lay = layer_cache_layout(cfg, B, seq_len, dtype)
    return cfg.num_layers * sum(math.prod(shape) * dt.itemsize for shape, dt in lay.values())


def paged_cache_layout(
    cfg, num_blocks: int, block_size: int, max_batch: int, max_blocks_per_seq: int, dtype, *,
    quantized: bool | str = False,
) -> dict:
    """(shape, dtype) of every leaf of the stacked paged cache; with
    ``quantized`` the pools hold int8/e4m3 rows beside fp32 scale leaves."""
    if cfg.family not in SERVED_FAMILIES:
        raise NotImplementedError(f"no paged cache for family {cfg.family!r} ({cfg.name}) in the port")
    from repro_torch.serving.kvquant import kv_storage_dtype

    L, KV, hd = cfg.num_layers, cfg.num_kv_heads, cfg.head_dim
    pool = ((L, num_blocks, block_size, KV, hd), kv_storage_dtype(quantized) if quantized else dtype)
    lay = {"k": pool, "v": pool, "tbl": ((max_batch, max_blocks_per_seq), torch.int32)}
    if quantized:
        scale = ((L, num_blocks, block_size, KV, 1), torch.float32)
        lay.update(k_scale=scale, v_scale=scale)
    return lay


def init_paged_cache(
    cfg, num_blocks: int, block_size: int, max_batch: int, max_blocks_per_seq: int, dtype, *,
    quantized: bool | str = False, device="cuda",
) -> dict:
    """Zero-initialized paged cache; tables point at the null block."""
    device = resolve_device(device)
    lay = paged_cache_layout(cfg, num_blocks, block_size, max_batch, max_blocks_per_seq, dtype, quantized=quantized)
    return {name: torch.zeros(shape, dtype=dt, device=device) for name, (shape, dt) in lay.items()}


def paged_cache_bytes(
    cfg, num_blocks: int, block_size: int, max_batch: int, max_blocks_per_seq: int, dtype, *,
    quantized: bool | str = False,
) -> int:
    lay = paged_cache_layout(cfg, num_blocks, block_size, max_batch, max_blocks_per_seq, dtype, quantized=quantized)
    return sum(math.prod(shape) * dt.itemsize for shape, dt in lay.values())


def layer_cache(cache: dict, layer: int) -> dict:
    """One layer's view of either cache: its leaves (views into the stacked
    tensors, so in-place writes land in the cache) and, for the paged
    cache, the shared table."""
    return {name: t if name == "tbl" else t[layer] for name, t in cache.items()}
