"""Decode caches: the paged KV cache (vLLM-style block pool + per-slot
block tables) and the dense slot cache, for the families the port serves
(``SERVED_FAMILIES``: dense, moe, hybrid, ssm and vlm).

The dense slot cache (``init_cache``), as in the JAX package's
``models/cache.py``, per layer and stacked over layers:

* dense, moe: the ring cache ``k``/``v`` ``(B, W, kv_heads, head_dim)``
  and ``pos`` ``(B, W)``, where ``W`` is the run's length or the sliding
  window (``cache_window``) and position ``t`` lives in ring slot ``t %
  W``; ``pos`` holds the absolute position in each slot, -1 while it is
  empty;
* hybrid (hymba): the ring cache and the SSM heads' recurrent states,
  ``conv`` ``(B, conv_width - 1, d_inner)`` in the cache dtype and ``ssm``
  ``(B, H, P, N)`` in fp32;
* ssm (RWKV6): no K/V, the last token of each mix, ``tm_x`` and ``cm_x``
  ``(B, D)`` in the cache dtype, and the WKV state ``state`` ``(B, H, n,
  n)`` in fp32;
* vlm (llama-3.2-vision): one entry per layer group
  (``num_scan_groups``), nested as the JAX package's: ``"self"``, the ring
  cache of the group's ``g = cross_attn_every - 1`` self layers, ``k``/``v``
  ``(g, B, W, kv_heads, head_dim)`` and ``pos`` ``(g, B, W)``, and
  ``"cross"``, the image tokens' projected K/V of its cross layer, ``ck``/
  ``cv`` ``(B, num_image_tokens, kv_heads, head_dim)`` in the cache dtype.
  Stacked over groups, the batch slot is dim 2 of the ``self`` leaves and
  dim 1 of the ``cross`` leaves.

It backs the engine's ``cache_kind="dense"`` (one row per batch slot,
filled from a whole-prompt ``models.prefill`` by ``serving.kvcache``) and
the speculative drafter's per-slot batch=1 caches; ``cache_bytes`` is its
size.  A decode step returns the ``conv`` / ``tm_x`` / ``cm_x`` leaves in
the dtype it computed them in, as the JAX package's layer scan does
(``models.decode_step``).

The pools are stacked over layers, ``(L, num_blocks, block_size, kv_heads,
head_dim)``, as in the JAX package's ``models/cache.py``; the decode block
table ``tbl`` is one ``(max_batch, max_blocks_per_seq)`` int32 tensor shared
by every layer (the JAX package stacks a copy per layer for its layer
scan).  Physical blocks may appear in several slots' table rows at once:
the prefix cache (``serving/prefix.py``) shares full prompt blocks by
refcount (``serving/paged.py``).  Shared blocks are write-once.  The
hybrid family's recurrent states stay slot-dense beside the pools: ``conv``
``(L, max_batch, conv_width - 1, d_inner)`` and ``ssm`` ``(L, max_batch,
H, P, N)``, O(1) a request, nothing to page.  The ssm family has no paged
layout (its state is O(1) a request).

Quantized pools (``quantized="int8"|"fp8"``, ``True`` for int8) store
``k``/``v`` in the ``serving.kvquant`` storage dtype with fp32
per-(token, head) scales in sibling ``k_scale``/``v_scale`` leaves of
shape ``(L, num_blocks, block_size, kv_heads, 1)``.

Under tensor-parallel serving each rank builds its caches at its own kv
heads (``kv_heads=``, ``parallel.sharding.local_kv_heads``): the pools, the
rings and the image K/V hold the rank's head slice of every block and slot,
while the block table and the recurrent states are whole on every rank.
"""

from __future__ import annotations

import math

import torch

from repro_torch.device import resolve_device
from repro_torch.models import ssm as ssm_mod

NULL_BLOCK = 0  # physical block 0 is never allocated: inactive batch slots
# and padding entries of short block tables point here, so their (masked)
# decode writes/reads can never touch a live request's blocks.


# growing-KV attention families page their cache; recurrent states are O(1)
# per request and vlm's grouped layers keep the dense layout
PAGED_FAMILIES = ("dense", "moe", "hybrid")
# the families whose serving steps and caches the port has
SERVED_FAMILIES = ("dense", "moe", "hybrid", "ssm", "vlm")


def num_scan_groups(cfg) -> int:
    """Entries of the block list and of the stacked cache: the vlm family's
    layer groups (``cross_attn_every - 1`` self layers and a cross layer),
    else the layers."""
    if cfg.family == "vlm":
        if cfg.num_layers % cfg.vision.cross_attn_every:
            raise ValueError(f"{cfg.name}: {cfg.num_layers} layers are not whole groups of {cfg.vision.cross_attn_every}")
        return cfg.num_layers // cfg.vision.cross_attn_every
    return cfg.num_layers


def supports_paged(cfg) -> bool:
    """Whether ``cfg``'s family pages its KV cache, as in the JAX package."""
    return cfg.family in PAGED_FAMILIES


def cache_window(cfg, seq_len: int) -> int:
    """Slots the attention cache needs for a decode run of length seq_len."""
    if cfg.sliding_window > 0:
        return min(cfg.sliding_window, seq_len)
    return seq_len


def _ssm_states(cfg, B: int, dtype) -> dict:
    """(shape, dtype) of a hybrid layer's recurrent states for B slots."""
    H, P = cfg.num_heads, ssm_mod.head_dim_inner(cfg)
    di, K, N = ssm_mod.d_inner(cfg), cfg.ssm.conv_width, cfg.ssm.state_size
    return {"conv": ((B, K - 1, di), dtype), "ssm": ((B, H, P, N), torch.float32)}


def layer_cache_layout(cfg, B: int, seq_len: int, dtype, *, kv_heads: int | None = None, seq_shards: int = 1) -> dict:
    """(shape, dtype) of one layer's dense slot cache (a vlm layer group's:
    ``{"self": {...}, "cross": {...}}``), its K/V at ``kv_heads`` (default
    all of them), its ring's slots split over ``seq_shards`` ranks (one
    rank's share: ``models.decode_step(kv_seq_split=True)``)."""
    if cfg.family not in SERVED_FAMILIES:
        raise NotImplementedError(f"no dense cache for family {cfg.family!r} ({cfg.name}) in the port")
    if cfg.family == "ssm":
        H, n, D = cfg.num_heads, cfg.rwkv.head_size, cfg.d_model
        return {"tm_x": ((B, D), dtype), "cm_x": ((B, D), dtype), "state": ((B, H, n, n), torch.float32)}
    W, KV, hd = cache_window(cfg, seq_len) // seq_shards, kv_heads or cfg.num_kv_heads, cfg.head_dim
    lay = {"k": ((B, W, KV, hd), dtype), "v": ((B, W, KV, hd), dtype), "pos": ((B, W), torch.int32)}
    if cfg.family == "hybrid":
        lay.update(_ssm_states(cfg, B, dtype))
    if cfg.family == "vlm":
        g, N = cfg.vision.cross_attn_every - 1, cfg.vision.num_image_tokens
        image = ((B, N, KV, hd), dtype)
        return {"self": {name: ((g,) + shape, dt) for name, (shape, dt) in lay.items()},
                "cross": {"ck": image, "cv": image}}
    return lay


def _layout_leaves(lay: dict) -> list:
    """The (shape, dtype) leaves of a (possibly nested) layout."""
    return [leaf for v in lay.values() for leaf in (_layout_leaves(v) if isinstance(v, dict) else [v])]


def init_cache(cfg, B: int, seq_len: int, dtype, *, device="cuda", kv_heads: int | None = None,
               seq_shards: int = 1) -> dict:
    """Zero dense slot cache stacked over layers (vlm: layer groups), every
    ring slot empty (pos -1), every state zero; ``kv_heads`` and
    ``seq_shards`` as ``layer_cache_layout``'s."""
    device = resolve_device(device)
    G = num_scan_groups(cfg)

    def make(lay):
        out = {}
        for name, v in lay.items():
            if isinstance(v, dict):
                out[name] = make(v)
            else:
                out[name] = torch.full((G,) + v[0], -1 if name == "pos" else 0, dtype=v[1], device=device)
        return out

    return make(layer_cache_layout(cfg, B, seq_len, dtype, kv_heads=kv_heads, seq_shards=seq_shards))


def cache_bytes(cfg, B: int, seq_len: int, dtype) -> int:
    """Bytes of the dense slot cache ``init_cache(cfg, B, seq_len, dtype)``
    holds: K/V, positions, recurrent states and image K/V, every layer."""
    lay = layer_cache_layout(cfg, B, seq_len, dtype)
    return num_scan_groups(cfg) * sum(math.prod(shape) * dt.itemsize for shape, dt in _layout_leaves(lay))


def paged_cache_layout(
    cfg, num_blocks: int, block_size: int, max_batch: int, max_blocks_per_seq: int, dtype, *,
    quantized: bool | str = False, kv_heads: int | None = None,
) -> dict:
    """(shape, dtype) of every leaf of the stacked paged cache; with
    ``quantized`` the pools hold int8/e4m3 rows beside fp32 scale leaves;
    the hybrid family's ``conv`` / ``ssm`` states are slot-dense beside
    them (``max_batch`` rows a layer, in ``dtype`` and fp32).  The pools
    hold ``kv_heads`` heads (default all of them)."""
    if not supports_paged(cfg):
        raise ValueError(f"no paged cache for family {cfg.family!r} ({cfg.name})")
    from repro_torch.serving.kvquant import kv_storage_dtype

    L, KV, hd = cfg.num_layers, kv_heads or cfg.num_kv_heads, cfg.head_dim
    pool = ((L, num_blocks, block_size, KV, hd), kv_storage_dtype(quantized) if quantized else dtype)
    lay = {"k": pool, "v": pool, "tbl": ((max_batch, max_blocks_per_seq), torch.int32)}
    if quantized:
        scale = ((L, num_blocks, block_size, KV, 1), torch.float32)
        lay.update(k_scale=scale, v_scale=scale)
    if cfg.family == "hybrid":
        # recurrent states stay slot-dense: O(1) per request, nothing to page
        lay.update({name: ((L,) + shape, dt) for name, (shape, dt) in _ssm_states(cfg, max_batch, dtype).items()})
    return lay


def init_paged_cache(
    cfg, num_blocks: int, block_size: int, max_batch: int, max_blocks_per_seq: int, dtype, *,
    quantized: bool | str = False, device="cuda", kv_heads: int | None = None,
) -> dict:
    """Zero-initialized paged cache; tables point at the null block."""
    device = resolve_device(device)
    lay = paged_cache_layout(
        cfg, num_blocks, block_size, max_batch, max_blocks_per_seq, dtype, quantized=quantized, kv_heads=kv_heads
    )
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
