"""KV-cache surgery: prefill -> dense slot cache, and the paged block pools.

Dense layout (``cache_kind="dense"``), as in the JAX package's
``serving/kvcache.py``: ``decode_cache_from_prefill`` turns the full-length
K/V that ``models.prefill`` returns into the fixed-size ring cache that
``decode_step`` reads (sliding-window archs keep only the last W tokens;
ring slot = pos % W), ``write_request_into_slot`` copies one request's
cache into one batch slot of the engine's cache, ``write_prefill_into_slot``
(the engine's admission) does both at once without the request-sized ring
in between, and ``clear_slot`` empties a freed slot.  The served families
(``models.cache.SERVED_FAMILIES``): dense and moe K/V rings, the hybrid
family's ring beside its ``conv`` / ``ssm`` states (copied as they are:
O(1) a slot), the ssm family's ``tm_x`` / ``cm_x`` / ``state`` (no ring),
and the vlm family's layer groups: ``self`` rings ``(G, g, B, ...)`` and
``cross`` image K/V ``ck`` / ``cv`` ``(G, B, N, KV, hd)``, copied as they
are (fixed for the request).  Every leaf is ``(L, B, ...)``, the batch slot
at dim 1, once a vlm cache is seen through ``_slot_leaves``: its ``self``
leaves as ``(G * g, B, ...)`` views (the JAX package finds the slot from
the logical axes instead: dim 2 of ``self``, dim 1 of ``cross``).

Paged layout: ``graft_prefill_into_blocks`` writes a whole prefill's K/V
into a request's blocks, ``make_table_row`` pads a request's block list
into a table row, ``copy_block_rows`` is the copy-on-write step behind
partial prefix hits, ``truncate_block_rows`` the speculative-decoding
rollback, and ``gather_block_rows`` / ``restore_block_rows`` the device
side of the host spill tier's demotion and promotion (``serving.spill``).
Layout invariants as in the JAX package: pools are
``(L, num_blocks, block_size, kv_heads, head_dim)``; logical position ``t``
of a request lives in physical block ``tbl_row[t // block_size]`` at offset
``t % block_size``; table entries are ``NULL_BLOCK`` wherever a slot owns no
block.  Quantized pools carry ``k_scale`` / ``v_scale`` leaves of shape
``(L, num_blocks, block_size, kv_heads, 1)``: every op here that moves K/V
rows moves the scale rows with them.  Every op on an engine cache works in
place (the JAX functions return new trees), so the fused step's CUDA graphs
keep the pools' addresses (``serving.graphs``).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models.cache import NULL_BLOCK, SERVED_FAMILIES, cache_window, init_cache

KV_LEAVES = ("k", "v", "k_scale", "v_scale")  # the leaves a block's rows live in
# copied into a slot as they are, one row a batch slot: recurrent states
# and the vlm cross layers' image K/V
STATE_LEAVES = ("conv", "ssm", "tm_x", "cm_x", "state", "ck", "cv")


def _row_leaves(pool_cache: dict) -> list[str]:
    return [name for name in KV_LEAVES if name in pool_cache]


# ---------------------------------------------------------------------------
# dense slot cache
# ---------------------------------------------------------------------------


def _ring_kv(full: torch.Tensor, seq_filled: int, W: int) -> tuple[torch.Tensor, torch.Tensor]:
    """full: (L, B, S, KV, hd) -> ring (L, B, W, KV, hd) and pos (B, W): the
    last ``min(W, seq_filled)`` positions at slot ``t % W``, -1 elsewhere."""
    L, B = full.shape[:2]
    start = max(seq_filled - W, 0)
    idx = torch.arange(start, start + min(W, seq_filled), device=full.device)
    slots = idx % W
    ring = torch.zeros((L, B, W) + tuple(full.shape[3:]), dtype=full.dtype, device=full.device)
    ring[:, :, slots] = full[:, :, idx]
    pos = torch.full((B, W), -1, dtype=torch.int32, device=full.device)
    pos[:, slots] = idx.to(torch.int32)
    return ring, pos


def _check_served(cfg) -> None:
    if cfg.family not in SERVED_FAMILIES:
        raise NotImplementedError(f"no dense cache for family {cfg.family!r} ({cfg.name}) in the port")


def _slot_leaves(cfg, cache: dict) -> dict:
    """The leaves of a slot cache or a raw prefill cache as one flat dict
    whose batch slot is dim 1: the vlm family's ``self`` leaves ``(G, g, B,
    ...)`` as ``(G * g, B, ...)`` views (so writes land in ``cache``) beside
    its ``cross`` leaves; other families' caches as they are."""
    if cfg.family != "vlm":
        return cache
    return {**{name: t.view((-1,) + tuple(t.shape[2:])) for name, t in cache["self"].items()}, **cache["cross"]}


def decode_cache_from_prefill(cfg, raw_cache: dict, *, seq_filled: int, decode_len: int) -> dict:
    """The slot cache of the prompt a ``models.prefill`` call read: the first
    ``seq_filled`` positions of its raw K/V, in a window of
    ``cache_window(cfg, decode_len)`` slots (``decode_len``: the positions
    the decode run must address, prompt plus new tokens).  A prompt longer
    than a sliding window wraps the ring.  Returns ``{"k", "v": (L, B, W,
    KV, hd), "pos": (L, B, W)}``, the layers sharing one position row, and
    beside them the hybrid family's ``conv`` / ``ssm`` states as they are;
    the ssm family's states pass through (O(1) decode).  A vlm cache keeps
    its nesting: ``{"self": {"k", "v": (G, g, B, W, KV, hd), "pos": (G,
    g, B, W)}, "cross": the image K/V as they are}``."""
    _check_served(cfg)
    flat = _slot_leaves(cfg, raw_cache)
    states = {name: t for name, t in flat.items() if name in STATE_LEAVES}
    if cfg.family == "ssm":
        return states
    W = cache_window(cfg, decode_len)
    k, pos = _ring_kv(flat["k"], seq_filled, W)
    v, _ = _ring_kv(flat["v"], seq_filled, W)
    ring = {"k": k, "v": v, "pos": pos[None].expand((k.shape[0],) + tuple(pos.shape))}
    if cfg.family == "vlm":
        G, g = raw_cache["self"]["k"].shape[:2]
        return {"self": {name: t.reshape((G, g) + tuple(t.shape[1:])) for name, t in ring.items()},
                "cross": states}
    return {**ring, **states}


def write_request_into_slot(cfg, engine_cache: dict, request_cache: dict, slot: int) -> dict:
    """Copy a (batch=1) request cache into batch slot ``slot`` of the
    engine's ring cache, in place, cast to the engine cache's dtypes."""
    request = _slot_leaves(cfg, request_cache)
    for name, leaf in _slot_leaves(cfg, engine_cache).items():
        leaf[:, slot] = request[name][:, 0].to(leaf.dtype)
    return engine_cache


def write_prefill_into_slot(cfg, engine_cache: dict, raw_cache: dict, slot: int, *, seq_filled: int) -> dict:
    """The engine's admission in one step, in place: the first
    ``seq_filled`` positions of a (batch=1) ``models.prefill``'s raw K/V
    straight into batch slot ``slot``'s ring rows (slot ``t % W``, the last
    W positions where a sliding window wraps), cast to the cache's dtype,
    and the slot's position row set to match.  The same slot as
    ``decode_cache_from_prefill`` then ``write_request_into_slot`` give, but
    with no (L, 1, W, KV, hd) request ring built on the way; ring rows that
    the prompt does not reach keep whatever they held, under position -1
    (``clear_slot`` zeroes them when a request leaves).  Recurrent states
    (the hybrid and ssm families') go into the slot's rows as they are,
    cast to their leaves' dtypes, and so does the vlm family's image K/V."""
    _check_served(cfg)
    cache, raw = _slot_leaves(cfg, engine_cache), _slot_leaves(cfg, raw_cache)
    for name in STATE_LEAVES:
        if name in cache:
            leaf = cache[name]
            leaf[:, slot] = raw[name][:, 0].to(leaf.dtype)
    if cfg.family == "ssm":
        return engine_cache
    k = cache["k"]
    W = k.shape[2]
    start = max(seq_filled - W, 0)
    idx = torch.arange(start, seq_filled, device=k.device)
    ring = idx % W
    for name in ("k", "v"):
        leaf = cache[name]
        leaf[:, slot, ring] = raw[name][:, 0, idx].to(leaf.dtype)
    pos = cache["pos"]
    pos[:, slot] = -1
    pos[:, slot, ring] = idx.to(pos.dtype)
    return engine_cache


def clear_slot(cfg, engine_cache: dict, slot: int) -> dict:
    """Empty one batch slot of the slot cache (a freed request), in place:
    K/V, recurrent states and image K/V zero, positions -1."""
    for name, leaf in _slot_leaves(cfg, engine_cache).items():
        leaf[:, slot] = -1 if name == "pos" else 0
    return engine_cache


def make_engine_cache(
    cfg, max_batch: int, max_seq: int, dtype=torch.bfloat16, *, device="cuda", kv_heads: int | None = None
) -> dict:
    """The engine's dense slot cache: ``max_batch`` empty rows (ring rows of
    ``cache_window(cfg, max_seq)`` slots at ``kv_heads`` heads, zero
    recurrent states)."""
    return init_cache(cfg, max_batch, max_seq, dtype, device=device, kv_heads=kv_heads)


# ---------------------------------------------------------------------------
# paged block pools
# ---------------------------------------------------------------------------


def graft_prefill_into_blocks(cfg, pool_cache: dict, raw_cache: dict, blocks, seq_filled: int, slot: int) -> dict:
    """Write a (batch=1) prefill's raw K/V into the pool blocks a request was
    allocated, in place.  ``blocks`` cover logical positions ``[0,
    len(blocks) * bs)``; positions at or past ``seq_filled`` (right-padded
    bucketed prefill, the partial last block) are written as zeros, so a
    reused block never leaks stale K/V.  Quantized pools take the rows'
    codes and scales.  The hybrid family's ``conv`` / ``ssm`` states go into
    batch slot ``slot`` of their slot-dense leaves, cast to the leaves'
    dtypes."""
    from repro_torch.serving.kvquant import kv_quant_mode_of, quantize

    bs = pool_cache["k"].shape[2]
    span = len(blocks) * bs
    idx = torch.as_tensor(list(blocks), dtype=torch.long, device=pool_cache["k"].device)
    mode = kv_quant_mode_of(pool_cache["k"].dtype)
    for name in ("k", "v"):
        kv = raw_cache[name][:, 0]  # (L, S, KV, hd)
        L, S = kv.shape[:2]
        kv = F.pad(kv, (0, 0, 0, 0, 0, max(span - S, 0)))[:, :span]
        valid = torch.arange(span, device=kv.device) < seq_filled
        kv = torch.where(valid[None, :, None, None], kv, torch.zeros((), dtype=kv.dtype, device=kv.device))
        leaves = {name: kv} if mode is None else dict(zip((name, f"{name}_scale"), quantize(kv, mode)))
        for leaf_name, rows in leaves.items():
            pool = pool_cache[leaf_name]  # (L, N, bs, ...)
            pool[:, idx] = rows.reshape((L, len(blocks), bs) + tuple(rows.shape[2:])).to(pool.dtype)
    for name in ("conv", "ssm"):
        if name in pool_cache:
            leaf = pool_cache[name]
            leaf[:, slot] = raw_cache[name][:, 0].to(leaf.dtype)
    return pool_cache


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
    """Free a paged request's slot, in place: the hybrid family's ``conv`` /
    ``ssm`` states of batch slot ``slot`` go to zero.  The K/V blocks need
    no wipe: the allocator recycles them and the attention masks hide
    stale positions until they are overwritten."""
    for name in ("conv", "ssm"):
        if name in pool_cache:
            pool_cache[name][:, slot] = 0
    return pool_cache
