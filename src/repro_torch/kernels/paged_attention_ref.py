"""Plain PyTorch versions of the two paged-attention kernels.

Mirror of the JAX package's ``kernels/paged_attention_ref.py`` for
floating-point pools: gather the K/V blocks addressed by each sequence's
block table into a contiguous ``(B, nb*bs, KV, hd)`` view and run exact
fp32 softmax attention.  The CPU tests hold these against the JAX oracle
and the Pallas kernels; on the card ``kernels.paged_attention`` holds the
CUDA kernels against them.  The kernel wrappers call them for tensors that
lie on the CPU.

Block-table contract (shared with the kernels): entries past a sequence's
last live block point at the reserved null block (id 0).  They are gathered
like any other block and fully masked by the position compare.
"""

from __future__ import annotations

import math

import torch

NEG_INF = -2.0e38


def gather_blocks(pool: torch.Tensor, block_tables: torch.Tensor) -> torch.Tensor:
    """pool: (N, bs, ...) + tables (B, nb) -> (B, nb*bs, ...) logical view."""
    B, nb = block_tables.shape
    bs = pool.shape[1]
    g = pool[block_tables.long()]  # (B, nb, bs, ...)
    return g.reshape((B, nb * bs) + tuple(pool.shape[2:]))


def paged_attention_plain(
    q: torch.Tensor,  # (B, H, hd) current-token queries
    k_pool: torch.Tensor,  # (N, bs, KV, hd) global block pool
    v_pool: torch.Tensor,
    block_tables: torch.Tensor,  # (B, nb) int32 physical block ids (0 = null)
    seq_lens: torch.Tensor,  # (B,) int32 valid kv length (incl. current token)
    *,
    softcap: float = 0.0,
    window: int = 0,
) -> torch.Tensor:
    """Decode: returns (B, H, hd) attention output in q.dtype."""
    B, H, hd = q.shape
    KV = k_pool.shape[2]
    qpk = H // KV
    scale = 1.0 / math.sqrt(hd)

    k = gather_blocks(k_pool, block_tables).float()  # (B, S, KV, hd)
    v = gather_blocks(v_pool, block_tables).float()
    S = k.shape[1]

    qg = q.float().reshape(B, KV, qpk, hd)
    s = torch.einsum("bkgd,bskd->bkgs", qg, k) * scale  # (B, KV, qpk, S)
    if softcap > 0:
        s = softcap * torch.tanh(s / softcap)

    kv_pos = torch.arange(S, dtype=torch.int32, device=q.device)[None, :]
    lens = seq_lens.to(torch.int32)[:, None]
    ok = kv_pos < lens  # causal: everything written so far
    if window > 0:
        ok &= (lens - 1 - kv_pos) < window
    s = torch.where(ok[:, None, None, :], s, torch.full_like(s, NEG_INF))

    w = torch.softmax(s, dim=-1)
    ctx = torch.einsum("bkgs,bskd->bkgd", w, v)
    return ctx.reshape(B, H, hd).to(q.dtype)


def paged_prefill_attention_plain(
    q: torch.Tensor,  # (B, C, H, hd) chunk queries
    k_pool: torch.Tensor,  # (N, bs, KV, hd) global block pool (chunk K/V written)
    v_pool: torch.Tensor,
    block_tables: torch.Tensor,  # (B, nb) int32 physical block ids (0 = null)
    start: torch.Tensor,  # (B,) int32 absolute position of the chunk's first token
    *,
    softcap: float = 0.0,
    window: int = 0,
) -> torch.Tensor:
    """Chunked prefill: C query tokens per sequence at positions
    ``start + [0, C)`` attend causally (+ window) over the gathered paged
    view.  Returns (B, C, H, hd) in q.dtype."""
    B, C, H, hd = q.shape
    KV = k_pool.shape[2]
    qpk = H // KV
    scale = 1.0 / math.sqrt(hd)

    k = gather_blocks(k_pool, block_tables).float()  # (B, S, KV, hd)
    v = gather_blocks(v_pool, block_tables).float()
    S = k.shape[1]

    qg = q.float().reshape(B, C, KV, qpk, hd)
    s = torch.einsum("bckgd,bskd->bkcgs", qg, k) * scale  # (B, KV, C, qpk, S)
    if softcap > 0:
        s = softcap * torch.tanh(s / softcap)

    q_pos = start.to(torch.int32)[:, None] + torch.arange(C, dtype=torch.int32, device=q.device)[None, :]
    kv_pos = torch.arange(S, dtype=torch.int32, device=q.device)[None, None, :]
    ok = kv_pos <= q_pos[:, :, None]  # causal: chunk K/V is already written
    if window > 0:
        ok &= (q_pos[:, :, None] - kv_pos) < window
    s = torch.where(ok[:, None, :, None, :], s, torch.full_like(s, NEG_INF))

    w = torch.softmax(s, dim=-1)
    ctx = torch.einsum("bkcgs,bskd->bckgd", w, v)
    return ctx.reshape(B, C, H, hd).to(q.dtype)
