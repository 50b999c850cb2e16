"""Plain PyTorch versions of the two paged-attention kernels.

Mirror of the JAX package's ``kernels/paged_attention_ref.py``: gather the
K/V blocks addressed by each sequence's block table into a contiguous
``(B, nb*bs, KV, hd)`` view and run exact fp32 softmax attention.  Quantized
pools (int8 / e4m3, ``serving.kvquant``) pass their fp32 per-(token, head)
``k_scale`` / ``v_scale`` leaves: the gathered rows are cast to fp32 and
multiplied by the gathered scales, the dequantizing read of the JAX
package's reference, which is also the only read quantized pools have.
The CPU tests hold these against the JAX oracle and the Pallas kernels; on
the card ``kernels.paged_attention`` holds the CUDA kernels against them.
The kernel wrappers call them for tensors that lie on the CPU.

Block-table contract (shared with the kernels): entries past a sequence's
last live block point at the reserved null block (id 0).  They are gathered
like any other block and fully masked by the position compare.

Beside them, what the checks of the redesigned kernels use:
``paged_prefill_attention_split``, the prefill function with q and P
carried as bf16 terms and P V summed per 64-key tile (two terms each are
K2's tensor-core route; one q term is the control "q rounded to bf16"),
and ``paged_attention_split_walk``, K1's walk as the card splits it: the
live positions cut into shares over the blocks of a cluster and the warps
of each block, each share's (max, sum, accumulator) combined.
"""

from __future__ import annotations

import math

import torch

NEG_INF = -2.0e38
WARPS = 4  # the warps of a block of K1 on the card, each walking a share


def gather_blocks(pool: torch.Tensor, block_tables: torch.Tensor) -> torch.Tensor:
    """pool: (N, bs, ...) + tables (B, nb) -> (B, nb*bs, ...) logical view."""
    B, nb = block_tables.shape
    bs = pool.shape[1]
    g = pool[block_tables.long()]  # (B, nb, bs, ...)
    return g.reshape((B, nb * bs) + tuple(pool.shape[2:]))


def gather_kv(pool: torch.Tensor, block_tables: torch.Tensor, scale: torch.Tensor | None) -> torch.Tensor:
    """The gathered view in fp32, dequantized by the gathered scales where
    the pool carries them."""
    x = gather_blocks(pool, block_tables).float()
    return x if scale is None else x * gather_blocks(scale, block_tables)


def paged_attention_plain(
    q: torch.Tensor,  # (B, H, hd) current-token queries
    k_pool: torch.Tensor,  # (N, bs, KV, hd) global block pool
    v_pool: torch.Tensor,
    block_tables: torch.Tensor,  # (B, nb) int32 physical block ids (0 = null)
    seq_lens: torch.Tensor,  # (B,) int32 valid kv length (incl. current token)
    *,
    softcap: float = 0.0,
    window: int = 0,
    k_scale: torch.Tensor | None = None,  # (N, bs, KV, 1) fp32 (quantized pools)
    v_scale: torch.Tensor | None = None,
) -> torch.Tensor:
    """Decode: returns (B, H, hd) attention output in q.dtype."""
    B, H, hd = q.shape
    KV = k_pool.shape[2]
    qpk = H // KV
    scale = 1.0 / math.sqrt(hd)

    k = gather_kv(k_pool, block_tables, k_scale)  # (B, S, KV, hd)
    v = gather_kv(v_pool, block_tables, v_scale)
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


def _shares(lo: int, hi: int, parts: int) -> list[tuple[int, int]]:
    """[lo, hi) cut into ``parts`` even shares, as the kernel cuts it: share
    j is [lo + n j / parts, lo + n (j + 1) / parts), some of them empty."""
    n = hi - lo
    return [(lo + n * j // parts, lo + n * (j + 1) // parts) for j in range(parts)]


def paged_attention_split_walk(
    q: torch.Tensor,  # (B, H, hd) current-token queries
    k_pool: torch.Tensor,  # (N, bs, KV, hd)
    v_pool: torch.Tensor,
    block_tables: torch.Tensor,  # (B, nb) int32
    seq_lens: torch.Tensor,  # (B,) int32
    *,
    splits: int,
    softcap: float = 0.0,
    window: int = 0,
) -> torch.Tensor:
    """K1 as the card walks it: each sequence's live positions [max(0,
    len - window), len) cut into ``splits`` shares (the blocks of a
    cluster), each share into ``WARPS`` shares; every share's softmax
    (max m, sum l, accumulator) in fp32 from its own positions, an empty
    share (m = -inf, l = 0); the warps' shares combined in each block and
    the blocks' in the first.  Lengths are clamped to [1, nb * bs] and
    table entries outside [0, N) read block 0, as in the kernel.  Returns
    (B, H, hd) in q's dtype; nothing on the model path calls it."""
    B, H, hd = q.shape
    N, bs, KV, _ = k_pool.shape
    nb = block_tables.shape[1]
    qpk = H // KV
    scale = 1.0 / math.sqrt(hd)
    tbl = block_tables.long()
    tbl = torch.where((tbl >= 0) & (tbl < N), tbl, torch.zeros_like(tbl))
    out = torch.empty((B, H, hd), dtype=torch.float32)
    for b in range(B):
        n = min(max(int(seq_lens[b]), 1), nb * bs)
        lo = max(n - window, 0) if window > 0 else 0
        pos = torch.arange(nb * bs)
        rows = tbl[b, pos // bs] * bs + pos % bs
        k = k_pool.reshape(N * bs, KV, hd)[rows].float()  # (nb * bs, KV, hd)
        v = v_pool.reshape(N * bs, KV, hd)[rows].float()
        qg = q[b].float().reshape(KV, qpk, hd)
        s = torch.einsum("kgd,pkd->kgp", qg, k) * scale  # (KV, qpk, positions)
        if softcap > 0:
            s = softcap * torch.tanh(s / softcap)
        blocks = []
        for b_lo, b_hi in _shares(lo, n, splits):
            parts = []
            for w_lo, w_hi in _shares(b_lo, b_hi, WARPS):
                if w_hi == w_lo:
                    parts.append((-math.inf, 0.0, 0.0))
                    continue
                sw = s[..., w_lo:w_hi]
                m = sw.amax(-1, keepdim=True)
                p = torch.exp(sw - m)
                parts.append((m, p.sum(-1, keepdim=True), torch.einsum("kgp,pkd->kgd", p, v[w_lo:w_hi])))
            blocks.append(_combine(parts))
        m, l, acc = _combine(blocks)
        out[b] = (acc / torch.clamp(l, min=1e-30)).reshape(H, hd)
    return out.to(q.dtype)


def _combine(parts):
    """(m, l, acc) of disjoint shares -> one: m and l (KV, qpk, 1), acc
    (KV, qpk, hd).  An empty share (m = -inf) weighs nothing, so shares
    that are all empty combine to an empty share, with no NaN."""
    real = [p for p in parts if not (isinstance(p[0], float) and p[0] == -math.inf)]
    if not real:
        return (-math.inf, 0.0, 0.0)
    m = torch.stack([p[0] for p in real]).amax(0)
    l, acc = 0.0, 0.0
    for pm, pl, pacc in real:
        w = torch.exp(pm - m)
        l, acc = l + w * pl, acc + w * pacc
    return m, l, acc


def paged_prefill_attention_plain(
    q: torch.Tensor,  # (B, C, H, hd) chunk queries
    k_pool: torch.Tensor,  # (N, bs, KV, hd) global block pool (chunk K/V written)
    v_pool: torch.Tensor,
    block_tables: torch.Tensor,  # (B, nb) int32 physical block ids (0 = null)
    start: torch.Tensor,  # (B,) int32 absolute position of the chunk's first token
    *,
    softcap: float = 0.0,
    window: int = 0,
    k_scale: torch.Tensor | None = None,  # (N, bs, KV, 1) fp32 (quantized pools)
    v_scale: torch.Tensor | None = None,
) -> torch.Tensor:
    """Chunked prefill: C query tokens per sequence at positions
    ``start + [0, C)`` attend causally (+ window) over the gathered paged
    view.  Returns (B, C, H, hd) in q.dtype."""
    B, C, H, hd = q.shape
    KV = k_pool.shape[2]
    qpk = H // KV
    scale = 1.0 / math.sqrt(hd)

    k = gather_kv(k_pool, block_tables, k_scale)  # (B, S, KV, hd)
    v = gather_kv(v_pool, block_tables, v_scale)
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


def _bf16_terms(x: torch.Tensor, terms: int) -> list[torch.Tensor]:
    """``terms`` bf16 values (as fp32) whose sum carries x: each the bf16
    rounding of what the earlier ones left."""
    parts, rest = [], x
    for _ in range(terms):
        parts.append(rest.bfloat16().float())
        rest = rest - parts[-1]
    return parts


def paged_prefill_attention_split(
    q: torch.Tensor,  # (B, C, H, hd) chunk queries
    k_pool: torch.Tensor,  # (N, bs, KV, hd) bf16 pool
    v_pool: torch.Tensor,
    block_tables: torch.Tensor,  # (B, nb) int32
    start: torch.Tensor,  # (B,) int32
    *,
    q_terms: int,
    p_terms: int,
    softcap: float = 0.0,
    window: int = 0,
    tile: int = 64,
) -> torch.Tensor:
    """The plain prefill with the tensor-core route's roundings: q carried
    as ``q_terms`` bf16 terms (each term's q K summed in fp32), the softmax
    weights P as ``p_terms`` bf16 terms, and P V of each ``tile``-key tile
    of the gathered view summed alone and added in fp32.  ``q_terms=2,
    p_terms=2`` is the kernel's route for fp32 queries; ``q_terms=1`` rounds
    q to bf16.  Nothing on the model path calls it."""
    B, C, H, hd = q.shape
    KV = k_pool.shape[2]
    qpk = H // KV
    scale = 1.0 / math.sqrt(hd)

    k = gather_blocks(k_pool, block_tables).float()  # (B, S, KV, hd)
    v = gather_blocks(v_pool, block_tables).float()
    S = k.shape[1]

    qg = q.float().reshape(B, C, KV, qpk, hd)
    s = sum(torch.einsum("bckgd,bskd->bkcgs", part, k) for part in _bf16_terms(qg, q_terms)) * scale
    if softcap > 0:
        s = softcap * torch.tanh(s / softcap)

    q_pos = start.to(torch.int32)[:, None] + torch.arange(C, dtype=torch.int32, device=q.device)[None, :]
    kv_pos = torch.arange(S, dtype=torch.int32, device=q.device)[None, None, :]
    ok = kv_pos <= q_pos[:, :, None]
    if window > 0:
        ok &= (q_pos[:, :, None] - kv_pos) < window
    s = torch.where(ok[:, None, :, None, :], s, torch.full_like(s, NEG_INF))

    w = torch.softmax(s, dim=-1)
    ctx = 0
    for t0 in range(0, S, tile):
        vt = v[:, t0 : t0 + tile]
        ctx = ctx + sum(
            torch.einsum("bkcgs,bskd->bckgd", part, vt) for part in _bf16_terms(w[..., t0 : t0 + tile], p_terms)
        )
    return ctx.reshape(B, C, H, hd).to(q.dtype)
