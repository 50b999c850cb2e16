"""Attention over a paged KV cache: projections, K/V scatter, and the two
kernel entry points (chunked prefill and decode).

Shapes follow the (batch, seq, heads, head_dim) convention of the JAX
package's ``models/attention.py``.  ``impl="kernel"`` attends through the
CUDA kernel wrappers of ``kernels.paged_attention`` (which take the plain
version for CPU tensors); ``impl="plain"`` calls the plain versions
directly, which on the card serves only as the kernels' yardstick.
"""

from __future__ import annotations

import torch

from repro_torch.kernels.paged_attention import paged_attention, paged_prefill_attention
from repro_torch.kernels.paged_attention_ref import paged_attention_plain, paged_prefill_attention_plain
from repro_torch.models.layers import ParamSpec, apply_rope

ATTN_IMPLS = ("kernel", "plain")


def attention_specs(cfg) -> dict:
    D, H, KV, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    specs = {
        "wq": ParamSpec((D, H, hd), ("embed", "heads", "head_dim")),
        "wk": ParamSpec((D, KV, hd), ("embed", "kv_heads", "head_dim")),
        "wv": ParamSpec((D, KV, hd), ("embed", "kv_heads", "head_dim")),
        "wo": ParamSpec((H, hd, D), ("heads", "head_dim", "embed")),
    }
    if cfg.use_bias:
        specs["bq"] = ParamSpec((H, hd), ("heads", "head_dim"), "zeros")
        specs["bk"] = ParamSpec((KV, hd), ("kv_heads", "head_dim"), "zeros")
        specs["bv"] = ParamSpec((KV, hd), ("kv_heads", "head_dim"), "zeros")
        specs["bo"] = ParamSpec((D,), ("embed",), "zeros")
    if cfg.qk_norm:
        specs["q_norm"] = ParamSpec((hd,), ("head_dim",), "ones")
        specs["k_norm"] = ParamSpec((hd,), ("head_dim",), "ones")
    return specs


# ---------------------------------------------------------------------------
# projections
# ---------------------------------------------------------------------------


def _proj(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """(B, S, D) @ (D, heads, hd) -> (B, S, heads, hd) as one 2-D GEMM."""
    D, nh, hd = w.shape
    return (x @ w.to(x.dtype).reshape(D, nh * hd)).reshape(x.shape[:-1] + (nh, hd))


def _qkv(cfg, p, x):
    q, k, v = _proj(x, p["wq"]), _proj(x, p["wk"]), _proj(x, p["wv"])
    if cfg.use_bias:
        q = q + p["bq"].to(x.dtype)
        k = k + p["bk"].to(x.dtype)
        v = v + p["bv"].to(x.dtype)
    if cfg.qk_norm:
        q = _rms_head(q, p["q_norm"], cfg.norm_eps)
        k = _rms_head(k, p["k_norm"], cfg.norm_eps)
    return q, k, v


def _rms_head(x, scale, eps):
    xf = x.float()
    xf = xf * torch.rsqrt(torch.mean(xf * xf, dim=-1, keepdim=True) + eps)
    return (xf * scale.float()).to(x.dtype)


def _out(cfg, p, ctx, dtype):
    H, hd, D = p["wo"].shape
    out = ctx.to(dtype).reshape(ctx.shape[:-2] + (H * hd,)) @ p["wo"].to(dtype).reshape(H * hd, D)
    if cfg.use_bias:
        out = out + p["bo"].to(dtype)
    return out


def _rope(cfg, q, k, positions):
    if cfg.rotary_pct > 0 and not cfg.learned_pos_embedding:
        q = apply_rope(q, positions, rotary_pct=cfg.rotary_pct, theta=cfg.rope_theta)
        k = apply_rope(k, positions, rotary_pct=cfg.rotary_pct, theta=cfg.rope_theta)
    return q, k


def _scatter(pool: torch.Tensor, phys: torch.Tensor, off: torch.Tensor, rows: torch.Tensor) -> None:
    # in place, where the JAX package returns a new pool from a donated
    # ``.at[phys, off].set`` (the engine owns the only reference)
    pool.index_put_((phys.long(), off.long()), rows.to(pool.dtype))


# ---------------------------------------------------------------------------
# public entry points
# ---------------------------------------------------------------------------


def paged_chunk_attention(cfg, p: dict, x: torch.Tensor, cache: dict, tbl_row: torch.Tensor, start: torch.Tensor, *, impl: str = "kernel"):
    """Chunked-prefill attention against one layer's paged cache.

    x:       (B, C, D) chunk token embedding stream
    cache:   {"k","v": (N, bs, KV, hd) pools of this layer, ...}
    tbl_row: (B, nb) int32, the request's block table covering every
             logical block of prompt + generation
    start:   (B,) int32 absolute position of the chunk's first token.

    The chunk's K/V is scattered into its blocks first (position t lands in
    block ``tbl_row[b, t // bs]`` at offset ``t % bs``), then every chunk
    query attends causally over the logical view [0, start + offset].  The
    pools are updated in place.  Returns the attention output (B, C, D).
    """
    k_pool, v_pool = cache["k"], cache["v"]
    B, C, _ = x.shape
    bs = k_pool.shape[1]
    positions = start[:, None].to(torch.int64) + torch.arange(C, device=x.device)[None, :]  # (B, C)
    q, k, v = _qkv(cfg, p, x)
    q, k = _rope(cfg, q, k, positions)

    idx = torch.clamp(positions // bs, max=tbl_row.shape[1] - 1)
    phys = torch.gather(tbl_row.long(), 1, idx)  # (B, C)
    off = positions % bs
    _scatter(k_pool, phys, off, k)
    _scatter(v_pool, phys, off, v)

    attend = paged_prefill_attention if impl == "kernel" else paged_prefill_attention_plain
    ctx = attend(
        q.contiguous(), k_pool, v_pool, tbl_row, start,
        softcap=cfg.attn_logit_softcap, window=cfg.sliding_window,
    )
    return _out(cfg, p, ctx, x.dtype)


def paged_decode_attention(cfg, p: dict, x: torch.Tensor, cache: dict, pos: torch.Tensor, *, impl: str = "kernel"):
    """Single-token decode against one layer's paged cache.

    x:     (B, 1, D) current token embedding stream
    cache: {"k","v": (N, bs, KV, hd) pools of this layer, "tbl": (B, nb) block table}
    pos:   (B,) int32 absolute position of the current token.

    The new K/V lands in block ``tbl[b, pos // bs]`` at offset ``pos % bs``
    (in place).  Inactive batch slots carry all-null tables, so their writes
    hit the reserved null block, never a live request's memory.  Attention
    runs over the logical view [0, pos].  Returns (B, 1, D).
    """
    k_pool, v_pool, tbl = cache["k"], cache["v"], cache["tbl"]
    B = x.shape[0]
    bs = k_pool.shape[1]
    q, k, v = _qkv(cfg, p, x)
    q, k = _rope(cfg, q, k, pos[:, None])

    pos64 = pos.long()
    phys = tbl.long()[torch.arange(B, device=x.device), pos64 // bs]
    off = pos64 % bs
    _scatter(k_pool, phys, off, k[:, 0])
    _scatter(v_pool, phys, off, v[:, 0])

    seq_lens = (pos + 1).to(torch.int32)
    attend = paged_attention if impl == "kernel" else paged_attention_plain
    ctx = attend(
        q[:, 0].contiguous(), k_pool, v_pool, tbl, seq_lens,
        softcap=cfg.attn_logit_softcap, window=cfg.sliding_window,
    )
    return _out(cfg, p, ctx[:, None], x.dtype)
