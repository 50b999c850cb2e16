"""Attention: full-sequence self-attention (training, forward) and attention
over a paged KV cache (chunked prefill and decode).

Shapes follow the (batch, seq, heads, head_dim) convention of the JAX
package's ``models/attention.py``.

* ``self_attention``: ``impl="torch"`` is the counterpart of the JAX
  package's ``"xla"``: attention in tensor ops, differentiable, with
  optional query chunking; the train step uses it.  ``impl="flash"`` runs
  the flash-attention kernel K3 (``kernels.flash_attention``), forward only.
* ``prefill_attention`` and ``decode_attention``: the dense slot cache's
  walk, in tensor ops as in the JAX package (no Pallas kernel there
  either): a whole prompt's self-attention that also returns its K/V, and
  one decode token against the dense ring cache
  (``models.cache.init_cache``).  The engine's ``cache_kind="dense"`` and
  the speculative drafter decode through the latter.
* ``cross_attention``: the vlm family's attention onto image tokens, in
  tensor ops as in the JAX package: unmasked, unpositioned, its output
  scaled by ``tanh(gate)`` (``attention_specs(cfg, cross=True)``).
* the paged functions: ``impl="kernel"`` attends through the CUDA kernel
  wrappers of ``kernels.paged_attention`` (which take the plain version for
  CPU tensors); ``impl="plain"`` calls the plain versions directly, which on
  the card serves only as the kernels' yardstick.  Quantized pools
  (int8 / e4m3, ``serving.kvquant``) quantize K/V on the way in, into the
  pools and their scale leaves, and read through the dequantizing plain
  path whatever ``impl`` says: they have no kernel, in the JAX package as
  here.

Tensor-parallel serving (``mesh=``, ``parallel.sharding``): a rank whose
parameters hold a slice of the heads projects Q/K/V for those heads
(column-parallel), reads and writes its own head slice of the paged pools,
runs K1/K2 on it, and sums the output projection over the ranks with one
all-reduce (``_out``).  Each rank's query heads lie in whole GQA groups
(``parallel.sharding.attention_layout``): under ``"split"`` its wk / wv
hold their kv heads; under ``"grouped"`` (the query heads divide the
model axis, the axis divides the kv heads' count) its wk / wv hold every
kv head and the rank projects its group's one (``_kv_weights``: the
leaves through ``copy_to_model``, so training sums every rank's share of
their gradients), attends with its ``H / tp`` query heads over it, and
its pools hold that head.  The GQA ratio of every product is read from
the local shapes.  RoPE, the q/k norms and the window are per head and
unchanged.  Sharded training (``self_attention(mesh=)``) runs the
same layout under autograd: the input goes through ``copy_to_model``
(its gradient summed over the ranks), and so do the q/k norm scales, which
every rank applies to its own heads only; the output's sum is
``sum_over_model``, the identity backward.  Under sequence parallelism
(``sp=True``) the input is the block's ``SeqGather`` of its seq slices
and the output this rank's seq slice: where the heads split, the
attention reads the gathered sequence's ``split()`` view (whose backward
sums the ranks' gradients) and its row-parallel sum is
``reduce_scatter_seq``; where they do not divide the model axis it runs
whole on every rank, as under tensor parallelism, on the ``whole()``
view, and ``scatter_seq`` cuts its output.  ``bo`` and a cross layer's
gate, which act on the slice, take ``copy_to_model``.

With an ``fp8`` handle (``repro_torch.fp8.policy.Fp8Layer``) the q/k/v/o
projections run through FP8 GEMMs; the head split is a free reshape around
a 2-D GEMM.
"""

from __future__ import annotations

import math

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.paged_attention import (
    paged_attention,
    paged_attention_quantized,
    paged_prefill_attention,
    paged_prefill_attention_quantized,
)
from repro_torch.kernels.paged_attention_ref import paged_attention_plain, paged_prefill_attention_plain
from repro_torch.models.cache import NULL_BLOCK
from repro_torch.models.layers import ParamSpec, apply_rope, softcap
from repro_torch.parallel.collectives import all_gather, copy_to_model, reduce_scatter_seq, scatter_seq, sum_over_model
from repro_torch.parallel.sharding import kv_group, model_axis_size, model_rank

ATTN_IMPLS = ("kernel", "plain")  # paged attention
SELF_ATTN_IMPLS = ("torch", "flash")  # full-sequence self-attention

NEG_INF = -2.0e38


def attention_specs(cfg, *, cross: bool = False) -> dict:
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
    if cross:
        # llama-3.2-vision gating: the cross-attention output enters the
        # residual through a zero-initialized tanh gate
        specs["gate"] = ParamSpec((1,), (None,), "zeros")
    return specs


# ---------------------------------------------------------------------------
# projections
# ---------------------------------------------------------------------------


def _proj(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """(B, S, D) @ (D, heads, hd) -> (B, S, heads, hd) as one 2-D GEMM."""
    D, nh, hd = w.shape
    return (x @ w.to(x.dtype).reshape(D, nh * hd)).reshape(x.shape[:-1] + (nh, hd))


def _fp8_proj(fp8, site: str, x: torch.Tensor, w: torch.Tensor, whole: torch.Tensor | None = None) -> torch.Tensor:
    """The FP8 route of ``_proj``: the fp32 master weight as (D, heads*hd);
    ``whole``: the leaf ``w`` is a slice of, whose amax the site records."""
    D, nh, hd = w.shape
    return fp8.matmul(site, x, w.reshape(D, nh * hd), amax_of=whole).reshape(x.shape[:-1] + (nh, hd))


def _split(cfg, p, mesh) -> bool:
    """Whether ``p`` holds this rank's slice of the query heads (the
    ``"split"`` and ``"grouped"`` layouts)."""
    return mesh is not None and p["wq"].shape[1] != cfg.num_heads


def _group(cfg, p, mesh) -> int | None:
    """The kv head this rank attends over where ``p`` holds a slice of the
    query heads beside every kv head (the ``"grouped"`` layout), else
    None."""
    if _split(cfg, p, mesh) and p["wk"].shape[1] == cfg.num_kv_heads:
        return kv_group(cfg, mesh)
    return None


def _own_group(cfg, p, t, mesh):
    """Under the ``"grouped"`` layout, this rank's kv head of K or V ``t``
    (..., S, KV, hd) that holds every kv head; else ``t``."""
    g = _group(cfg, p, mesh)
    return t if g is None or t.shape[-2] != cfg.num_kv_heads else t.narrow(-2, g, 1)


def _kv_weights(cfg, p, mesh, whole_kv: bool) -> dict:
    """``wk`` / ``wv`` (and ``bk`` / ``bv``) as this rank projects them:
    under the ``"grouped"`` layout the rank's kv head of each whole leaf,
    taken through ``copy_to_model`` (the leaf's gradient sums every rank's
    share), unless ``whole_kv`` asks for every kv head."""
    names = ("wk", "wv") + (("bk", "bv") if cfg.use_bias else ())
    g = None if whole_kv else _group(cfg, p, mesh)
    if g is None:
        return {n: p[n] for n in names}
    return {n: copy_to_model(p[n], mesh).narrow(1 if n[0] == "w" else 0, g, 1) for n in names}


def _qkv(cfg, p, x, kv_x=None, fp8=None, mesh=None, sp=False, whole_kv=False):
    """q from x, k and v from ``kv_x`` (cross-attention's source; default
    x).  The weights are cast to x's dtype first, as in the JAX package,
    whose einsum then promotes against ``kv_x``'s dtype.  Under a training
    ``mesh`` whose ranks each hold a slice of the heads, x (but for the
    gathered sequence of ``sp``) and the q/k norm scales pass through
    ``copy_to_model`` (module docstring).  Under the ``"grouped"`` layout k
    and v hold this rank's one kv head, or with ``whole_kv`` every kv head
    (the split ring's cache)."""
    norms = {n: p[n] for n in ("q_norm", "k_norm") if cfg.qk_norm}
    if _split(cfg, p, mesh):
        if not sp:
            x = copy_to_model(x, mesh)
        norms = {n: copy_to_model(t, mesh) for n, t in norms.items()}
    kv_src = x if kv_x is None else kv_x
    kv_w = _kv_weights(cfg, p, mesh, whole_kv)
    if fp8 is not None:
        # the weight amax is the whole leaf's, as one process observes it
        q = _fp8_proj(fp8, "attn_q", x, p["wq"])
        k, v = (_fp8_proj(fp8, f"attn_{n}", kv_src, kv_w[f"w{n}"], p[f"w{n}"]) for n in ("k", "v"))
    else:
        q = _proj(x, p["wq"])
        k, v = (_proj(kv_src, kv_w[name].to(x.dtype)) for name in ("wk", "wv"))
    if cfg.use_bias:
        q = q + p["bq"].to(x.dtype)
        k = k + kv_w["bk"].to(x.dtype)
        v = v + kv_w["bv"].to(x.dtype)
    if cfg.qk_norm:
        q = _rms_head(q, norms["q_norm"], cfg.norm_eps)
        k = _rms_head(k, norms["k_norm"], cfg.norm_eps)
    return q, k, v


def _rms_head(x, scale, eps):
    xf = x.float()
    xf = xf * torch.rsqrt(torch.mean(xf * xf, dim=-1, keepdim=True) + eps)
    return (xf * scale.float()).to(x.dtype)


def _out(cfg, p, ctx, dtype, fp8=None, mesh=None, sp=False):
    """The output projection over the heads ``ctx`` holds.  Under a
    tensor-parallel ``mesh`` whose ranks each hold a slice of the heads
    (``wo`` has fewer than ``cfg.num_heads``), the product is row-parallel:
    one all-reduce (``sum_over_model``: in place when serving, under
    autograd when training) sums the ranks' partial outputs, and ``bo`` is
    added once, after the sum.  ``sp``: this rank's seq slice of the
    output, reduce-scattered where the heads split, else cut from the
    whole output by ``scatter_seq``; ``bo`` then takes ``copy_to_model``."""
    H, hd, D = p["wo"].shape
    if fp8 is not None:
        out = fp8.matmul("attn_o", ctx.reshape(ctx.shape[:-2] + (H * hd,)), p["wo"].reshape(H * hd, D)).to(dtype)
    else:
        out = ctx.to(dtype).reshape(ctx.shape[:-2] + (H * hd,)) @ p["wo"].to(dtype).reshape(H * hd, D)
    if mesh is not None and H != cfg.num_heads:
        out = reduce_scatter_seq(out, mesh) if sp else sum_over_model(out.contiguous(), mesh)
    elif sp:
        out = scatter_seq(out, mesh)
    if cfg.use_bias:
        out = out + (copy_to_model(p["bo"], mesh) if sp else p["bo"]).to(dtype)
    return out


def _rope(cfg, q, k, positions):
    if cfg.rotary_pct > 0 and not cfg.learned_pos_embedding:
        q = apply_rope(q, positions, rotary_pct=cfg.rotary_pct, theta=cfg.rope_theta)
        k = apply_rope(k, positions, rotary_pct=cfg.rotary_pct, theta=cfg.rope_theta)
    return q, k


# ---------------------------------------------------------------------------
# core attention math (grouped heads, fp32 softmax)
# ---------------------------------------------------------------------------


def _scores(q, k, scale):
    """q: (B,Sq,H,hd), k: (B,Skv,KV,hd) -> (B,KV,G,Sq,Skv) fp32, G = H / KV
    from the shapes (a rank's local heads under tensor parallelism).  The
    product is in the promoted dtype of q and k, as the reference's einsum
    (fp32 queries against a bf16 cache: fp32)."""
    B, Sq, H, hd = q.shape
    KV = k.shape[2]
    dt = torch.promote_types(q.dtype, k.dtype)
    qg = q.reshape(B, Sq, KV, H // KV, hd).to(dt)
    s = torch.einsum("bqhgk,bshk->bhgqs", qg, k.to(dt))
    return s.float() * scale


def _attend_block(cfg, q, k, v, mask):
    """Exact softmax attention for one (possibly chunked) query block.

    mask: (B?, 1, 1, Sq, Skv) additive fp32 mask (0 / NEG_INF).
    """
    scale = 1.0 / math.sqrt(cfg.head_dim)
    s = _scores(q, k, scale)
    if cfg.attn_logit_softcap > 0:
        s = softcap(s, cfg.attn_logit_softcap)
    s = s + mask
    w = torch.softmax(s, dim=-1)
    B, Sq, H = q.shape[0], q.shape[1], q.shape[2]  # H: the heads this rank holds
    ctx = torch.einsum("bhgqs,bshk->bqhgk", w.to(v.dtype), v)
    return ctx.reshape(B, Sq, H, cfg.head_dim)


def make_mask(q_pos, kv_pos, *, causal: bool, window: int) -> torch.Tensor:
    """Additive mask (..., Sq, Skv) from absolute positions."""
    rel = q_pos[..., :, None] - kv_pos[..., None, :]  # q - kv
    ok = torch.ones(rel.shape, dtype=torch.bool, device=rel.device)
    if causal:
        ok &= rel >= 0
    if window > 0:
        ok &= rel < window
    zero = torch.zeros((), dtype=torch.float32, device=rel.device)
    return torch.where(ok, zero, torch.full((), NEG_INF, dtype=torch.float32, device=rel.device))


def _scatter(pool: torch.Tensor, phys: torch.Tensor, off: torch.Tensor, rows: torch.Tensor) -> None:
    # in place, where the JAX package returns a new pool from a donated
    # ``.at[phys, off].set`` (the engine owns the only reference)
    pool.index_put_((phys.long(), off.long()), rows.to(pool.dtype))


def _write_kv(cache: dict, phys: torch.Tensor, off: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> bool:
    """Scatter K/V rows into one layer's pools at (phys, off); a quantized
    pool takes the rows' codes and their scales.  Returns whether the pools
    are quantized."""
    from repro_torch.serving.kvquant import kv_quant_mode_of, quantize

    mode = kv_quant_mode_of(cache["k"].dtype)
    for name, rows in (("k", k), ("v", v)):
        if mode is None:
            _scatter(cache[name], phys, off, rows)
        else:
            codes, scale = quantize(rows, mode)
            _scatter(cache[name], phys, off, codes)
            _scatter(cache[f"{name}_scale"], phys, off, scale)
    return mode is not None


# ---------------------------------------------------------------------------
# public entry points
# ---------------------------------------------------------------------------


def _gathered(cfg, p, x, mesh, sp):
    """The attention's input: under ``sp`` the view of the ``SeqGather``
    ``x`` that its heads' split calls for (module docstring)."""
    if not sp:
        return x
    return x.split() if _split(cfg, p, mesh) else x.whole()


def self_attention(
    cfg, p: dict, x: torch.Tensor, *, positions=None, q_chunk: int = 0, impl: str = "torch", fp8=None, mesh=None,
    sp: bool = False,
):
    """Full-sequence self-attention (training / forward).  x: (B, S, D);
    positions: (B, S), default ``arange(S)``.  Returns (B, S, D).

    ``q_chunk``: with ``impl="torch"``, attend ``q_chunk`` queries at a time
    (each chunk recomputed in the backward), bounding the scores to
    ``q_chunk x S``.  ``impl="flash"`` ignores it: K3 never holds the scores.
    ``mesh``: sharded training's (module docstring); ``sp``: sequence
    parallelism, x a ``SeqGather`` of this rank's seq slice, the output
    this rank's seq slice.
    """
    if impl not in SELF_ATTN_IMPLS:
        raise ValueError(f"impl={impl!r} (choose from {SELF_ATTN_IMPLS})")
    x = _gathered(cfg, p, x, mesh, sp)
    B, S, _ = x.shape
    if positions is None:
        positions = torch.arange(S, device=x.device).expand(B, S)
    q, k, v = _qkv(cfg, p, x, fp8=fp8, mesh=mesh, sp=sp)
    q, k = _rope(cfg, q, k, positions)

    if impl == "flash":
        ctx = flash_attention(q, k, v, causal=cfg.causal, window=cfg.sliding_window, softcap=cfg.attn_logit_softcap)
        return _out(cfg, p, ctx, x.dtype, fp8=fp8, mesh=mesh, sp=sp)

    if q_chunk and S > q_chunk and S % q_chunk == 0:

        def chunk(qc, pq):
            m = make_mask(pq, positions, causal=cfg.causal, window=cfg.sliding_window)
            return _attend_block(cfg, qc, k, v, m[:, None, None])

        ctxs = []
        for c0 in range(0, S, q_chunk):
            qc, pq = q[:, c0 : c0 + q_chunk], positions[:, c0 : c0 + q_chunk]
            # recomputed in the backward: otherwise autograd keeps every
            # chunk's (q_chunk x S) scores
            ctxs.append(checkpoint(chunk, qc, pq, use_reentrant=False) if torch.is_grad_enabled() else chunk(qc, pq))
        ctx = torch.cat(ctxs, dim=1)
    else:
        m = make_mask(positions, positions, causal=cfg.causal, window=cfg.sliding_window)
        ctx = _attend_block(cfg, q, k, v, m[:, None, None])
    return _out(cfg, p, ctx, x.dtype, fp8=fp8, mesh=mesh, sp=sp)


def cross_attention(cfg, p: dict, x: torch.Tensor, kv_tokens: torch.Tensor, *, mesh=None, sp=False) -> torch.Tensor:
    """Cross-attention of x (B, S, D) onto unpositioned vision tokens (B,
    N, D): every query sees every image token (no mask, no RoPE), the
    output scaled by ``tanh(gate)``.  In tensor ops, as the JAX package's
    ``jnp`` version.  Returns (B, S, D).  Under a training ``mesh`` whose
    ranks each hold a slice of the heads, the query input passes through
    ``copy_to_model`` (``_qkv``); the vision tokens carry no gradient.
    ``sp``: x is a ``SeqGather`` of this rank's seq slice and the output
    this rank's slice; the vision tokens are whole on every rank."""
    x = _gathered(cfg, p, x, mesh, sp)
    q, k, v = _qkv(cfg, p, x, kv_x=kv_tokens, mesh=mesh, sp=sp)
    return _gated_cross(cfg, p, x, q, k, v, mesh=mesh, sp=sp)


def _gated_cross(cfg, p, x, q, k, v, mesh=None, sp=False):
    """``tanh(gate)`` times the projected attention of q over every row of
    k / v (the JAX package's all-zero additive mask).  The gate multiplies
    after ``_out``'s sum over the model ranks, so the replicated ``gate``
    takes its whole gradient on every rank; under ``sp`` it multiplies
    this rank's slice and takes ``copy_to_model``.  K / V that hold every
    kv head (a split ring's image cache) give this rank's group's under the
    ``"grouped"`` layout."""
    zero = torch.zeros((), dtype=torch.float32, device=x.device)
    ctx = _attend_block(cfg, q, _own_group(cfg, p, k, mesh), _own_group(cfg, p, v, mesh), zero)
    gate = copy_to_model(p["gate"], mesh) if sp else p["gate"]
    return torch.tanh(gate.to(x.dtype)) * _out(cfg, p, ctx, x.dtype, mesh=mesh, sp=sp)


def prefill_attention(cfg, p: dict, x: torch.Tensor, *, positions=None, q_chunk: int = 0, mesh=None,
                      whole_kv: bool = False):
    """Self-attention that also returns the K/V tensors for the cache (the
    dense engine's blocking prefill), in tensor ops as the JAX package's
    ``prefill_attention``.  x: (B, S, D); positions: (B, S), default
    ``arange(S)``; ``q_chunk`` attends that many queries at a time when it
    divides S.  Returns (out (B, S, D), k, v (B, S, KV, hd)), K after RoPE:
    under a serving ``mesh`` the rank's kv heads, or with ``whole_kv``
    every kv head (the split ring's cache; the rank still attends over its
    own)."""
    B, S, _ = x.shape
    if positions is None:
        positions = torch.arange(S, device=x.device).expand(B, S)
    q, k, v = _qkv(cfg, p, x, mesh=mesh, whole_kv=whole_kv)
    q, k = _rope(cfg, q, k, positions)
    ka, va = _own_group(cfg, p, k, mesh), _own_group(cfg, p, v, mesh)
    if q_chunk and S > q_chunk and S % q_chunk == 0:
        ctxs = []
        for c0 in range(0, S, q_chunk):
            m = make_mask(positions[:, c0 : c0 + q_chunk], positions, causal=cfg.causal, window=cfg.sliding_window)
            ctxs.append(_attend_block(cfg, q[:, c0 : c0 + q_chunk], ka, va, m[:, None, None]))
        ctx = torch.cat(ctxs, dim=1)
    else:
        m = make_mask(positions, positions, causal=cfg.causal, window=cfg.sliding_window)
        ctx = _attend_block(cfg, q, ka, va, m[:, None, None])
    return _out(cfg, p, ctx, x.dtype, mesh=mesh), k, v


def decode_attention(cfg, p: dict, x: torch.Tensor, cache: dict, pos: torch.Tensor, *, mesh=None,
                     seq_split: bool = False) -> torch.Tensor:
    """Single-token decode against one layer's dense ring cache.

    x:     (B, 1, D) current token embedding stream
    cache: {"k","v": (B, W, KV, hd) ring buffers (W = the run's length or
           the sliding window), "pos": (B, W) absolute position held in
           each slot (-1 = empty)}
    pos:   (B,) absolute position of the current token.

    The new K/V and its position land in ring slot ``pos % W`` (in place);
    the token attends over every filled slot the causal and window masks
    admit.  Returns (B, 1, D).

    ``mesh``: the serving mesh; the cache holds the rank's kv heads.
    ``seq_split``: where the kv heads do not divide the model axis, the
    ring's slots are split over it instead, as the JAX package's cache
    rules claim ``kv_seq`` for it: this rank's cache holds every kv head's
    slots ``[r W / n, (r + 1) W / n)`` of a ring of W, every rank projects
    every kv head's new K/V and the rank that holds its slot writes it,
    and the ranks' partial softmaxes are combined (``_attend_seq_split``).
    """
    k_c, v_c, pos_c = cache["k"], cache["v"], cache["pos"]
    B, W = pos_c.shape
    q, k, v = _qkv(cfg, p, x, mesh=mesh, whole_kv=seq_split)
    q, k = _rope(cfg, q, k, pos[:, None])
    b = torch.arange(B, device=x.device)
    if seq_split:
        slot = pos.long() % (W * model_axis_size(mesh)) - model_rank(mesh) * W
        mine = (slot >= 0) & (slot < W)  # the rows whose new K/V land on this rank
        slot = slot.clamp(0, W - 1)
        for c, new in ((k_c, k[:, 0]), (v_c, v[:, 0])):
            c[b, slot] = torch.where(mine[:, None, None], new.to(c.dtype), c[b, slot])
        pos_c[b, slot] = torch.where(mine, pos.to(pos_c.dtype), pos_c[b, slot])
    else:
        slot = pos.long() % W
        k_c[b, slot] = k[:, 0].to(k_c.dtype)
        v_c[b, slot] = v[:, 0].to(v_c.dtype)
        pos_c[b, slot] = pos.to(pos_c.dtype)
    m = make_mask(pos[:, None], pos_c, causal=cfg.causal, window=cfg.sliding_window)  # (B, 1, W)
    m = torch.where(pos_c[:, None, :] < 0, torch.full_like(m, NEG_INF), m)  # empty slots
    if seq_split:
        ctx = _attend_seq_split(cfg, q, k_c, v_c, m[:, None, None], mesh)
    else:
        ctx = _attend_block(cfg, q, k_c, v_c, m[:, None, None])
    return _out(cfg, p, ctx, x.dtype, mesh=mesh)


def _attend_seq_split(cfg, q, k, v, mask, mesh):
    """``_attend_block`` over a ring whose slots are split over the model
    axis (``decode_attention(seq_split=True)``): each rank's softmax over
    its own slots, as (output unnormalized, sum, max) against its local
    max; one all-gather of the three; every rank then rescales each rank's
    part to the largest max and sums them in rank order.  A rank whose
    slots are all masked has a max near ``NEG_INF`` and weighs zero.
    Where ``q`` holds a slice of the query heads (the ``"grouped"``
    layout), one all-gather first hands every rank every head's query,
    and the rank keeps its own heads' rows of the result."""
    local = q.shape[2]
    if local != cfg.num_heads:
        q = all_gather(q, mesh, dim=2)
    scale = 1.0 / math.sqrt(cfg.head_dim)
    s = _scores(q, k, scale)  # (B, KV, G, 1, W)
    if cfg.attn_logit_softcap > 0:
        s = softcap(s, cfg.attn_logit_softcap)
    s = s + mask
    mx = s.amax(dim=-1, keepdim=True)
    e = torch.exp(s - mx)
    part = torch.einsum("bhgqs,bshk->bhgqk", e.to(v.dtype), v).float()
    parts = all_gather(torch.cat([part, e.sum(dim=-1, keepdim=True), mx], dim=-1)[None], mesh, dim=0)
    part, total, mx = parts[..., :-2], parts[..., -2:-1], parts[..., -1:]
    w = torch.exp(mx - mx.amax(dim=0, keepdim=True))  # (n, B, KV, G, 1, 1)
    ctx = (w * part).sum(dim=0) / (w * total).sum(dim=0)  # (B, KV, G, 1, hd)
    B, Sq, H = q.shape[0], q.shape[1], q.shape[2]
    ctx = ctx.permute(0, 3, 1, 2, 4).reshape(B, Sq, H, cfg.head_dim)
    return ctx if local == H else ctx.narrow(2, model_rank(mesh) * local, local)


def paged_chunk_attention(
    cfg, p: dict, x: torch.Tensor, cache: dict, tbl_row: torch.Tensor, start: torch.Tensor, *, impl: str = "kernel",
    widths: torch.Tensor | None = None, mesh=None,
):
    """Chunked-prefill attention against one layer's paged cache.

    x:       (B, C, D) chunk token embedding stream
    cache:   {"k","v": (N, bs, KV, hd) pools of this layer, ["k_scale",
             "v_scale": (N, bs, KV, 1) fp32 of quantized pools], ...}
    tbl_row: (B, nb) int32, the request's block table covering every
             logical block of prompt + generation
    start:   (B,) int32 absolute position of the chunk's first token
    widths:  (B,) int32 valid lanes per row (fused mixed batches), or None:
             lanes at or past ``widths[b]`` scatter to the null block and
             their outputs are garbage the caller discards.

    The chunk's K/V is scattered into its blocks first (position t lands in
    block ``tbl_row[b, t // bs]`` at offset ``t % bs``), then every chunk
    query attends causally over the logical view [0, start + offset].  The
    pools are updated in place.  Returns the attention output (B, C, D).
    """
    k_pool, v_pool = cache["k"], cache["v"]
    B, C, _ = x.shape
    bs = k_pool.shape[1]
    positions = start[:, None].to(torch.int64) + torch.arange(C, device=x.device)[None, :]  # (B, C)
    q, k, v = _qkv(cfg, p, x, mesh=mesh)
    q, k = _rope(cfg, q, k, positions)

    idx = torch.clamp(positions // bs, max=tbl_row.shape[1] - 1)
    phys = torch.gather(tbl_row.long(), 1, idx)  # (B, C)
    if widths is not None:
        lane = torch.arange(C, device=x.device)[None, :]
        phys = torch.where(lane < widths[:, None], phys, NULL_BLOCK)
    off = positions % bs
    kw = dict(softcap=cfg.attn_logit_softcap, window=cfg.sliding_window)
    if _write_kv(cache, phys, off, k, v):
        ctx = paged_prefill_attention_quantized(
            q, k_pool, v_pool, cache["k_scale"], cache["v_scale"], tbl_row, start, **kw
        )
    else:
        attend = paged_prefill_attention if impl == "kernel" else paged_prefill_attention_plain
        ctx = attend(q.contiguous(), k_pool, v_pool, tbl_row, start, **kw)
    return _out(cfg, p, ctx, x.dtype, mesh=mesh)


def paged_decode_attention(
    cfg, p: dict, x: torch.Tensor, cache: dict, pos: torch.Tensor, *, impl: str = "kernel", mesh=None
):
    """Single-token decode against one layer's paged cache.

    x:     (B, 1, D) current token embedding stream
    cache: {"k","v": (N, bs, KV, hd) pools of this layer, "tbl": (B, nb) block
           table, ["k_scale","v_scale": (N, bs, KV, 1) fp32 of quantized pools]}
    pos:   (B,) int32 absolute position of the current token.

    The new K/V lands in block ``tbl[b, pos // bs]`` at offset ``pos % bs``
    (in place).  Inactive batch slots carry all-null tables, so their writes
    hit the reserved null block, never a live request's memory.  Attention
    runs over the logical view [0, pos].  Returns (B, 1, D).
    """
    k_pool, v_pool, tbl = cache["k"], cache["v"], cache["tbl"]
    B = x.shape[0]
    bs = k_pool.shape[1]
    q, k, v = _qkv(cfg, p, x, mesh=mesh)
    q, k = _rope(cfg, q, k, pos[:, None])

    pos64 = pos.long()
    phys = tbl.long()[torch.arange(B, device=x.device), pos64 // bs]
    off = pos64 % bs
    seq_lens = (pos + 1).to(torch.int32)
    kw = dict(softcap=cfg.attn_logit_softcap, window=cfg.sliding_window)
    if _write_kv(cache, phys, off, k[:, 0], v[:, 0]):
        ctx = paged_attention_quantized(q[:, 0], k_pool, v_pool, cache["k_scale"], cache["v_scale"], tbl, seq_lens, **kw)
    else:
        attend = paged_attention if impl == "kernel" else paged_attention_plain
        ctx = attend(q[:, 0].contiguous(), k_pool, v_pool, tbl, seq_lens, **kw)
    return _out(cfg, p, ctx[:, None], x.dtype, mesh=mesh)
