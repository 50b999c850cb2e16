"""RWKV6 "Finch" — attention-free time-mix with data-dependent decay.

arXiv:2404.05892; the JAX package's ``models/rwkv.py``.  The per-head
recurrence (head size n):

    S_t   = diag(w_t) . S_{t-1} + k_t v_t^T          (state: n x n)
    out_t = r_t . (S_{t-1} + diag(u) k_t v_t^T)

with w_t = exp(-exp(ww_t)) a *data-dependent* per-channel decay, and r, k,
v, g, ww produced from token-shifted inputs through low-rank adapters.

Whole sequences go through the chunked-parallel formulation
(``_wkv_chunked``, the JAX model's own path: a loop over chunks that
carries the state), or through the WKV kernel K5 (``wkv_impl="kernel"``,
``kernels.rwkv6_scan.wkv6``), which starts from a zero state, returns no
final state and has no gradient, as in the JAX package.  A callable with
``wkv6``'s signature takes K5's place where a check substitutes another
scan.  Single tokens go through ``time_mix_step``.

Sharded training and tensor-parallel serving (``channel_mix(mesh=)``):
the channel mix splits its hidden dim over the mesh's ``"model"`` axis as
an FFN does (``w_k`` column-parallel, its input ``xk`` through
``copy_to_model``; ``w_v`` row-parallel, then one ``sum_over_model``),
while ``w_r`` stays whole and gates the summed product.  The time mix runs whole on every model rank
(``parallel.sharding.WHOLE_OVER_MODEL``): each rank computes all of its
leaves' gradients, which no collective may sum again.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.kernels.rwkv6_scan import wkv6
from repro_torch.kernels.rwkv6_scan_ref import wkv_chunk
from repro_torch.models.layers import ParamSpec, group_norm_heads
from repro_torch.parallel.collectives import (
    copy_leaves_to_model,
    copy_to_model,
    reduce_scatter_seq,
    seq_slice,
    sum_over_model,
)

WKV_IMPLS = ("chunked", "kernel")


def check_wkv_impl(wkv_impl) -> None:
    """``wkv_impl`` is one of ``WKV_IMPLS`` or a callable with ``wkv6``'s
    signature (a zero-state scan that returns the outputs only)."""
    if not (callable(wkv_impl) or wkv_impl in WKV_IMPLS):
        raise ValueError(f"wkv_impl={wkv_impl!r} (choose from {WKV_IMPLS} or pass a scan)")


# ---------------------------------------------------------------------------
# parameter specs
# ---------------------------------------------------------------------------


def time_mix_specs(cfg) -> dict:
    D = cfg.d_model
    r = cfg.rwkv
    H, n = cfg.num_heads, r.head_size
    assert H * n == D, f"rwkv: heads({H}) * head_size({n}) != d_model({D})"
    return {
        "maa_x": ParamSpec((D,), ("embed",), "zeros"),
        "maa_w": ParamSpec((D,), ("embed",), "zeros"),
        "maa_k": ParamSpec((D,), ("embed",), "zeros"),
        "maa_v": ParamSpec((D,), ("embed",), "zeros"),
        "maa_r": ParamSpec((D,), ("embed",), "zeros"),
        "maa_g": ParamSpec((D,), ("embed",), "zeros"),
        "maa_w1": ParamSpec((D, 5 * r.lora_rank_mix), ("embed", None), "normal", 0.1),
        "maa_w2": ParamSpec((5, r.lora_rank_mix, D), (None, None, "embed"), "normal", 0.1),
        "decay": ParamSpec((D,), ("embed",), "rwkv_decay"),
        "decay_w1": ParamSpec((D, r.lora_rank_decay), ("embed", None), "normal", 0.1),
        "decay_w2": ParamSpec((r.lora_rank_decay, D), (None, "embed"), "normal", 0.1),
        "bonus": ParamSpec((H, n), ("heads", None), "normal"),  # "u" / time_faaaa
        "w_r": ParamSpec((D, D), ("embed", "heads_x_dim")),
        "w_k": ParamSpec((D, D), ("embed", "heads_x_dim")),
        "w_v": ParamSpec((D, D), ("embed", "heads_x_dim")),
        "w_g": ParamSpec((D, D), ("embed", "heads_x_dim")),
        "w_o": ParamSpec((D, D), ("heads_x_dim", "embed")),
        "ln_x_scale": ParamSpec((D,), ("embed",), "ones"),
        "ln_x_bias": ParamSpec((D,), ("embed",), "zeros"),
    }


def channel_mix_specs(cfg) -> dict:
    D, F_ = cfg.d_model, cfg.d_ff
    return {
        "maa_k": ParamSpec((D,), ("embed",), "zeros"),
        "maa_r": ParamSpec((D,), ("embed",), "zeros"),
        "w_k": ParamSpec((D, F_), ("embed", "mlp")),
        "w_v": ParamSpec((F_, D), ("mlp", "embed")),
        "w_r": ParamSpec((D, D), ("embed", "heads_x_dim")),
    }


# ---------------------------------------------------------------------------
# token shift
# ---------------------------------------------------------------------------


def token_shift(x: torch.Tensor, prev: torch.Tensor | None) -> torch.Tensor:
    """x_{t-1} stream; ``prev`` is the last token of the previous segment."""
    B = x.shape[0]
    if prev is None:
        prev = torch.zeros((B, 1, x.shape[-1]), dtype=x.dtype, device=x.device)
    else:
        prev = prev.reshape(B, 1, x.shape[-1]).to(x.dtype)
    return torch.cat([prev, x[:, :-1]], dim=1)


# ---------------------------------------------------------------------------
# time mix
# ---------------------------------------------------------------------------


def _projections(cfg, p, x, x_prev):
    """Token-shifted, LoRA-mixed projections -> r, k, v, g, logw (all (B, S, ...))."""
    dt = x.dtype
    sx = x_prev - x
    xxx = x + sx * p["maa_x"].to(dt)
    B, S, D = x.shape
    r_mix = cfg.rwkv.lora_rank_mix
    a = torch.tanh(xxx @ p["maa_w1"].to(dt)).reshape(B, S, 5, r_mix)
    mixes = torch.einsum("bsfr,frd->bsfd", a, p["maa_w2"].to(dt))  # (B, S, 5, D)
    mw, mk, mv, mr, mg = (mixes[:, :, i] for i in range(5))
    xw = x + sx * (p["maa_w"].to(dt) + mw)
    xk = x + sx * (p["maa_k"].to(dt) + mk)
    xv = x + sx * (p["maa_v"].to(dt) + mv)
    xr = x + sx * (p["maa_r"].to(dt) + mr)
    xg = x + sx * (p["maa_g"].to(dt) + mg)

    r = xr @ p["w_r"].to(dt)
    k = xk @ p["w_k"].to(dt)
    v = xv @ p["w_v"].to(dt)
    g = F.silu(xg @ p["w_g"].to(dt))
    # data-dependent decay, fp32: logw = -exp(ww) <= 0
    ww = p["decay"].float() + torch.tanh(xw @ p["decay_w1"].to(dt)).float() @ p["decay_w2"].float()
    logw = -torch.exp(ww)  # (B, S, D)
    return r, k, v, g, logw


def _wkv_chunked(r, k, v, logw, u, state, chunk: int):
    """Chunked-parallel WKV.  r, k, v: (B, S, H, n) fp32; logw: (B, S, H, n)
    fp32 (<= 0); u: (H, n); state: (B, H, n, n) fp32.  Returns (out
    (B, S, H, n), new_state).  Under autograd each chunk is recomputed in
    the backward (``torch.utils.checkpoint``), as the JAX package's
    ``jax.checkpoint(body)``: the (B, H, L, L, n) pairwise decay tensor is
    not kept for every chunk."""
    B, S, H, n = r.shape
    if S % chunk != 0:
        chunk = S  # fall back to a single chunk
    nc = S // chunk

    def reshape_c(x):
        return x.reshape(B, nc, chunk, H, n).permute(1, 0, 3, 2, 4)  # (nc, B, H, L, n)

    rc, kc, vc, lwc = map(reshape_c, (r, k, v, logw))
    uh = u[None, :, None, :]  # (1, H, 1, n)
    remat = torch.is_grad_enabled() and any(t.requires_grad for t in (r, k, v, logw, u, state))
    outs = []
    for c in range(nc):
        args = (state, rc[c], kc[c], vc[c], lwc[c], uh)
        out, state = checkpoint(wkv_chunk, *args, use_reentrant=False) if remat else wkv_chunk(*args)
        outs.append(out)
    out = torch.stack(outs).permute(1, 0, 3, 2, 4).reshape(B, S, H, n)
    return out, state


def time_mix(cfg, p, x, *, prev_x=None, state=None, wkv_impl="chunked"):
    """Full-sequence RWKV6 time mixing.

    Returns (out, (last_x, new_state)) so prefill can hand the recurrent
    state to the decode loop.  ``wkv_impl="kernel"`` runs K5, which starts
    from a zero state and computes no final state: it refuses a ``state``
    and returns None in its place, and has no gradient.  A callable
    ``wkv_impl`` is called as K5 would be, under the same terms.
    """
    check_wkv_impl(wkv_impl)
    B, S, D = x.shape
    H, n = cfg.num_heads, cfg.rwkv.head_size
    x_prev = token_shift(x, prev_x)
    r, k, v, g, logw = _projections(cfg, p, x, x_prev)
    rh = r.reshape(B, S, H, n).float()
    kh = k.reshape(B, S, H, n).float()
    vh = v.reshape(B, S, H, n).float()
    lw = logw.reshape(B, S, H, n)
    u = p["bonus"].float()
    if wkv_impl == "chunked":
        if state is None:
            state = torch.zeros((B, H, n, n), dtype=torch.float32, device=x.device)
        out, new_state = _wkv_chunked(rh, kh, vh, lw, u, state, cfg.rwkv.chunk_size)
    else:
        if state is not None:
            raise ValueError(f"wkv_impl={wkv_impl!r} starts from a zero state; pass state=None or use 'chunked'")
        scan = wkv6 if wkv_impl == "kernel" else wkv_impl
        out, new_state = scan(rh, kh, vh, lw, u, chunk=cfg.rwkv.chunk_size), None
    out = out.reshape(B, S, D).to(x.dtype)
    out = group_norm_heads(out, p["ln_x_scale"], p["ln_x_bias"], H, 64e-5)
    out = out * g
    out = out @ p["w_o"].to(x.dtype)
    return out, (x[:, -1], new_state)


def time_mix_step(cfg, p, x, prev_x, state):
    """Single-token decode step.  x: (B, 1, D); state: (B, H, n, n) fp32."""
    B, _, D = x.shape
    H, n = cfg.num_heads, cfg.rwkv.head_size
    x_prev = prev_x.reshape(B, 1, D).to(x.dtype)
    r, k, v, g, logw = _projections(cfg, p, x, x_prev)
    rh = r.reshape(B, H, n).float()
    kh = k.reshape(B, H, n).float()
    vh = v.reshape(B, H, n).float()
    w = torch.exp(logw.reshape(B, H, n))
    u = p["bonus"].float()
    a = kh[..., :, None] * vh[..., None, :]  # (B, H, n, n) outer product
    out = torch.einsum("bhc,bhcv->bhv", rh, state + u[None, :, :, None] * a)
    new_state = w[..., None] * state + a
    out = out.reshape(B, 1, D).to(x.dtype)
    out = group_norm_heads(out, p["ln_x_scale"], p["ln_x_bias"], H, 64e-5)
    out = out * g
    out = out @ p["w_o"].to(x.dtype)
    return out, (x[:, -1], new_state)


# ---------------------------------------------------------------------------
# channel mix
# ---------------------------------------------------------------------------


def channel_mix(cfg, p, x, *, prev_x=None, mesh=None, sp=False):
    """Returns (out, the last token).  Under a ``mesh`` (training's or
    tensor-parallel serving's) whose ranks each hold a slice of the hidden
    dim (``w_v`` has fewer than ``cfg.d_ff`` rows), ``xk`` passes through
    ``copy_to_model`` after the token-shift mix, so ``maa_k``'s gradient is
    the ranks' sum too, and ``kv`` is summed once (in place where autograd
    does not record); ``xr``, ``w_r`` and ``maa_r`` take whole gradients on
    every rank.

    ``sp`` (sequence parallelism): x is the block's ``SeqGather``, whose
    ``split()`` view the mix reads, so the token shift crosses the slices'
    edges, and the output this rank's seq slice: ``kv`` reduce-scattered
    (or, where the hidden dim does not split, cut from the whole ``kv``,
    ``w_k`` and ``w_v`` then through ``copy_to_model``), ``xr`` cut to the
    slice; ``maa_k``, ``maa_r`` and ``w_r`` take ``copy_to_model``, since
    each rank's gradient of them is its share."""
    if sp:
        x = x.split()
    dt = x.dtype
    split = mesh is not None and p["w_v"].shape[0] != cfg.d_ff
    if sp:
        p = copy_leaves_to_model(p, mesh, ("maa_k", "maa_r", "w_r") + (() if split else ("w_k", "w_v")))
    x_prev = token_shift(x, prev_x)
    sx = x_prev - x
    xk = x + sx * p["maa_k"].to(dt)
    xr = x + sx * p["maa_r"].to(dt)
    if split and not sp:
        xk = copy_to_model(xk, mesh)
    k = torch.square(F.relu(xk @ p["w_k"].to(dt)))
    kv = k @ p["w_v"].to(dt)
    if split:
        kv = reduce_scatter_seq(kv, mesh) if sp else sum_over_model(kv, mesh)
    elif sp:
        kv = seq_slice(kv, mesh)
    if sp:
        xr = seq_slice(xr, mesh)
    return torch.sigmoid(xr @ p["w_r"].to(dt)) * kv, x[:, -1]
