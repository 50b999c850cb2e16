"""Selective-SSM heads of the Hymba hybrid blocks.

The JAX package's ``models/ssm.py`` in PyTorch ops: Hymba (arXiv:2411.13676)
pairs attention heads with Mamba heads, and each SSM *head* gets a scalar
dt (the Mamba-2/SSD form, arXiv:2405.21060; A keeps its (H, N) diagonal),
so every term of the chunked scan is a product of small tensors:

    decay:  la_t[h,j] = A[h,j] * cumsum(dt)[t,h]                 (<= 0)
    intra:  score[t,s,h] = sum_j C_t[j] B_s[j] exp(la_t - la_s)  (s <= t)
            y2[t,h,p]    = sum_s score[t,s,h] * dt_s[h] * x_s[h,p]
    inter:  y1[t,h,p]    = sum_j C_t[j] exp(la_t[h,j]) h0[h,p,j]
    state:  h1[h,p,j]    = exp(la_L) h0 + sum_s exp(la_L - la_s) dt_s B_s[j] x_s[h,p]

Every exponent is a difference of a monotone cumulative sum, so it is <= 0;
``A = -exp(a_log)`` and every decay stay in fp32, as in the JAX package.
The JAX package computes all of this in ``jnp``, outside any Pallas
kernel, and so does the port.

The chunk choice is the JAX package's: a prompt whose length is not a
multiple of ``ssm.chunk_size`` is one chunk, whose pairwise decay tensor
``(B, S, S, H, N)`` fp32 grows with the square of the prompt (1.9 GB a
layer at hymba-1.5b's width and S = 1100).  It lives for one layer's scan.

``ssm_mix`` runs a whole sequence from a given or a zero state and returns
the states a decode loop continues from; ``ssm_step`` is one token.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models.layers import ParamSpec


def d_inner(cfg) -> int:
    return cfg.ssm.expand * cfg.d_model


def head_dim_inner(cfg) -> int:
    di = d_inner(cfg)
    assert di % cfg.num_heads == 0, f"ssm: d_inner({di}) % heads({cfg.num_heads}) != 0"
    return di // cfg.num_heads


def ssm_specs(cfg) -> dict:
    D = cfg.d_model
    s = cfg.ssm
    di, N, H = d_inner(cfg), s.state_size, cfg.num_heads
    return {
        "in_proj": ParamSpec((D, 2 * di), ("embed", "ssm_inner")),
        "conv_w": ParamSpec((s.conv_width, di), (None, "ssm_inner")),
        "conv_b": ParamSpec((di,), ("ssm_inner",), "zeros"),
        # per-token SSM params: dt per head, B and C per state index
        "x_proj": ParamSpec((di, 2 * N), ("ssm_inner", None)),
        "dt_proj": ParamSpec((di, H), ("ssm_inner", "heads"), "normal"),
        "dt_bias": ParamSpec((H,), ("heads",), "ssm_dt"),
        "a_log": ParamSpec((H, N), ("heads", None), "ssm_a"),
        "d_skip": ParamSpec((di,), ("ssm_inner",), "ones"),
        "out_proj": ParamSpec((di, D), ("ssm_inner", "embed")),
    }


def _softplus(x: torch.Tensor) -> torch.Tensor:
    """log(1 + e^x) with no threshold, as ``jax.nn.softplus``."""
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype, device=x.device))


def _conv1d(x, w, b, conv_state=None):
    """Depthwise causal conv.  x: (B, S, di), w: (K, di), conv_state: the
    last K - 1 inputs before x, (B, K-1, di), zeros when None.  Returns (y,
    new_state): the new state is the last K - 1 inputs, in x's dtype."""
    K = w.shape[0]
    B, S, di = x.shape
    if conv_state is None:
        conv_state = torch.zeros((B, K - 1, di), dtype=x.dtype, device=x.device)
    xp = torch.cat([conv_state.to(x.dtype), x], dim=1)  # (B, S+K-1, di)
    y = sum(xp[:, i : i + S] * w[i].to(x.dtype) for i in range(K))
    y = y + b.to(x.dtype)
    new_state = xp[:, -(K - 1) :] if K > 1 else torch.zeros((B, 0, di), dtype=x.dtype, device=x.device)
    return y, new_state


def _selective_params(cfg, p, xc):
    """xc: (B, S, di) after the conv -> dt (B, S, H), B and C (B, S, N), fp32."""
    N = cfg.ssm.state_size
    proj = xc @ p["x_proj"].to(xc.dtype)  # (B, S, 2N)
    Bm, Cm = proj[..., :N], proj[..., N:]
    dt = _softplus(xc @ p["dt_proj"].to(xc.dtype) + p["dt_bias"].to(xc.dtype))
    return dt.float(), Bm.float(), Cm.float()


def _ssd_chunked(A, dt, Bm, Cm, xh, state, chunk: int):
    """Chunked scan.  A: (H, N); dt: (B, S, H); Bm, Cm: (B, S, N); xh:
    (B, S, H, P) fp32; state: (B, H, P, N) fp32.  Returns (y (B, S, H, P),
    state).  A loop over chunks that carries the state; when ``S`` is not a
    multiple of ``chunk`` the whole sequence is one chunk, as in the JAX
    package."""
    B, S, H, P = xh.shape
    if S % chunk != 0:
        chunk = S
    ys = []
    tri = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool, device=xh.device))
    for c0 in range(0, S, chunk):
        dtc, Bb, Cb, xb = (t[:, c0 : c0 + chunk] for t in (dt, Bm, Cm, xh))
        sdt = torch.cumsum(dtc, dim=1)  # (B, L, H) inclusive
        la = sdt[..., None] * A[None, None]  # (B, L, H, N) <= 0
        # inter-chunk: y1 = C_t . exp(la_t) h0
        y1 = torch.einsum("blj,blhj,bhpj->blhp", Cb, torch.exp(la), state)
        # intra-chunk pairwise decays (t, s): la_t - la_s <= 0 for s <= t;
        # the upper triangle is -inf before the exp
        dd = la[:, :, None] - la[:, None, :]  # (B, t, s, H, N)
        dd.masked_fill_(~tri[None, :, :, None, None], float("-inf")).exp_()
        # C_t B_s first: the product with dd then makes no tensor of dd's size
        score = torch.einsum("btsj,btshj->btsh", Cb[:, :, None] * Bb[:, None], dd)
        del dd
        xin = dtc[..., None] * xb  # (B, L, H, P) dt-scaled inputs
        y2 = torch.einsum("btsh,bshp->bthp", score, xin)
        # state update
        la_last = la[:, -1:]  # (B, 1, H, N)
        dec_in = torch.exp(la_last - la)  # (B, L, H, N), safe
        state = torch.exp(la_last[:, 0])[:, :, None, :] * state + torch.einsum("blhj,blj,blhp->bhpj", dec_in, Bb, xin)
        ys.append(y1 + y2)
    return torch.cat(ys, dim=1), state


def ssm_mix(cfg, p, x, *, conv_state=None, ssm_state=None):
    """Full-sequence selective SSM.  x: (B, S, D); the states default to
    zeros.  Returns (out (B, S, D), (new_conv_state (B, K-1, di) in x's
    dtype, new_ssm_state (B, H, P, N) fp32))."""
    s = cfg.ssm
    B, S, D = x.shape
    di, H, P = d_inner(cfg), cfg.num_heads, head_dim_inner(cfg)
    xz = x @ p["in_proj"].to(x.dtype)  # (B, S, 2di)
    xi, z = xz[..., :di], xz[..., di:]
    xc, new_conv = _conv1d(xi, p["conv_w"], p["conv_b"], conv_state)
    xc = F.silu(xc)
    dt, Bm, Cm = _selective_params(cfg, p, xc)
    A = -torch.exp(p["a_log"].float())  # (H, N), negative
    if ssm_state is None:
        ssm_state = torch.zeros((B, H, P, s.state_size), dtype=torch.float32, device=x.device)
    xh = xc.float().reshape(B, S, H, P)
    y, new_state = _ssd_chunked(A, dt, Bm, Cm, xh, ssm_state, s.chunk_size)
    y = y.reshape(B, S, di).to(x.dtype) + xc * p["d_skip"].to(x.dtype)
    y = y * F.silu(z)
    out = y @ p["out_proj"].to(x.dtype)
    return out, (new_conv, new_state)


def ssm_step(cfg, p, x, conv_state, ssm_state):
    """One-token decode.  x: (B, 1, D); conv_state: (B, K-1, di); ssm_state:
    (B, H, P, N) fp32.  Returns (out (B, 1, D), (new_conv_state,
    new_ssm_state))."""
    B = x.shape[0]
    di, H, P = d_inner(cfg), cfg.num_heads, head_dim_inner(cfg)
    xz = x @ p["in_proj"].to(x.dtype)
    xi, z = xz[..., :di], xz[..., di:]
    xc, new_conv = _conv1d(xi, p["conv_w"], p["conv_b"], conv_state)
    xc = F.silu(xc)
    dt, Bm, Cm = _selective_params(cfg, p, xc)  # (B, 1, H), (B, 1, N)
    A = -torch.exp(p["a_log"].float())
    dec = torch.exp(dt[:, 0, :, None] * A[None])  # (B, H, N)
    xh = xc.float().reshape(B, H, P)
    u = torch.einsum("bh,bj,bhp->bhpj", dt[:, 0], Bm[:, 0], xh)
    new_state = dec[:, :, None, :] * ssm_state + u
    y = torch.einsum("bhpj,bj->bhp", new_state, Cm[:, 0]).reshape(B, 1, di)
    y = y.to(x.dtype) + xc * p["d_skip"].to(x.dtype)
    y = y * F.silu(z)
    out = y @ p["out_proj"].to(x.dtype)
    return out, (new_conv, new_state)
