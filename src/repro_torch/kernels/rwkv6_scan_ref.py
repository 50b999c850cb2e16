"""Plain PyTorch versions of the RWKV6 WKV scan (K5).

The recurrence (arXiv:2404.05892), per (batch, head) with head size n and
an (n, n) fp32 state S:

    out_t = r_t . (S_{t-1} + diag(u) k_t v_t^T)
    S_t   = diag(w_t) S_{t-1} + k_t v_t^T,       w_t = exp(logw_t) <= 1

* ``wkv6_ref`` — the sequential oracle of the JAX package's
  ``kernels/rwkv6_scan_ref.py``, one step at a time;
* ``wkv_chunk`` — one chunk of the chunked-parallel formulation, the body
  shared by the JAX package's Pallas ``_wkv_kernel`` and its model's
  ``_wkv_chunked``: cumulative log-decays, the inter-chunk term through the
  carried state, the strictly-lower pairwise scores (every exponent <= 0),
  the diagonal bonus and the state update;
* ``wkv6_chunked_plain`` — the plain version of K5: ``wkv_chunk`` over the
  chunks of (BH, S, n) inputs from a zero state, returning the outputs.

The CPU tests hold them against the JAX package; on the card
``kernels.rwkv6_scan`` holds the CUDA kernel against them.
"""

from __future__ import annotations

import torch


def wkv6_ref(r, k, v, logw, u) -> torch.Tensor:
    """Sequential scan.  r, k, v, logw: (BH, S, n); u: (BH, n) -> (BH, S, n) fp32."""
    BH, S, n = r.shape
    rf, kf, vf = (x.float() for x in (r, k, v))
    w = torch.exp(logw.float())
    uf = u.float()
    state = torch.zeros((BH, n, n), dtype=torch.float32, device=r.device)
    outs = []
    for t in range(S):
        a = kf[:, t, :, None] * vf[:, t, None, :]  # (BH, n, n) outer product
        outs.append(torch.einsum("bc,bcv->bv", rf[:, t], state + uf[:, :, None] * a))
        state = w[:, t, :, None] * state + a
    return torch.stack(outs, dim=1)


def wkv_chunk(S0, r, k, v, lw, u):
    """One chunk.  r, k, v, lw: (..., L, n) fp32, lw <= 0; u broadcastable
    to (..., 1, n); S0: (..., n, n).  Returns (out (..., L, n), S1)."""
    L = r.shape[-2]
    la = torch.cumsum(lw, dim=-2)  # inclusive log-decay products
    la_prev = la - lw  # exclusive: la_{t-1}
    # inter-chunk: r~_t = r_t * exp(la_{t-1}) (la_prev <= 0)
    out = (r * torch.exp(la_prev)) @ S0
    # intra-chunk: scores_ts = sum_c r_t[c] k_s[c] exp(la_{t-1}[c] - la_s[c]) for s < t;
    # pairs with s >= t get -inf before the exp, whose argument is then never positive
    strict = torch.ones((L, L), dtype=torch.bool, device=r.device).tril(-1)
    dd = (la_prev[..., :, None, :] - la[..., None, :, :]).masked_fill(~strict[:, :, None], -torch.inf)
    scores = (r[..., :, None, :] * k[..., None, :, :] * torch.exp(dd)).sum(-1)  # (..., t, s)
    out = out + scores @ v
    # diagonal bonus: (r_t . (u * k_t)) v_t
    out = out + (r * u * k).sum(-1, keepdim=True) * v
    # state update: S' = diag(exp(la_L)) S0 + sum_s exp(la_L - la_s) k_s v_s^T
    la_last = la[..., -1:, :]
    k_dec = k * torch.exp(la_last - la)  # la_last <= la_s
    S1 = torch.exp(la_last).transpose(-1, -2) * S0 + k_dec.transpose(-1, -2) @ v
    return out, S1


def wkv6_chunked_plain(r, k, v, logw, u, *, chunk: int = 64) -> torch.Tensor:
    """The plain version of K5.  r, k, v, logw: (BH, S, n); u: (BH, n);
    a zero initial state.  Returns (BH, S, n) fp32."""
    BH, S, n = r.shape
    assert S % chunk == 0, (S, chunk)
    state = torch.zeros((BH, n, n), dtype=torch.float32, device=r.device)
    uf = u.float()[:, None, :]
    outs = []
    for c0 in range(0, S, chunk):
        part = [x[:, c0 : c0 + chunk].float() for x in (r, k, v, logw)]
        out, state = wkv_chunk(state, *part, uf)
        outs.append(out)
    return torch.cat(outs, dim=1)
