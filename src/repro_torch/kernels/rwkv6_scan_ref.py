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
  chunks of (BH, S, n) inputs from a zero state, returning the outputs;
* ``wkv6_chunked_split`` — K5's arithmetic on the card, emulated: each
  chunk's state term for every chunk at once, the walk over the chunks,
  then the outputs of every chunk at once; the pairwise decay factored per
  16-step sub-chunk off the diagonal; every product on TF32 terms of
  its fp32 operands, as the tensor cores take them.  Nothing on the model
  path calls it.

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


def _tf32_terms(x: torch.Tensor, terms: int) -> list[torch.Tensor]:
    """``terms`` TF32 values (as fp32) whose sum carries x, as the kernel
    feeds the tensor cores: hi rounded to TF32 (to nearest, ties away, as
    ``cvt.rna.tf32.f32``), then what hi leaves, rounded so too."""

    def rna(y):
        return ((y.float().contiguous().view(torch.int32) + 0x1000) & -0x2000).view(torch.float32)

    assert terms in (1, 2), terms
    hi = rna(x)
    return [hi, rna(x.float() - hi)][:terms]


def split_matmul(a: torch.Tensor, b: torch.Tensor, terms: int) -> torch.Tensor:
    """a @ b as the tensor cores take it: each operand as ``terms`` TF32
    terms, the products of term pairs i + j < terms summed in fp32 (two
    terms: hi hi + hi lo + lo hi, "3xTF32"; one: both operands in TF32)."""
    at, bt = _tf32_terms(a, terms), _tf32_terms(b, terms)
    return sum(at[i] @ bt[j] for i in range(terms) for j in range(terms - i))


SUB, INNER = 16, 4  # steps of a sub-chunk, and of a group within one, in K5 on the card


def wkv6_chunked_split(r, k, v, logw, u, *, chunk: int = 64, terms: int = 2) -> torch.Tensor:
    """K5 as the card computes it.  r, k, v, logw: (BH, S, n); u: (BH, n);
    a zero initial state.  Returns (BH, S, n) fp32.

    1. Every chunk's state term U = (k * exp(la_L - la))^T v and decay
       exp(la_L), at once.
    2. The walk: S_c = diag(exp(la_L)) S_{c-1} + U_c from S_0 = 0, keeping
       the state that enters each chunk.
    3. Every chunk's outputs at once from the state that enters it:
       (r * exp(la_prev)) S_{c-1}, plus the scores times v, plus the bonus.
       Scores between sub-chunk i (steps from i*SUB on) and an earlier
       sub-chunk j take the decay as two factors about b, the last step
       before sub-chunk i: exp(la_prev_t - la_b) exp(la_b - la_s), both
       exponents <= 0, so the block is the product
       (r * exp(la_prev - la_b)) (k * exp(la_b - la))^T.  Within a
       sub-chunk, pairs s < t in different groups of INNER steps are
       factored alike about the last step of s's group; pairs in one group
       keep their own exp(la_prev_t - la_s) per channel, and s = t takes
       the bonus (r . (u * k)).
    The products (U, the inter-chunk term, the off-diagonal score blocks
    and the scores times v) take ``terms`` TF32 terms of each operand
    (``split_matmul``); everything else is fp32.  SUB must divide the
    chunk."""
    BH, S, n = r.shape
    L = chunk
    sub, inner = SUB, INNER
    assert S % L == 0 and L % sub == 0, (S, L)
    C = S // L
    rf, kf, vf, lw = (x.float().reshape(BH, C, L, n) for x in (r, k, v, logw))
    uf = u.float()[:, None, None, :]
    la = torch.cumsum(lw, dim=2)
    la_prev = la - lw  # as the JAX package's kernel takes it
    la_last = la[:, :, -1:]  # (BH, C, 1, n)
    # 1. each chunk's state term, all chunks at once
    U = split_matmul((kf * torch.exp(la_last - la)).transpose(-1, -2), vf, terms)  # (BH, C, n, n)
    decay = torch.exp(la_last).transpose(-1, -2)  # (BH, C, n, 1)
    # 2. the walk
    state = torch.zeros((BH, n, n), dtype=torch.float32, device=r.device)
    entering = []
    for c in range(C):
        entering.append(state)
        state = decay[:, c] * state + U[:, c]
    S0 = torch.stack(entering, dim=1)  # (BH, C, n, n)
    # 3. the outputs
    out = split_matmul(rf * torch.exp(la_prev), S0, terms)
    scores = torch.zeros((BH, C, L, L), dtype=torch.float32, device=r.device)
    for i in range(L // sub):
        t0 = i * sub
        rows = slice(t0, t0 + sub)
        if i > 0:  # the blocks against every earlier sub-chunk: one product
            lb = la[:, :, t0 - 1 : t0]  # la of step t0 - 1
            a = rf[:, :, rows] * torch.exp(la_prev[:, :, rows] - lb)
            b = kf[:, :, :t0] * torch.exp(lb - la[:, :, :t0])
            scores[:, :, rows, :t0] = split_matmul(a, b.transpose(-1, -2), terms)
        # within the sub-chunk: pairs in different groups of INNER steps
        # factored about the last step m of s's group, exp(la_prev_t - la_m)
        # exp(la_m - la_s), pairs in one group with their own exponential
        tt = torch.arange(sub, device=r.device)
        grp = tt // inner
        same = grp[:, None] == grp[None, :]
        strict = tt[:, None] > tt[None, :]
        m = t0 + grp * inner + inner - 1  # the anchor of each column s
        la_m = la[:, :, m]  # (BH, C, sub, n), by column s
        a = rf[:, :, rows, None, :] * torch.exp(la_prev[:, :, rows, None, :] - la_m[:, :, None, :, :])
        b = kf[:, :, None, rows, :] * torch.exp(la_m[:, :, None, :, :] - la[:, :, None, rows, :])
        factored = (a * b).sum(-1)
        dd = (la_prev[:, :, rows, None, :] - la[:, :, None, rows, :]).masked_fill(~(strict & same)[:, :, None], -torch.inf)
        own = (rf[:, :, rows, None, :] * kf[:, :, None, rows, :] * torch.exp(dd)).sum(-1)
        diag = torch.where(strict & ~same, factored, own)
        bonus = (rf[:, :, rows] * uf * kf[:, :, rows]).sum(-1)
        scores[:, :, rows, rows] = diag + torch.diag_embed(bonus)
    out = out + split_matmul(scores, vf, terms)
    return out.reshape(BH, S, n)
