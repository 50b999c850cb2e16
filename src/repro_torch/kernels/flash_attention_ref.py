"""Plain PyTorch version of the flash-attention forward (K3).

Mirrors the JAX package's ``kernels/flash_attention_ref.attention_ref`` in
the ``(B, H, S, hd)`` layout: fp32 scores over the whole sequence, tanh
softcap, causal / window mask with -1e38, fp32 softmax, fp32 P·V, output in
q's dtype.  The CPU tests hold it against the JAX oracle and the Pallas
kernel (interpret mode); on the card ``kernels.flash_attention`` holds the
CUDA kernel against it.  It materialises the (Sq, Skv) scores: it is a
yardstick, not a fast path.
"""

from __future__ import annotations

import math

import torch


def flash_attention_plain(
    q: torch.Tensor,  # (B, H, Sq, hd)
    k: torch.Tensor,  # (B, KV, Skv, hd)
    v: torch.Tensor,
    *,
    causal: bool = True,
    window: int = 0,
    softcap: float = 0.0,
) -> torch.Tensor:
    B, H, Sq, hd = q.shape
    KV, Skv = k.shape[1], k.shape[2]
    qpk = H // KV
    qf = q.float().reshape(B, KV, qpk, Sq, hd)
    kf = k.float()
    vf = v.float()
    s = torch.einsum("bhgqd,bhkd->bhgqk", qf, kf) / math.sqrt(hd)
    if softcap > 0:
        s = softcap * torch.tanh(s / softcap)
    q_pos = torch.arange(Sq, device=q.device)[:, None]
    kv_pos = torch.arange(Skv, device=q.device)[None, :]
    ok = torch.ones((Sq, Skv), dtype=torch.bool, device=q.device)
    if causal:
        ok &= q_pos >= kv_pos
    if window > 0:
        ok &= (q_pos - kv_pos) < window
    s = torch.where(ok, s, torch.full((), -1e38, dtype=s.dtype, device=s.device))
    w = torch.softmax(s, dim=-1)
    o = torch.einsum("bhgqk,bhkd->bhgqd", w, vf)
    return o.reshape(B, H, Sq, hd).to(q.dtype)
