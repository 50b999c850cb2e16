"""Plain PyTorch version of the flash-attention forward (K3).

Mirrors the JAX package's ``kernels/flash_attention_ref.attention_ref`` in
the ``(B, H, S, hd)`` layout: fp32 scores over the whole sequence, tanh
softcap, causal / window mask with -1e38, fp32 softmax, fp32 P·V, output in
q's dtype.  The CPU tests hold it against the JAX oracle and the Pallas
kernel (interpret mode); on the card ``kernels.flash_attention`` holds the
CUDA kernel against it.  It materialises the (Sq, Skv) scores: it is a
yardstick, not a fast path.

Beside it, what the checks of K3 use: ``flash_attention_split_p``, the same
function with P carried as bf16 terms (two terms are the tensor-core
kernel's numerics, one term is the control "P rounded to bf16"), and
``flash_errors``, the metric the limits are stated in.
"""

from __future__ import annotations

import math

import torch


def _weights(q, k, *, causal, window, softcap) -> torch.Tensor:
    """fp32 softmax weights, (B, KV, H / KV, Sq, Skv)."""
    B, H, Sq, hd = q.shape
    KV, Skv = k.shape[1], k.shape[2]
    qf = q.float().reshape(B, KV, H // KV, Sq, hd)
    s = torch.einsum("bhgqd,bhkd->bhgqk", qf, k.float()) / math.sqrt(hd)
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
    return torch.softmax(s, dim=-1)


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
    w = _weights(q, k, causal=causal, window=window, softcap=softcap)
    o = torch.einsum("bhgqk,bhkd->bhgqd", w, v.float())
    return o.reshape(B, H, Sq, hd).to(q.dtype)


def flash_attention_split_p(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    terms: int,
    causal: bool = True,
    window: int = 0,
    softcap: float = 0.0,
) -> torch.Tensor:
    """The plain version with P carried as ``terms`` bf16 terms, each the
    bf16 rounding of what the earlier ones left, and each term's P·V summed
    in fp32.  ``terms=2`` (P_hi + P_lo) is the tensor-core kernel's route;
    ``terms=1`` rounds P to bf16 before P·V."""
    B, H, Sq, hd = q.shape
    rest = _weights(q, k, causal=causal, window=window, softcap=softcap)
    vf = v.float()
    o = 0
    for _ in range(terms):
        part = rest.bfloat16().float()
        o = o + torch.einsum("bhgqk,bhkd->bhgqd", part, vf)
        rest = rest - part
    return o.reshape(B, H, Sq, hd).to(q.dtype)


def flash_errors(out: torch.Tensor, ref: torch.Tensor) -> dict:
    """max |out - ref| in spacings of out's dtype at the row's largest
    |ref|, mean |out - ref| over mean |ref|, and (reported only) the mean
    bias: mean (out - ref) sign(ref) over mean |ref|, below 0 where out
    shrinks toward zero."""
    diff = out.float() - ref.float()
    d = diff.abs()
    mean_ref = ref.float().abs().mean()
    rowmax = ref.float().abs().amax(-1, keepdim=True)
    _, e = torch.frexp(rowmax.clamp_min(1e-30))
    mant = {torch.bfloat16: 7, torch.float32: 23}[out.dtype]
    return {"max_spacings": float((d / torch.exp2((e - 1 - mant).float())).max()),
            "mean_rel": float(d.mean() / mean_ref), "max_abs": float(d.max()),
            "mean_bias": float((diff * ref.float().sign()).mean() / mean_ref)}
