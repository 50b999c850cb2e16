"""Token sampling: greedy, temperature and top-k, per slot, batched.

Counterpart of the JAX package's ``serving/sampler.py`` (``sample_token``,
``sample_tokens``).  Greedy takes the argmax (first index on ties, as
``jnp.argmax``); sampled rows draw with ``torch.multinomial`` from an
explicit ``torch.Generator``, so their bits differ from ``jax.random``.
"""

from __future__ import annotations

import torch


def sample_tokens(
    logits: torch.Tensor,  # (B, V)
    temperature: torch.Tensor,  # (B,) fp32; <= 0 means greedy
    top_k: torch.Tensor,  # (B,) int; <= 0 means full softmax
    generator: torch.Generator | None = None,
) -> torch.Tensor:
    """Whole-batch sampler, per-slot temperature / top-k carried as data.
    The top-k threshold is the k-th largest scaled logit (ties at the
    threshold survive).  Returns (B,) int64.

    Greedy rows still flow through the sampled branch before ``where``
    discards it, so they are scaled by a benign temperature of 1.0 rather
    than a 1e-6 clamp, which would overflow large logits to inf."""
    B, V = logits.shape
    logits = logits.float()
    greedy_rows = temperature <= 0.0
    greedy = torch.argmax(logits, dim=-1)
    safe_t = torch.where(greedy_rows, torch.ones_like(temperature), torch.clamp(temperature, min=1e-6))
    scaled = logits / safe_t[:, None]
    kth = torch.clamp(top_k.long(), 1, V) - 1
    thresh = torch.sort(scaled, dim=-1, descending=True).values.gather(1, kth[:, None])
    masked = torch.where((top_k > 0)[:, None] & (scaled < thresh), torch.full_like(scaled, float("-inf")), scaled)
    sampled = torch.multinomial(torch.softmax(masked, dim=-1), 1, generator=generator)[:, 0]
    return torch.where(greedy_rows, greedy, sampled)


def sample_token(logits: torch.Tensor, temperature: float, generator: torch.Generator | None = None, *, top_k: int = 0) -> int:
    """logits: (V,) -> one token."""
    if temperature <= 0.0:
        return int(torch.argmax(logits))
    t = torch.tensor([temperature], dtype=torch.float32, device=logits.device)
    k = torch.tensor([top_k], dtype=torch.int64, device=logits.device)
    return int(sample_tokens(logits[None], t, k, generator)[0])
