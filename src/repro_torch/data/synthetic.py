"""Deterministic synthetic batches, the recipe of the JAX package's
``data/synthetic.py`` on a ``torch.Generator``.

A batch is a pure function of (seed, step): replaying a step gives the same
tokens.  Tokens are Zipf-like over the vocabulary (logits ``-1.2 log rank``)
and, with probability 0.3, the previous base token times 31 modulo V, so a
model can learn something; ``labels`` are the tokens shifted left by one.
The audio family's batches hold standard normal ``frames`` instead, and
their ``labels`` follow the frames by the JAX package's rule,
``argmax(frames[..., :V]) % V``.  The bits differ from ``jax.random``'s:
parity tests hand one numpy batch to both packages.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.device import resolve_device


def _generator(seed: int, step: int) -> torch.Generator:
    """A CPU generator for (seed, step).  Its Mersenne Twister keeps 32 bits
    of a seed, so the pair is hashed into 32 bits first."""
    if seed < 0 or step < 0:
        raise ValueError(f"seed {seed} and step {step} must be non-negative")
    return torch.Generator().manual_seed(int(np.random.SeedSequence([seed, step]).generate_state(1)[0]))


def synthetic_batch(cfg, *, step: int, global_batch: int, seq_len: int, seed: int = 0, device="cuda") -> dict:
    """One training batch of int32 ``tokens`` and ``labels`` (B, S), made on
    the CPU from (seed, step) and moved to ``device``; for the vlm family
    also ``vision_tokens`` (B, num_image_tokens, d_model) fp32, standard
    normal, the stand-in for the stubbed vision tower's patch embeddings.
    The audio family's batch holds ``frames`` (B, S, d_model) fp32, standard
    normal, in place of ``tokens`` (``audio_labels`` gives its labels)."""
    device = resolve_device(device)
    g = _generator(seed, step)
    V = cfg.vocab_size
    if cfg.family == "audio":
        frames = torch.randn((global_batch, seq_len, cfg.d_model), generator=g)
        return {"frames": frames.to(device), "labels": audio_labels(frames, V).to(device)}
    ranks = torch.arange(V, dtype=torch.float64) + 1.0
    probs = torch.exp(-1.2 * torch.log(ranks))
    B, S = global_batch, seq_len
    base = torch.multinomial(probs, B * S, replacement=True, generator=g).reshape(B, S)
    shift = torch.roll(base, 1, dims=1) * 31 % V
    mix = torch.rand((B, S), generator=g) < 0.3
    tokens = torch.where(mix, shift, base).to(torch.int32)
    labels = torch.roll(tokens, -1, dims=1)
    batch = {"tokens": tokens.to(device), "labels": labels.to(device)}
    if cfg.family == "vlm":
        batch["vision_tokens"] = torch.randn((B, cfg.vision.num_image_tokens, cfg.d_model), generator=g).to(device)
    return batch


def audio_labels(frames: torch.Tensor, vocab_size: int) -> torch.Tensor:
    """The pseudo cluster targets of frames (B, S, D): int32 ``argmax(frames[...,
    :V], -1) % V``, the JAX package's rule (learnable from the frames)."""
    return (torch.argmax(frames[..., :vocab_size], dim=-1) % vocab_size).to(torch.int32)


def make_batch_fn(cfg, *, global_batch: int, seq_len: int, seed: int = 0, device="cuda"):
    """step -> batch closure (deterministic)."""
    device = resolve_device(device)

    def batch_fn(step: int) -> dict:
        return synthetic_batch(cfg, step=step, global_batch=global_batch, seq_len=seq_len, seed=seed, device=device)

    return batch_fn
