"""Learning-rate schedules (warmup + cosine / linear / constant), computed
in fp32 as the JAX package's ``optim/schedule.py`` does.

With warmup the rate at step 0 is 0, so parameters first move at the
second step."""

from __future__ import annotations

import math

import torch


def make_schedule(kind: str = "cosine", *, base_lr: float, warmup_steps: int, total_steps: int, min_ratio: float = 0.1):
    """step (int or tensor) -> learning rate, a () fp32 tensor on the step's
    device (the CPU for an int)."""
    if kind not in ("constant", "linear", "cosine"):
        raise ValueError(f"unknown schedule {kind!r}")

    def schedule(step):
        step = torch.as_tensor(step).to(torch.float32)
        warm = torch.clamp(step / max(warmup_steps, 1), max=1.0)
        if kind == "constant":
            decay = 1.0
        else:
            frac = torch.clamp((step - warmup_steps) / max(total_steps - warmup_steps, 1), 0.0, 1.0)
            if kind == "linear":
                decay = 1.0 - (1.0 - min_ratio) * frac
            else:
                decay = min_ratio + (1.0 - min_ratio) * 0.5 * (1.0 + torch.cos(math.pi * frac))
        return base_lr * warm * decay

    return schedule
