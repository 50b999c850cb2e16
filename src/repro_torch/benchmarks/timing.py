"""Per-call timing shared by the figure scripts."""

from __future__ import annotations

import time

import torch


def time_per_call(fn, iters: int, device: torch.device) -> float:
    """Seconds per call of ``fn`` after one warm-up call: CUDA events around
    ``iters`` calls on the card, the host's wall clock on the CPU."""
    fn()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / 1e3 / iters
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    return (time.perf_counter() - t0) / iters


def device_name(device: torch.device) -> str:
    """The card's name, or ``"cpu"``: every row says where it was measured."""
    return torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
