"""Per-call timing shared by the figure scripts."""

from __future__ import annotations

import time

import torch

CLOCK_HZ = 1.98e9  # H100 SXM boost clock: a device sleep of n cycles lasts at least n / CLOCK_HZ s


def time_per_call(fn, iters: int, device: torch.device, queued: bool = False) -> float:
    """Seconds per call of ``fn`` after one warm-up call: CUDA events around
    ``iters`` calls on the card, the host's wall clock on the CPU.  With
    ``queued`` the calls on the card wait behind a device sleep longer than
    their host time, so the events time the device's work back to back and
    not the host's rate of issue (a kernel faster than its wrapper)."""
    fn()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        if queued:
            t0 = time.perf_counter()
            fn()
            host_s = time.perf_counter() - t0
            torch.cuda.synchronize(device)
            torch.cuda._sleep(int(CLOCK_HZ * min(1.5 * iters * host_s + 1e-3, 0.5)))
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
