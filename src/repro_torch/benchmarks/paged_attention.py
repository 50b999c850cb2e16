"""Paged-attention decode microbenchmark (paper §IV.F) on one card.

The counterpart of the repository's ``benchmarks/paged_attention.py``: at
the reference's decode batch / context points, the plain gather read
(``kernels.paged_attention_ref.paged_attention_plain``, the reference's
oracle) and K1 (``kernels.paged_attention.paged_attention``), each timed,
K1 held against the plain read to ``TOL`` (fp32 pools and queries, as the
reference's) with a control (every sequence one key short) that must exceed
it, plus the bytes a decode step touches: each sequence's K and V once, the
quantity the paged layout exists to bound, since decode attention is bound
by memory.  The derived column gives those bytes' least time at the H100
SXM's 3.35 TB/s, in place of the reference's v5e model.  Times are CUDA
events over ``iters`` calls on the card, the host's wall clock on the CPU
(where K1's wrapper takes the plain read).  Run on a machine with a card::

    PYTHONPATH=src python -m repro_torch.benchmarks.paged_attention [--device cpu]

``--autotune`` sweeps K1's and K2's layouts over ``CASES`` on the card and
writes the winners to the autotuner's user cache (``--out`` another path;
``repro_torch.kernels.autotune``); ``--check`` verifies that the merged
table is valid and deterministic, with no sweep.
"""

from __future__ import annotations

import argparse

import torch

from repro_torch.benchmarks.timing import device_name, time_per_call
from repro_torch.device import resolve_device
from repro_torch.kernels.paged_attention import paged_attention
from repro_torch.kernels.paged_attention_ref import paged_attention_plain

HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory
# (B, nb, block_size, H, KV, hd): the reference's points
CASES = [
    (4, 4, 16, 8, 2, 64),
    (8, 8, 16, 8, 2, 64),
    (4, 4, 32, 16, 4, 128),
]
TOL = 1e-4  # fp32: sums in another order


def inputs(B, nb, bs, H, KV, hd, device, seed: int = 0):
    """fp32 queries and pools, each sequence's ``nb`` blocks in a table of
    its own (block 0 is the null block), every sequence full."""
    g = torch.Generator(device=device).manual_seed(seed)
    N = 1 + B * nb
    q = torch.randn((B, H, hd), generator=g, device=device)
    kp, vp = (torch.randn((N, bs, KV, hd), generator=g, device=device) for _ in range(2))
    tbl = torch.arange(1, N, dtype=torch.int32, device=device).reshape(B, nb)
    lens = torch.full((B,), nb * bs, dtype=torch.int32, device=device)
    return q, kp, vp, tbl, lens


def run(cases=CASES, iters: int = 20, device="cuda", seed: int = 0) -> list[dict]:
    device = resolve_device(device)
    on_card = device.type == "cuda"
    rows = []
    for B, nb, bs, H, KV, hd in cases:
        q, kp, vp, tbl, lens = inputs(B, nb, bs, H, KV, hd, device, seed)
        ref = paged_attention_plain(q, kp, vp, tbl, lens)
        err = float((paged_attention(q, kp, vp, tbl, lens) - ref).abs().max())
        control = float((paged_attention_plain(q, kp, vp, tbl, lens - 1) - ref).abs().max())
        if not err <= TOL < control:
            raise AssertionError(f"paged attention {B, nb, bs, H, KV, hd}: K1 {err:.3g}, control {control:.3g}, "
                                 f"limit {TOL}")
        kv_bytes = 2 * B * nb * bs * KV * hd * kp.element_size()  # K and V of every sequence, once
        bound_us = kv_bytes / HBM_BYTES_PER_S * 1e6
        name = f"paged_attn_b{B}_ctx{nb * bs}_kv{KV}x{hd}"
        for kind, fn in (("plain", lambda: paged_attention_plain(q, kp, vp, tbl, lens)),
                         ("kernel", lambda: paged_attention(q, kp, vp, tbl, lens))):
            dt = time_per_call(fn, iters, device)
            row = {"name": f"{name}_{kind}", "us_per_call": dt * 1e6, "kv_bytes": kv_bytes, "bound_us": bound_us,
                   "achieved_gbps": kv_bytes / dt / 1e9 if on_card else None, "device": device_name(device),
                   "derived": f"bound_h100_us={bound_us:.3f} kv_bytes={kv_bytes}"}
            if kind == "kernel":
                row.update(max_abs_err=err, tol=TOL, control_err=control)
                row["derived"] += f" maxerr_vs_plain={err:.1e} (control {control:.1e})"
            rows.append(row)
    return rows


def main(argv=None) -> list[dict]:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument(
        "--autotune", action="store_true",
        help="sweep K1/K2 layouts over the benchmark CASES on the card and write the winners to the "
        "user autotune cache (see repro_torch.kernels.autotune)",
    )
    ap.add_argument("--check", action="store_true", help="verify the autotune table's determinism, no sweep")
    ap.add_argument("--iters", type=int, default=20, help="timed calls per point (per candidate with --autotune)")
    ap.add_argument("--dtype", default="bfloat16", help="pool dtype for the sweep")
    ap.add_argument("--out", default=None, help="autotune cache path override")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    if args.check or args.autotune:
        from repro_torch.kernels import autotune

        if args.check:
            autotune.check_determinism()
        else:
            autotune.autotune(CASES, dtype=args.dtype, iters=args.iters, out_path=args.out, device=args.device)
        return []
    rows = run(iters=args.iters, device=args.device)
    for r in rows:
        print(f"{r['name']},{r['us_per_call']:.1f},{r['derived']}", flush=True)
    return rows


if __name__ == "__main__":
    main()
