"""FP8 GEMM sweep (paper §1: Isambard-AI's 8-bit FLOP/s headline) on one card.

The counterpart of the repository's ``benchmarks/fp8_gemm.py``.  The
machine quotes its AI capability in 8-bit FLOP/s, twice the bf16 peak, so
the benchmark that matters is the GEMM at both precisions.  Per square size
n, three rows, as in the reference:

* ``bf16``  — ``torch.matmul`` on bf16 operands (the path before FP8);
* ``plain`` — the FP8 path's plain version: per-tensor e4m3 scales,
  quantize, then ``fp8.gemm_ref.fp8_gemm_plain`` (upcast, fp32 product,
  dequantize);
* ``kernel`` — K4 (``fp8.gemm.fp8_gemm``) on the same fp8 operands, held
  against the plain version to ``RTOL`` of its output's largest magnitude,
  with a control (the plain GEMM without its last 32 k-elements) that must
  exceed it; the layout copy of b that the wrapper makes (b is (K, N), K4
  reads it K-major) is in its time, as on the training path.

Times are CUDA events over ``iters`` calls on the card, the host's wall
clock on the CPU (where K4's wrapper takes the plain version).  The derived
column gives each row's least time, 2 n^3 operations at the H100 SXM's 989
TFLOP/s (bf16) or 1,979 TFLOP/s (fp8), in place of the reference's v5e
model, and on the card the rate achieved.  Run on a machine with a card::

    PYTHONPATH=src python -m repro_torch.benchmarks.fp8_gemm [--sizes 256 512 4096] [--device cpu]
"""

from __future__ import annotations

import argparse

import torch

from repro_torch.benchmarks.timing import device_name, time_per_call
from repro_torch.device import resolve_device
from repro_torch.fp8 import E4M3, compute_scale, fp8_gemm, fp8_gemm_plain, quantize, tensor_amax

BF16_FLOPS_PER_S = 989e12  # H100 SXM dense bf16 tensor cores
FP8_FLOPS_PER_S = 1979e12  # H100 SXM dense fp8 tensor cores
SIZES = (256, 512, 4096)  # the reference's two, and one the tensor cores fill
RTOL = 1e-5  # of the plain output's largest magnitude: fp32 sums in another order
CONTROL_K = 32  # the control drops the last 32 k-elements


def operands(n: int, device, seed: int = 0):
    """bf16 copies and e4m3 quantizations (with their scales) of two
    standard normal (n, n) matrices."""
    g = torch.Generator(device=device).manual_seed(seed)
    a, b = (torch.randn((n, n), generator=g, device=device) for _ in range(2))
    sa, sb = compute_scale(tensor_amax(a), E4M3), compute_scale(tensor_amax(b), E4M3)
    return a.bfloat16(), b.bfloat16(), quantize(a, sa, E4M3), quantize(b, sb, E4M3), sa, sb


def check(qa, qb, sa, sb) -> dict:
    """K4 against the plain GEMM on the same operands, and the control."""
    ref = fp8_gemm_plain(qa, qb, sa, sb)
    tol = RTOL * float(ref.abs().max())
    err = float((fp8_gemm(qa, qb, sa, sb) - ref).abs().max())
    control = float((fp8_gemm_plain(qa[:, :-CONTROL_K], qb[:-CONTROL_K], sa, sb) - ref).abs().max())
    return {"max_abs_err": err, "tol": tol, "control_err": control, "passes": err <= tol < control}


def run(sizes=SIZES, iters: int = 10, device="cuda", seed: int = 0) -> list[dict]:
    device = resolve_device(device)
    on_card = device.type == "cuda"
    rows = []
    for n in sizes:
        a16, b16, qa, qb, sa, sb = operands(n, device, seed)
        flops = 2.0 * n**3
        c = check(qa, qb, sa, sb)
        if not c["passes"]:
            raise AssertionError(f"fp8_gemm {n}: K4 against the plain GEMM {c}")
        for kind, fn, peak in (
            ("bf16", lambda: a16 @ b16, BF16_FLOPS_PER_S),
            ("plain", lambda: fp8_gemm_plain(qa, qb, sa, sb), FP8_FLOPS_PER_S),
            ("kernel", lambda: fp8_gemm(qa, qb, sa, sb), FP8_FLOPS_PER_S),
        ):
            dt = time_per_call(fn, iters, device)
            bound_us = flops / peak * 1e6
            row = {"name": f"fp8_gemm_{kind}_{n}", "us_per_call": dt * 1e6, "flops": flops, "bound_us": bound_us,
                   "tflop_s": flops / dt / 1e12 if on_card else None, "device": device_name(device)}
            derived = f"bound_h100_us={bound_us:.3f}"
            if kind == "kernel":
                row.update(c)
                derived += f" maxerr_vs_plain={c['max_abs_err']:.2e} (tol {c['tol']:.2e}, control {c['control_err']:.2e})"
            if on_card:
                derived += f" {row['tflop_s']:.1f} TFLOP/s"
            row["derived"] = derived
            rows.append(row)
    return rows


def main(argv=None) -> list[dict]:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--sizes", type=int, nargs="+", default=list(SIZES))
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    rows = run(args.sizes, args.iters, args.device)
    for r in rows:
        print(f"{r['name']},{r['us_per_call']:.1f},{r['derived']}", flush=True)
    return rows


if __name__ == "__main__":
    main()
