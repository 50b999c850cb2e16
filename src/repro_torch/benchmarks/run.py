"""Benchmark harness of the port: every paper figure's ``run()``, CSV output.

The counterpart of the repository's ``benchmarks/run.py``:

    Fig. 8  -> mlperf_train     (BERT-Large training)
    Fig. 9  -> llm_inference    (paged vs dense continuous-batching decode)
    Fig. 10 -> babelstream      (memory bandwidth, the K6 kernels)
    Fig. 11 -> cloverleaf       (the stencil step, its weak-scaling bytes)
    §1      -> fp8_gemm         (bf16 vs the FP8 path, K4)
    §IV.F   -> paged_attention  (K1 against the gather read)

It prints ``name,us_per_call,derived`` rows, figure by figure, and exits
non-zero if any figure fails (after running the others), as the
reference's does.  On the card (the default) every time is the card's and
every ``derived`` column names its H100 bound; with ``--device cpu`` the
times are the host's wall clock and BabelStream runs on 2^16 elements::

    python -m repro_torch.benchmarks.run [--device cpu]
"""

from __future__ import annotations

import argparse
import sys
import traceback

from repro_torch.benchmarks import babelstream, cloverleaf, fp8_gemm, llm_inference, mlperf_train, paged_attention
from repro_torch.device import resolve_device

FIGURES = {
    "mlperf_train": mlperf_train.run,
    "llm_inference": llm_inference.run,
    "babelstream": babelstream.run,
    "cloverleaf": cloverleaf.run,
    "fp8_gemm": fp8_gemm.run,
    "paged_attention": paged_attention.run,
}
CPU_STREAM_N = 2**16  # BabelStream's elements on the host


def run_figures(figures: dict, device) -> int:
    """Print each figure's rows; returns the number of figures that failed."""
    print("name,us_per_call,derived", flush=True)
    failures = 0
    for name, fn in figures.items():
        try:
            kw = {"n": CPU_STREAM_N} if name == "babelstream" and device.type == "cpu" else {}
            for r in fn(device=device, **kw):
                derived = r.get("derived") or f"bytes={r.get('bytes')} achieved_gbps={r.get('achieved_gbps')}"
                print(f"{r['name']},{r['us_per_call']:.1f},{derived}", flush=True)
        except Exception:  # a figure that fails is reported; the others still run
            failures += 1
            print(f"[run] figure {name} failed", file=sys.stderr, flush=True)
            traceback.print_exc()
    return failures


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    return 1 if run_figures(FIGURES, resolve_device(args.device)) else 0


if __name__ == "__main__":
    sys.exit(main())
