"""BabelStream (paper Fig. 10) on the card: memory bandwidth of the K6 kernels.

The counterpart of the repository's ``benchmarks/babelstream.py``.  The
paper runs BabelStream on the GH200 across nine programming models and
reports fractions of peak HBM bandwidth; this runs the five hand-written
CUDA kernels of ``repro_torch.kernels.babelstream`` (copy, mul, add, triad,
dot) on arrays of ``n`` elements and reports, per kernel, the time per call
(CUDA events over ``iters`` calls after a warm-up), the bytes BabelStream
counts for it and the achieved rate against the H100 SXM's 3.35 TB/s.
Run on a machine with a card::

    PYTHONPATH=src python -m repro_torch.benchmarks.babelstream [--n 134217728] [--dtype bfloat16]

With ``device="cpu"`` the wrappers take their plain versions; the time is
then the host's wall clock and no rate is reported, since it is not the
card's.
"""

from __future__ import annotations

import argparse
import json

import torch

from repro_torch.benchmarks.timing import device_name, time_per_call
from repro_torch.device import resolve_device
from repro_torch.kernels.babelstream import (
    stream_add,
    stream_bytes,
    stream_copy,
    stream_dot,
    stream_mul,
    stream_triad,
)

N = 2**27  # elements: 512 MiB per fp32 array, ten times the 50 MB L2 cache
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def run(n: int = N, dtype=torch.float32, iters: int = 20, device="cuda", seed: int = 0) -> list[dict]:
    """One row per kernel: ``name``, ``us_per_call``, ``bytes``,
    ``achieved_gbps`` and ``hbm_fraction`` (None off the card), ``dtype``,
    ``n`` and ``device``."""
    device = resolve_device(device)
    g = torch.Generator(device=device).manual_seed(seed)
    a, b, c = (torch.randn((n,), generator=g, device=device).to(dtype) for _ in range(3))
    kernels = {
        "copy": lambda: stream_copy(a),
        "mul": lambda: stream_mul(c),
        "add": lambda: stream_add(a, b),
        "triad": lambda: stream_triad(b, c),
        "dot": lambda: stream_dot(a, b),
    }
    on_card = device.type == "cuda"
    item = a.element_size()
    rows = []
    for name, fn in kernels.items():
        dt = time_per_call(fn, iters, device)
        nbytes = stream_bytes(name, n, item)
        rows.append({
            "name": f"babelstream_{name}",
            "us_per_call": dt * 1e6,
            "bytes": nbytes,
            "achieved_gbps": nbytes / dt / 1e9 if on_card else None,
            "hbm_fraction": nbytes / dt / HBM_BYTES_PER_S if on_card else None,
            "dtype": str(dtype).replace("torch.", ""),
            "n": n,
            "device": device_name(device),
        })
    return rows


def main(argv=None) -> list[dict]:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=N)
    ap.add_argument("--dtype", choices=sorted(DTYPES), default="float32")
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    rows = run(args.n, DTYPES[args.dtype], args.iters, args.device)
    for r in rows:
        print(json.dumps(r), flush=True)
    return rows


if __name__ == "__main__":
    main()
