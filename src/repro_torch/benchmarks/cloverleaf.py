"""CloverLeaf weak scaling (paper Fig. 11) on one card.

The counterpart of the repository's ``benchmarks/cloverleaf.py``.  The
paper weak-scales the CloverLeaf hydrodynamics mini-app (a structured-grid
stencil, bound by memory bandwidth, with MPI halo exchange) to 160 GH200s.
The reference computes a 5-point Jacobi update of a 2-D fp32 grid whose
rows are sharded over a mesh axis, with a halo exchange (``ppermute``) per
step, in array ops outside any Pallas kernel; so does the port, in tensor
ops on one device:

* the halo: on one device the reference's ``ppermute`` pairs are (0 -> 0),
  so the row above the first is the grid's last row and the row below the
  last is its first: **the rows wrap around**.  The columns are padded by
  replicating the edge (``jnp.pad(mode="edge")``);
* the update: ``0.2 * (c + n + s + w + e)`` over the padded grid, summed
  in the reference's order.

The halo exchange over cards comes with the next slice of the port's
multi-card work (tensor-parallel serving is ported; its collectives are in
``parallel.collectives``).  ``run`` times ``step`` (CUDA events over ``iters`` chained steps on
the card, the host's wall clock on the CPU) at the reference's sizes and
checks each size's first step against the same step in float64.  Each row
carries the bytes the reference counts (each cell read once and written
once, fp32), their least time at the H100 SXM's 3.35 TB/s (``bound_us``,
in place of the reference's v5e model) and, on the card, the rate
achieved.  The weak-scaling rows derive the halo-to-compute byte ratio at
1024^2 cells a chip, with the same rate.  Run on a machine with a card::

    PYTHONPATH=src python -m repro_torch.benchmarks.cloverleaf [--sizes 256 512 1024 16384] [--device cpu]
"""

from __future__ import annotations

import argparse

import torch

from repro_torch.benchmarks.timing import device_name, time_per_call
from repro_torch.device import resolve_device

HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory
SIZES = (256, 512, 1024)  # the reference's
CHECK_RTOL = 2e-6  # of the grid's largest magnitude: a few fp32 roundings of the 5-term sum


def stencil(u: torch.Tensor) -> torch.Tensor:
    """5-point Jacobi update of the interior of a padded grid (CloverLeaf's
    diffusion-like kernel shape)."""
    c = u[1:-1, 1:-1]
    n = u[:-2, 1:-1]
    s = u[2:, 1:-1]
    w = u[1:-1, :-2]
    e = u[1:-1, 2:]
    return 0.2 * (c + n + s + w + e)


def halo(u: torch.Tensor) -> torch.Tensor:
    """The (H + 2, W + 2) grid the stencil reads: the rows wrapped around
    (one device's ``ppermute`` halo), the columns edge-replicated."""
    rows = torch.cat([u[-1:], u, u[:1]], dim=0)
    return torch.cat([rows[:, :1], rows, rows[:, -1:]], dim=1)


def step(u: torch.Tensor) -> torch.Tensor:
    """One step of the reference's ``make_step`` on a one-device mesh."""
    return stencil(halo(u))


def step_bytes(n: int, itemsize: int = 4) -> int:
    """The bytes the reference counts for one step: each cell read once
    and written once."""
    return 2 * n * n * itemsize


def check_step(u: torch.Tensor, out: torch.Tensor) -> float:
    """Max error of ``out`` (one fp32 step of ``u``) against the step in
    float64, over the grid's largest magnitude."""
    ref = step(u.double())
    return float((out.double() - ref).abs().max()) / float(u.abs().max())


def run(sizes=SIZES, iters: int = 5, device="cuda", seed: int = 0) -> list[dict]:
    """One row per size (time per step, bytes, bound, rate on the card,
    the float64 check) and one per weak-scaling point."""
    device = resolve_device(device)
    on_card = device.type == "cuda"
    g = torch.Generator(device=device).manual_seed(seed)
    rows = []
    for n in sizes:
        u = torch.randn((n, n), generator=g, device=device)
        err = check_step(u, step(u))
        if err > CHECK_RTOL:
            raise AssertionError(f"cloverleaf {n}x{n}: step differs from the float64 step by {err:.3g}")
        state = {"u": u}

        def chained():
            state["u"] = step(state["u"])

        dt = time_per_call(chained, iters, device)
        nbytes = step_bytes(n)
        bound_us = nbytes / HBM_BYTES_PER_S * 1e6
        rows.append({
            "name": f"cloverleaf_{n}x{n}", "us_per_call": dt * 1e6, "bytes": nbytes, "bound_us": bound_us,
            "achieved_gbps": nbytes / dt / 1e9 if on_card else None,
            "hbm_fraction": nbytes / dt / HBM_BYTES_PER_S if on_card else None,
            "max_rel_err_vs_float64": err, "halo_bytes_per_step": 2 * n * 4, "device": device_name(device),
            "derived": f"bound_h100_us={bound_us:.2f} max_rel_err_vs_float64={err:.1e}",
        })
        del u, state
    # weak scaling: a constant grid per chip, its halo against its compute
    for chips in (16, 64, 160, 256):
        n_local = 1024
        compute_bytes = step_bytes(n_local)
        halo_bytes = 2 * n_local * 4
        rows.append({
            "name": f"cloverleaf_weakscale_{chips}chips",
            "us_per_call": compute_bytes / HBM_BYTES_PER_S * 1e6,
            "derived": (f"halo/compute bytes = {halo_bytes / compute_bytes:.2e} (weak-scaling efficiency "
                        f"~ {1 / (1 + halo_bytes / compute_bytes):.4f}; bound at 3.35 TB/s, H100)"),
        })
    return rows


def main(argv=None) -> list[dict]:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--sizes", type=int, nargs="+", default=list(SIZES))
    ap.add_argument("--iters", type=int, default=5)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    rows = run(args.sizes, args.iters, args.device)
    for r in rows:
        print(f"{r['name']},{r['us_per_call']:.1f},{r['derived']}", flush=True)
    return rows


if __name__ == "__main__":
    main()
