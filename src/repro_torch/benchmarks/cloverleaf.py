"""CloverLeaf weak scaling (paper Fig. 11), on one device or over ranks.

The counterpart of the repository's ``benchmarks/cloverleaf.py``.  The
paper weak-scales the CloverLeaf hydrodynamics mini-app (a structured-grid
stencil, bound by memory bandwidth, with MPI halo exchange) to 160 GH200s.
The reference computes a 5-point Jacobi update of a 2-D fp32 grid whose
rows are sharded over a mesh axis ``"x"``, with a halo exchange
(``ppermute``) per step, in array ops outside any Pallas kernel; so does
the port, in tensor ops:

* the halo over ``n`` ranks (``make_step(mesh)``, a 1-D ``DeviceMesh``
  named ``"x"``, ``row_mesh``): each rank holds its contiguous ``(H / n,
  W)`` row block, sends its last row to rank ``(i + 1) % n`` and its first
  row to rank ``(i - 1) % n`` (the reference's wrap-around ``ppermute``
  pairs) with one ``torch.distributed.batch_isend_irecv``, and pads its
  block with the row received from above and the one from below.  Under
  gloo on the card the two rows travel through host memory (gloo's
  point-to-point ops take host tensors);
* the halo on one device (``step``): the pairs are (0 -> 0), so the row
  above the first is the grid's last row and the row below the last is its
  first: **the rows wrap around**;
* the columns are padded by replicating the edge (``jnp.pad(mode="edge")``),
  and the update is ``0.2 * (c + n + s + w + e)`` over the padded block,
  summed in the reference's order.  So every cell sums the same five terms
  in the same order on any number of ranks: the step over ranks equals
  the one-device step bit for bit.

``run`` times ``step`` (CUDA events over ``iters`` chained steps on the
card, the host's wall clock on the CPU) at the reference's sizes and
checks each size's first step against the same step in float64.  Each row
carries the bytes the reference counts (each cell read once and written
once, fp32), their least time at the H100 SXM's 3.35 TB/s (``bound_us``,
in place of the reference's v5e model), on the card the rate achieved,
and ``halo_bytes_per_step`` as the reference counts it (``2 * n * 4 *
ranks``).  ``run(ranks=n)`` runs ``n`` ranks (``launch.mesh.run_ranks``;
gloo, on the one card too; ``ranks=(2, 4)`` both counts in one world of
4): each rank times the chained step on its block and checks its first
step against its rows of the one-device step on the whole grid, bit for
bit, and a control (each rank wraps its own rows, no exchange) that must
differ from it on some rank; the row reads every rank's time (the slowest
sets the step) and the backend.  The weak-scaling rows derive the
halo-to-compute byte ratio at 1024^2 cells a chip, with the same rate.
Run on a machine with a card::

    PYTHONPATH=src python -m repro_torch.benchmarks.cloverleaf [--sizes 256 512 1024 16384] [--device cpu]
    PYTHONPATH=src python -m repro_torch.benchmarks.cloverleaf --ranks 2 4 [--device cpu]
"""

from __future__ import annotations

import argparse

import torch
import torch.distributed as dist

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
    return pad_columns(torch.cat([u[-1:], u, u[:1]], dim=0))


def step(u: torch.Tensor) -> torch.Tensor:
    """One step of the reference's ``make_step`` on a one-device mesh."""
    return stencil(halo(u))


def pad_columns(rows: torch.Tensor) -> torch.Tensor:
    """The columns edge-replicated, as ``jnp.pad(mode="edge")``."""
    return torch.cat([rows[:, :1], rows, rows[:, -1:]], dim=1)


def row_mesh(n: int, device_type: str = "cpu"):
    """The 1-D mesh ``"x"`` over the first ``n`` ranks of the initialized
    process group (every rank of the world calls it; the ranks past ``n``
    get None)."""
    from torch.distributed.device_mesh import DeviceMesh

    mesh = DeviceMesh(device_type, torch.arange(n), mesh_dim_names=("x",))
    return mesh if dist.get_rank() < n else None


def exchange_halo(u: torch.Tensor, group) -> tuple[torch.Tensor, torch.Tensor]:
    """(the row above this block, the row below it): this rank's last row
    goes to rank ``i + 1`` and its first to rank ``i - 1`` (mod ``n``),
    both exchanges in one ``batch_isend_irecv``, the reference's
    ``ppermute`` pairs.  Under gloo a card's rows travel through host
    memory."""
    n, i = dist.get_world_size(group), dist.get_rank(group)
    nxt, prv = dist.get_global_rank(group, (i + 1) % n), dist.get_global_rank(group, (i - 1) % n)
    stage = u.device.type == "cuda" and dist.get_backend(group) == "gloo"
    last, first = u[-1:].contiguous(), u[:1].contiguous()
    if stage:
        last, first = last.cpu(), first.cpu()
    up, down = torch.empty_like(last), torch.empty_like(first)
    ops = [dist.P2POp(dist.isend, last, nxt, group, tag=0), dist.P2POp(dist.irecv, up, prv, group, tag=0),
           dist.P2POp(dist.isend, first, prv, group, tag=1), dist.P2POp(dist.irecv, down, nxt, group, tag=1)]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return (up.to(u.device), down.to(u.device)) if stage else (up, down)


def make_step(mesh):
    """The reference's ``make_step(mesh)``: the step of this rank's
    ``(H / n, W)`` row block over the 1-D mesh ``"x"``: the halo exchange
    with the neighbouring ranks, then the stencil."""
    group = mesh.get_group("x")

    def step_block(u: torch.Tensor) -> torch.Tensor:
        up, down = exchange_halo(u, group)
        return stencil(pad_columns(torch.cat([up, u, down], dim=0)))

    return step_block


def block_of(u: torch.Tensor, mesh) -> torch.Tensor:
    """This rank's contiguous row block of the whole grid ``u``."""
    n, i = mesh.size(), mesh.get_local_rank("x")
    return u.narrow(0, i * (u.shape[0] // n), u.shape[0] // n)


def step_bytes(n: int, itemsize: int = 4) -> int:
    """The bytes the reference counts for one step: each cell read once
    and written once."""
    return 2 * n * n * itemsize


def check_step(u: torch.Tensor, out: torch.Tensor) -> float:
    """Max error of ``out`` (one fp32 step of ``u``) against the step in
    float64, over the grid's largest magnitude."""
    ref = step(u.double())
    return float((out.double() - ref).abs().max()) / float(u.abs().max())


def rank_rows(rank: int, _mesh, sizes, iters: int, device_type: str, seed: int, counts: tuple) -> dict:
    """One rank of ``run(ranks=)``, for each rank count ``n`` of ``counts``
    (row meshes over the first ``n`` ranks of one world; the ranks past
    ``n`` wait at the barriers): each size's grid drawn from ``seed``, this
    rank's block stepped over the row mesh and timed, its first step
    against its rows of the one-device step (bit for bit) and the control's
    (each rank wraps its own rows: no exchange)."""
    device = torch.device("cuda", torch.cuda.current_device()) if device_type == "cuda" else torch.device("cpu")
    out = {}
    for n in counts:
        mesh = row_mesh(n, "cuda" if dist.get_backend() == "nccl" else "cpu")
        step_block = make_step(mesh) if mesh is not None else None
        g = torch.Generator(device=device).manual_seed(seed)
        for size in sizes:
            u = torch.randn((size, size), generator=g, device=device)
            dist.barrier()
            if mesh is None:
                continue
            mine, whole = block_of(u, mesh), block_of(step(u), mesh)
            state = {"u": mine.clone()}

            def chained():
                state["u"] = step_block(state["u"])

            out[n, size] = {"s": time_per_call(chained, iters, device),
                            "bit_exact": bool(torch.equal(step_block(mine), whole)),
                            "control_bit_exact": bool(torch.equal(step(mine), whole))}
            del mine, whole, state
        dist.barrier()
    return out


def _size_row(n: int, dt: float, on_card: bool, ranks: int, device) -> dict:
    nbytes = step_bytes(n)
    bound_us = nbytes / HBM_BYTES_PER_S * 1e6
    return {"name": f"cloverleaf_{n}x{n}" + (f"_{ranks}ranks" if ranks > 1 else ""), "us_per_call": dt * 1e6,
            "bytes": nbytes, "bound_us": bound_us, "achieved_gbps": nbytes / dt / 1e9 if on_card else None,
            "hbm_fraction": nbytes / dt / HBM_BYTES_PER_S if on_card else None,
            "halo_bytes_per_step": 2 * n * 4 * ranks, "device": device_name(device)}


def run_ranks_rows(sizes, iters: int, device, seed: int, counts: tuple) -> list[dict]:
    """``run(ranks=)``'s size rows for every rank count of ``counts``, from
    one world of the largest count's gloo ranks (on the CPU, or all on the
    card), each row the slowest rank's time per step."""
    from repro_torch.launch.mesh import run_ranks

    per_rank = run_ranks(rank_rows, max(counts), backend="gloo", device=device.type,
                         args=(tuple(sizes), iters, device.type, seed, counts), timeout_s=600)
    rows = []
    for ranks in counts:
        for n in sizes:
            got = [r[ranks, n] for r in per_rank[:ranks]]
            if not all(g["bit_exact"] for g in got):
                raise AssertionError(f"cloverleaf {n}x{n} over {ranks} ranks: a block differs from the one-device step")
            if all(g["control_bit_exact"] for g in got):
                raise AssertionError(f"cloverleaf {n}x{n} over {ranks} ranks: the control (each rank wraps its own "
                                     "rows) matches the one-device step, which then proves nothing")
            row = _size_row(n, max(g["s"] for g in got), device.type == "cuda", ranks, device)
            row.update(ranks=ranks, backend="gloo", rank_us=[g["s"] * 1e6 for g in got], bit_exact=True,
                       control_bit_exact=[g["control_bit_exact"] for g in got],
                       derived=f"bound_h100_us={row['bound_us']:.2f} ranks={ranks} bit_exact=True")
            rows.append(row)
    return rows


def run(sizes=SIZES, iters: int = 5, device="cuda", seed: int = 0, ranks: int | tuple = 1) -> list[dict]:
    """One row per size (time per step, bytes, bound, rate on the card,
    the float64 check), or over ``ranks`` (a count, or several run in one
    world of the largest) one per count and size with the bit-exact check;
    then one row per weak-scaling point."""
    device = resolve_device(device)
    on_card = device.type == "cuda"
    counts = tuple(ranks) if isinstance(ranks, (tuple, list)) else (ranks,)
    if max(counts) > 1:
        rows = run_ranks_rows(sizes, iters, device, seed, counts)
        sizes = ()
    else:
        rows = []
    g = torch.Generator(device=device).manual_seed(seed)
    for n in sizes:
        u = torch.randn((n, n), generator=g, device=device)
        err = check_step(u, step(u))
        if err > CHECK_RTOL:
            raise AssertionError(f"cloverleaf {n}x{n}: step differs from the float64 step by {err:.3g}")
        state = {"u": u}

        def chained():
            state["u"] = step(state["u"])

        row = _size_row(n, time_per_call(chained, iters, device), on_card, 1, device)
        row.update(max_rel_err_vs_float64=err,
                   derived=f"bound_h100_us={row['bound_us']:.2f} max_rel_err_vs_float64={err:.1e}")
        rows.append(row)
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
    ap.add_argument("--ranks", type=int, nargs="+", default=[1],
                    help="gloo ranks the grid's rows split over (several: one world of the largest)")
    args = ap.parse_args(argv)
    rows = run(args.sizes, args.iters, args.device, ranks=tuple(args.ranks))
    for r in rows:
        print(f"{r['name']},{r['us_per_call']:.1f},{r['derived']}", flush=True)
    return rows


if __name__ == "__main__":
    main()
