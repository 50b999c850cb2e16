"""Training launcher of the port: one arch under the fault-tolerant runner on one device.

    python -m repro_torch.launch.train --arch olmo-1b --full --fp8 --steps 4 --batch 4 --seq 2048
    PYTHONPATH=src python -m repro_torch.launch.train --device cpu --steps 3   # smoke size
    PYTHONPATH=src python -m repro_torch.launch.train --device cpu --steps 6 --ckpt-every 2 --fail-at 3

It takes the JAX launcher's flags, archs and defaults (``--arch``: any
registered config, hubert-xlarge, qwen3-moe-235b-a22b, arctic-480b and
hymba-1.5b included; ``--reduced`` smoke size by default, ``--full`` for
the published widths, ``--fp8``, ``--microbatches``,
``--seed``, ``--ckpt-dir``, ``--ckpt-every``, ``--fail-at``) and its
``RunConfig`` (``remat="full"``, ``warmup_steps=5``), plus ``--device`` (the
card unless ``cpu`` is asked for).  The quantized GEMMs take
``PrecisionConfig``'s default, the CUDA K4 kernel.  As the JAX launcher, it
runs the steps under ``core.FaultTolerantRunner`` on a simulated two-node
cluster (heartbeats, a node failure at ``--fail-at``, restore from the
newest checkpoint, synchronous saves every ``--ckpt-every`` steps into
``<ckpt-dir>/<model>``, newest two kept) and charges them to an
``EnergyLedger``.  A run starts from step 0, so the checkpoints an earlier
run left in ``<ckpt-dir>/<model>`` are removed first: the newest-k rule
would keep them over this run's, and a failure would restore them.  It prints the loss, the aux loss (the moe
family's load-balance loss, else 0), the step time and tokens per second
of every step run (replayed steps again), then the JAX launcher's summary
(steps, first and last loss, failures, restores) and energy report.
"""

from __future__ import annotations

import argparse
import os
import tempfile
import time

import torch

from repro_torch.checkpoint import CheckpointManager, available_steps, delete_step
from repro_torch.config import ParallelConfig, PrecisionConfig, RunConfig, TrainConfig, reduce_for_smoke
from repro_torch.configs import ARCHS, get_config
from repro_torch.core import Cluster, ClusterSpec, EnergyLedger, FaultTolerantRunner
from repro_torch.data import make_batch_fn
from repro_torch.device import resolve_device
from repro_torch.train.step import init_train_state, make_train_step
from repro_torch.utils.tree import tree_leaves


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="olmo-1b", choices=sorted(ARCHS.names()))
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--reduced", dest="reduced", action="store_true", default=True)
    ap.add_argument("--full", dest="reduced", action="store_false")
    ap.add_argument("--ckpt-dir", default=os.path.join(tempfile.gettempdir(), "repro_train_ckpt"))
    ap.add_argument("--ckpt-every", type=int, default=10)
    ap.add_argument("--fail-at", type=int, default=0, help="inject a node failure at this step (chaos test)")
    ap.add_argument("--fp8", action="store_true", help="FP8 quantized training (delayed scaling)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    return ap.parse_args(argv)


def main(argv=None) -> list[dict]:
    """Run the steps; returns one record per step run (step, loss, aux_loss,
    seconds, tokens/s, lr), a replayed step again."""
    args = parse_args(argv)
    device = resolve_device(args.device)
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = reduce_for_smoke(cfg)
    run = RunConfig(
        arch=args.arch,
        train=TrainConfig(global_batch=args.batch, seq_len=args.seq, warmup_steps=5, total_steps=args.steps),
        parallel=ParallelConfig(num_microbatches=args.microbatches, remat="full"),
        precision=PrecisionConfig(fp8=args.fp8),
    )
    state = init_train_state(cfg, run, args.seed, device)
    n_params = sum(t.numel() for t in tree_leaves(state.params))
    print(f"[train] {cfg.name} family={cfg.family} params={n_params / 1e6:.1f}M "
          f"(reduced={args.reduced}) device={device}", flush=True)
    if state.fp8 is not None:
        print(f"[train] fp8: ON ({len(state.fp8.scale) // 2} gemm sites, "
              f"window={run.precision.fp8_amax_history}, gemm={run.precision.fp8_gemm})", flush=True)
    train_step = make_train_step(cfg, run)
    batch_fn = make_batch_fn(cfg, global_batch=args.batch, seq_len=args.seq, seed=args.seed, device=device)
    tokens = args.batch * args.seq
    records = []
    current = {}

    def batch_of(i):
        current["step"] = i
        return batch_fn(i)

    def step(state, batch):  # one timed step, printed and recorded
        t0 = time.perf_counter()
        state, m = train_step(state, batch)
        loss = float(m["loss"])  # waits for the step
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        dt = time.perf_counter() - t0
        i, lr, aux = current["step"], float(m["lr"]), float(m["aux_loss"])
        records.append({"step": i, "loss": loss, "aux_loss": aux, "seconds": dt, "tokens_per_s": tokens / dt, "lr": lr})
        print(f"[train] step {i} loss {loss:.4f} aux_loss {aux:.4g} lr {lr:.2e} {dt * 1e3:.1f} ms "
              f"{tokens / dt:.0f} tok/s", flush=True)
        return state, m

    cluster = Cluster(ClusterSpec("local", nodes_per_pod=2, num_pods=1))
    cluster.allocate([0, 1], "train")
    for n in cluster.nodes.values():
        cluster.heartbeat(n.node_id, 0.0)
    ckpt = CheckpointManager(f"{args.ckpt_dir}/{cfg.name}", keep=2, async_save=False)
    stale = available_steps(ckpt.directory)
    for s in stale:
        delete_step(ckpt.directory, s)
    if stale:
        print(f"[train] removed {len(stale)} checkpoints of an earlier run from {ckpt.directory}", flush=True)
    runner = FaultTolerantRunner(
        step_fn=step,
        init_state=state,
        batch_fn=batch_of,
        cluster=cluster,
        ckpt=ckpt,
        job_id="train",
        checkpoint_every=args.ckpt_every,
        ledger=EnergyLedger(),
    )
    schedule = {args.fail_at: 1} if args.fail_at else None
    t0 = time.time()
    report = runner.run(args.steps, failure_schedule=schedule)
    dt = time.time() - t0
    last = max(report.losses)
    print(f"[train] {report.steps_run} steps in {dt:.1f}s  "
          f"loss {report.losses[min(report.losses)]:.4f} -> {report.losses[last]:.4f}  "
          f"failures={report.failures} restores={report.restores}", flush=True)
    print(f"[train] energy: {runner.ledger.report()}", flush=True)
    return records


if __name__ == "__main__":
    main()
