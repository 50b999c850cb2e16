"""Training launcher of the port: one arch, a plain step loop on one device.

    python -m repro_torch.launch.train --arch olmo-1b --full --fp8 --steps 4 --batch 4 --seq 2048
    PYTHONPATH=src python -m repro_torch.launch.train --device cpu --steps 3   # smoke size

It takes the JAX launcher's flags and defaults (``--reduced`` smoke size by
default, ``--full`` for the published widths, ``--fp8``, ``--microbatches``,
``--seed``) and its ``RunConfig`` (``remat="full"``, ``warmup_steps=5``),
plus ``--device`` (the card unless ``cpu`` is asked for).  The quantized
GEMMs take ``PrecisionConfig``'s default, the CUDA K4 kernel.  It prints the
loss, the step time and tokens per second of every step.  The JAX launcher's fault-tolerant
runner, checkpointing (``--ckpt-dir``, ``--ckpt-every``, ``--fail-at``) and
energy ledger are not ported yet (ROADMAP); this launcher prints no energy
figure.
"""

from __future__ import annotations

import argparse
import time

import torch

from repro_torch.config import ParallelConfig, PrecisionConfig, RunConfig, TrainConfig, reduce_for_smoke
from repro_torch.configs import ARCHS, get_config
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
    ap.add_argument("--fp8", action="store_true", help="FP8 quantized training (delayed scaling)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    return ap.parse_args(argv)


def main(argv=None) -> list[dict]:
    """Run the loop; returns one record per step (loss, seconds, tokens/s)."""
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
    step = make_train_step(cfg, run)
    batch_fn = make_batch_fn(cfg, global_batch=args.batch, seq_len=args.seq, seed=args.seed, device=device)
    tokens = args.batch * args.seq
    records = []
    for i in range(args.steps):
        batch = batch_fn(i)
        t0 = time.perf_counter()
        state, m = step(state, batch)
        loss = float(m["loss"])  # waits for the step
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        dt = time.perf_counter() - t0
        records.append({"step": i, "loss": loss, "seconds": dt, "tokens_per_s": tokens / dt, "lr": float(m["lr"])})
        print(f"[train] step {i} loss {loss:.4f} lr {float(m['lr']):.2e} {dt * 1e3:.1f} ms {tokens / dt:.0f} tok/s", flush=True)
    return records


if __name__ == "__main__":
    main()
