"""MLPerf BERT-Large training (paper Fig. 8) on the card.

The counterpart of the repository's ``benchmarks/mlperf_train.py``.  The
paper reports single-node MLPerf BERT-Large time-to-train.  This harness
trains the bert-large config with the port's train step and reports its
step time beside the per-step roofline of the full config:

* on the card (``device="cuda"``, the default): bert-large at full width
  and depth (24 x 1024, 335 M parameters) at the reference's derived
  MLPerf step, 448 sequences of 512 tokens, as 14 microbatches of 32, with
  ``RunConfig``'s defaults (fp32 master weights, bf16 compute,
  ``remat="full"``, no fp8); one warm step, then three timed steps, each
  ended by a host sync.  It reports the step's seconds, tokens/s, model
  TFLOP/s against the H100's 989 bf16 TFLOP/s and peak memory;
* on the CPU (``device="cpu"``): the reference's own measured run,
  ``reduce_for_smoke(bert-large)``, 8 x 128 tokens, one warm step and
  eight timed; the time is the host's wall clock.

Either way the second row is the full config's roofline step, as the
reference's: the FLOPs of one step of the full config at 448 x 512 with
the reference's ``RunConfig`` (one microbatch, ``remat="full"``: the
blocks' recompute counts), counted by ``launch.cost`` on the meta device
(``launch.dryrun.build_train``), over 989e12; the analytical
``model_flops_per_step`` stands beside it as ``model_flops``.  ``run()`` returns rows in the reference's ``name,us_per_call,
derived`` format; the measured row also carries its readings (every
step's loss, gradient norm, lr and seconds; tokens/s, TFLOP/s, peak
memory).  Run on a machine with a card::

    PYTHONPATH=src python -m repro_torch.benchmarks.mlperf_train [--device cpu]
"""

from __future__ import annotations

import argparse
import time

import torch

from repro_torch.config import ParallelConfig, PrecisionConfig, RunConfig, TrainConfig, reduce_for_smoke
from repro_torch.configs import get_config
from repro_torch.data import make_batch_fn
from repro_torch.device import resolve_device
from repro_torch.models.ffn import is_gated
from repro_torch.train import init_train_state, make_train_step
from repro_torch.utils.tree import tree_leaves

BF16_FLOPS_PER_S = 989e12  # H100 SXM dense bf16 tensor cores
MLPERF_BATCH, MLPERF_SEQ, MLPERF_MICROBATCHES = 448, 512, 14  # 14 microbatches of 32
CPU_BATCH, CPU_SEQ, CPU_STEPS = 8, 128, 8  # the reference's measured run
CARD_STEPS = 3
FLOPS_FORMULA = "3 * T * 2 * (L * (D H hd + 2 D KV hd + H hd D + n D F + 2 H hd S_keys) + D V)"


def model_flops_per_step(cfg, tokens: int, seq: int) -> float:
    """Model FLOPs of one train step: 3 x the forward's matmul FLOPs
    (forward, and the backward's two products per matmul; remat's recompute
    is not counted).  Per token, ``2 x`` the multiply-adds of:

    * the attention projections, ``D H hd + 2 D KV hd + H hd D``;
    * the FFN, ``n D F`` with n = 3 for a gated activation, 2 otherwise;
    * the scores and ``P V``, ``2 H hd S_keys`` with S_keys = S for
      bidirectional attention, ``(S + 1) / 2`` on average for causal;
    * the head, ``D V`` (V the padded vocab).

    Biases, norms, activations, softmax and the position table are
    elementwise and not counted."""
    L, D, F, V = cfg.num_layers, cfg.d_model, cfg.d_ff, cfg.padded_vocab
    H, KV, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    keys = seq if not cfg.causal else (seq + 1) / 2
    per_layer = D * H * hd + 2 * D * KV * hd + H * hd * D + (3 if is_gated(cfg.activation) else 2) * D * F
    per_token = 2 * (L * (per_layer + 2 * H * hd * keys) + D * V)
    return 3.0 * tokens * per_token


def full_config():
    """bert-large at full width and depth, positions up to the MLPerf 512."""
    return get_config("bert-large").replace(max_position=MLPERF_SEQ)


def run_config(global_batch: int, seq_len: int, microbatches: int = 1) -> RunConfig:
    """The reference's ``RunConfig`` defaults (fp32 master, bf16 compute,
    ``remat="full"``, no fp8, warmup 100) at this batch."""
    return RunConfig(
        arch="bert-large",
        train=TrainConfig(global_batch=global_batch, seq_len=seq_len),
        parallel=ParallelConfig(num_microbatches=microbatches),
        precision=PrecisionConfig(),
    )


def train_steps(cfg, run_cfg, steps: int, device, seed: int = 0) -> dict:
    """One warm step, then ``steps`` timed ones, each ended by a host sync."""
    tr = run_cfg.train
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    state = init_train_state(cfg, run_cfg, seed, device)
    step = make_train_step(cfg, run_cfg)
    batch_fn = make_batch_fn(cfg, global_batch=tr.global_batch, seq_len=tr.seq_len, seed=seed, device=device)
    records = []
    for i in range(steps + 1):
        batch = batch_fn(i)
        t0 = time.perf_counter()
        state, m = step(state, batch)
        loss = float(m["loss"])  # waits for the step
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        records.append({"step": i, "warm": i == 0, "loss": loss, "grad_norm": float(m["grad_norm"]),
                        "lr": float(m["lr"]), "seconds": time.perf_counter() - t0})
    timed = [r["seconds"] for r in records[1:]]
    return {
        "params": sum(t.numel() for t in tree_leaves(state.params)),
        "steps": records,
        "step_seconds": sum(timed) / len(timed),
        "peak_mem_gb": torch.cuda.max_memory_allocated(device) / 1e9 if device.type == "cuda" else None,
    }


def run(device="cuda") -> list[dict]:
    device = resolve_device(device)
    full = full_config()
    analytic_flops = model_flops_per_step(full, MLPERF_BATCH * MLPERF_SEQ, MLPERF_SEQ)
    if device.type == "cpu":
        cfg = reduce_for_smoke(get_config("bert-large"))
        r = train_steps(cfg, run_config(CPU_BATCH, CPU_SEQ), CPU_STEPS, device)
        losses = [s["loss"] for s in r["steps"][1:]]
        measured = {"name": "mlperf_bert_reduced_cpu", "us_per_call": r["step_seconds"] * 1e6,
                    "derived": f"loss {losses[0]:.3f}->{losses[-1]:.3f}"}
    else:
        tokens = MLPERF_BATCH * MLPERF_SEQ
        r = train_steps(full, run_config(MLPERF_BATCH, MLPERF_SEQ, MLPERF_MICROBATCHES), CARD_STEPS, device)
        losses = [s["loss"] for s in r["steps"][1:]]
        tflop_s = analytic_flops / r["step_seconds"] / 1e12
        r.update(tokens_per_s=tokens / r["step_seconds"], model_tflop_s=tflop_s,
                 bf16_peak_share=tflop_s * 1e12 / BF16_FLOPS_PER_S, device=torch.cuda.get_device_name(device))
        measured = {"name": "mlperf_bert_full_h100", "us_per_call": r["step_seconds"] * 1e6,
                    "derived": (f"loss {losses[0]:.3f}->{losses[-1]:.3f} {r['tokens_per_s']:.0f} tok/s "
                                f"{tflop_s:.1f} TFLOP/s ({r['bf16_peak_share']:.3f} of 989) "
                                f"peak {r['peak_mem_gb']:.1f} GB")}
    measured.update(r)
    return [measured, roofline_row(full, analytic_flops)]


def roofline_row(full, model_flops: float) -> dict:
    """The full config's step on one H100's bf16 compute roofline: the
    FLOPs ``launch.cost`` counts on the meta device for one step at the
    reference's ``RunConfig`` (448 x 512, one microbatch, remat full)."""
    from repro_torch.config import ShapeConfig
    from repro_torch.launch.cost import estimate_cost
    from repro_torch.launch.dryrun import build_train

    step, args = build_train(full, run_config(MLPERF_BATCH, MLPERF_SEQ), ShapeConfig("mlperf", MLPERF_SEQ,
                                                                                  MLPERF_BATCH, "train"))
    est = estimate_cost(step, *args)
    return {"name": "mlperf_bert_full_roofline", "us_per_call": est["flops"] / BF16_FLOPS_PER_S * 1e6,
            "derived": f"global_flops={est['flops']:.3g} model_flops={model_flops:.3g} per-step @1 H100 bf16",
            "flops": est["flops"], "hbm_bytes": est["hbm_bytes"], "model_flops": model_flops}


def main(argv=None) -> list[dict]:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    rows = run(ap.parse_args(argv).device)
    for r in rows:
        print(f"{r['name']},{r['us_per_call']:.1f},{r['derived']}")
    return rows


if __name__ == "__main__":
    main()
