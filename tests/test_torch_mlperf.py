"""Fig. 8 (MLPerf BERT-Large training) in the port, on the CPU.

* ``run(device="cpu")`` is the reference's measured run (reduced
  bert-large, 8 x 128 tokens, one warm step and eight timed): two rows in
  the reference's ``name,us_per_call,derived`` format, finite losses, the
  warmup's zero rate at step 0; the second row, the full config's
  roofline step, is the port's cost model (``launch.cost``) on the meta
  device, the analytical count beside it.
* Its ``RunConfig`` trains like the JAX step: from one bridged state on
  the same numpy batches, losses within ``test_torch_train.py``'s bf16
  tolerance (1e-3 relative).
* ``model_flops_per_step`` against the JAX package's jaxpr cost model
  (``repro.launch.jaxpr_cost.estimate_cost``) on the reduced and the full
  bert-large.  Without remat the cost model counts what the analytical
  count does plus the elementwise work: 1.0038x on the full config (448 x
  512), 1.062x on the reduced one, where elementwise work weighs more at
  d_model 64.  With ``remat="full"`` (the run's setting) it also counts the
  blocks' recompute: 1.216x full, 1.318x reduced, at most one more forward
  of the blocks over the analytical count, which leaves recompute out.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config import ParallelConfig as JaxParallelConfig
from repro.config import RunConfig as JaxRunConfig
from repro.config import ShapeConfig
from repro.config import TrainConfig as JaxTrainConfig
from repro.config.model import reduce_for_smoke as jax_reduce
from repro.configs import get_config as jax_get_config
from repro.launch.jaxpr_cost import estimate_cost
from repro.launch.specs import train_input_specs
from repro.train.step import abstract_train_state, init_train_state as jax_init_train_state
from repro.train.step import make_train_step as jax_make_train_step
from repro_torch.benchmarks import mlperf_train
from repro_torch.bridge import train_state_from_jax
from repro_torch.config import reduce_for_smoke
from repro_torch.configs import get_config
from repro_torch.train import make_train_step

torch.set_num_threads(2)


def test_reduced_run_rows_on_the_cpu(capsys):
    rows = mlperf_train.main(["--device", "cpu"])
    assert [r["name"] for r in rows] == ["mlperf_bert_reduced_cpu", "mlperf_bert_full_roofline"]
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 2
    for row, line in zip(rows, lines):
        name, us, derived = line.split(",")  # the reference's CSV row: no comma inside a field
        assert name == row["name"] and float(us) == pytest.approx(row["us_per_call"], abs=0.05) and derived
    measured, roofline = rows
    steps = measured["steps"]
    assert len(steps) == 1 + mlperf_train.CPU_STEPS and steps[0]["warm"] and not any(s["warm"] for s in steps[1:])
    assert all(np.isfinite(s["loss"]) and np.isfinite(s["grad_norm"]) for s in steps)
    assert steps[0]["lr"] == 0.0 and all(s["lr"] > 0 for s in steps[1:])  # warmup: the first step moves nothing
    assert measured["derived"] == f"loss {steps[1]['loss']:.3f}->{steps[-1]['loss']:.3f}"
    assert measured["us_per_call"] > 0 and measured["peak_mem_gb"] is None  # no card, no device memory
    flops = mlperf_train.model_flops_per_step(mlperf_train.full_config(), 448 * 512, 512)
    assert roofline["model_flops"] == flops  # the analytical count beside the cost model's
    assert 2.1e9 < flops / (448 * 512) < 2.2e9  # about 2.15 GFLOP a token
    # the row is the cost model's step (launch.cost on meta, remat full) at the bf16 peak, as the
    # reference's row is the jaxpr cost model's: the recompute puts it 1.216x over the analytical count
    assert roofline["us_per_call"] == pytest.approx(roofline["flops"] / 989e12 * 1e6)
    assert 1.20 < roofline["flops"] / flops < 1.23


def test_reduced_run_trains_like_the_jax_step():
    """The harness's ``RunConfig`` (the reference's defaults) from one
    bridged state: the same losses, step by step, as the JAX step's."""
    jcfg, tcfg = jax_reduce(jax_get_config("bert-large")), reduce_for_smoke(get_config("bert-large"))
    B, S = mlperf_train.CPU_BATCH, mlperf_train.CPU_SEQ
    jrun = JaxRunConfig(arch="bert-large", train=JaxTrainConfig(global_batch=B, seq_len=S))
    trun = mlperf_train.run_config(B, S)
    assert (trun.train.warmup_steps, trun.parallel.remat, trun.precision.compute_dtype, trun.precision.fp8) == (
        jrun.train.warmup_steps, jrun.parallel.remat, jrun.precision.compute_dtype, jrun.precision.fp8)
    jstate = jax_init_train_state(jcfg, jrun, jax.random.PRNGKey(0))
    tstate = train_state_from_jax(tcfg, jax.tree.map(np.asarray, jstate), device="cpu")
    jstep, tstep = jax.jit(jax_make_train_step(jcfg, jrun)), make_train_step(tcfg, trun)
    rng = np.random.default_rng(0)
    for _ in range(3):
        tok = rng.integers(0, jcfg.vocab_size, (B, S)).astype(np.int32)
        batch = {"tokens": tok, "labels": np.roll(tok, -1, axis=1)}
        jstate, jm = jstep(jstate, {k: jnp.asarray(v) for k, v in batch.items()})
        tstate, tm = tstep(tstate, {k: torch.from_numpy(v) for k, v in batch.items()})
        assert float(tm["lr"]) == pytest.approx(float(jm["lr"]), rel=1e-6)
        assert float(tm["loss"]) == pytest.approx(float(jm["loss"]), rel=1e-3)


@pytest.mark.parametrize("size", ["reduced", "full"])
def test_flop_count_against_the_jaxpr_cost_model(size):
    if size == "reduced":
        jcfg, tcfg = jax_reduce(jax_get_config("bert-large")), reduce_for_smoke(get_config("bert-large"))
        B, S, none_hi = mlperf_train.CPU_BATCH, mlperf_train.CPU_SEQ, 1.07
    else:
        jcfg, tcfg = jax_get_config("bert-large").replace(max_position=512), mlperf_train.full_config()
        B, S, none_hi = mlperf_train.MLPERF_BATCH, mlperf_train.MLPERF_SEQ, 1.01
    ours = mlperf_train.model_flops_per_step(tcfg, B * S, S)

    def jaxpr_flops(remat):
        run = JaxRunConfig(arch="bert-large", train=JaxTrainConfig(global_batch=B, seq_len=S),
                           parallel=JaxParallelConfig(remat=remat))
        batch = train_input_specs(jcfg, ShapeConfig("mlperf", S, B, "train"))
        return estimate_cost(jax_make_train_step(jcfg, run), abstract_train_state(jcfg, run), batch)["flops"]

    ratio_none, ratio_full = jaxpr_flops("none") / ours, jaxpr_flops("full") / ours
    assert 1.0 <= ratio_none <= none_hi  # the matmuls, plus the elementwise work the cost model also counts
    # remat recomputes at most the blocks' forward once: 1/3 of their share of the count
    head = 3.0 * B * S * 2 * tcfg.d_model * tcfg.padded_vocab
    blocks_share = 1.0 - head / ours
    assert ratio_none < ratio_full <= ratio_none * (1.0 + blocks_share / 3.0)
    # the count follows the config: bert is GELU (two FFN matrices) and bidirectional
    causal = mlperf_train.model_flops_per_step(tcfg.replace(causal=True), B * S, S)
    gated = mlperf_train.model_flops_per_step(tcfg.replace(activation="swiglu"), B * S, S)
    L, D, H, hd, F = tcfg.num_layers, tcfg.d_model, tcfg.num_heads, tcfg.head_dim, tcfg.d_ff
    assert ours - causal == pytest.approx(3 * B * S * 2 * L * 2 * H * hd * (S - (S + 1) / 2))
    assert gated - ours == pytest.approx(3 * B * S * 2 * L * D * F)
