"""The port's fault-tolerant runner against the JAX package's, on the CPU.

The four cases of ``tests/test_fault_tolerance.py`` run on the port: node
failure -> detection -> restore -> a bit-exact resume (every loss ``==``,
every leaf equal), several failures, heartbeat detection, the energy ledger.
Then both runners run one schedule from one state (the JAX package's,
bridged) on the JAX package's batches: ``steps_run``, ``failures``,
``restores``, ``rollback_steps`` and ``events`` must be equal and the losses
within ``test_torch_train.py``'s tolerances (fp32 compute 1e-6 relative;
fp8 over bf16 compute 2e-3).
"""

import jax
import numpy as np
import pytest
import torch

from repro.checkpoint import CheckpointManager as JaxManager
from repro.config import PrecisionConfig as JaxPrecisionConfig
from repro.config import RunConfig as JaxRunConfig
from repro.config import TrainConfig as JaxTrainConfig
from repro.config.model import reduce_for_smoke as jax_reduce
from repro.configs import get_config as jax_get_config
from repro.core import Cluster as JaxCluster
from repro.core import ClusterSpec as JaxClusterSpec
from repro.core import FaultTolerantRunner as JaxRunner
from repro.data import make_batch_fn as jax_make_batch_fn
from repro.train.step import init_train_state as jax_init_train_state
from repro.train.step import make_train_step as jax_make_train_step
from repro_torch.bridge import train_state_from_jax
from repro_torch.checkpoint import CheckpointManager
from repro_torch.config import PrecisionConfig, RunConfig, TrainConfig, reduce_for_smoke
from repro_torch.configs import get_config
from repro_torch.core import Cluster, ClusterSpec, FaultTolerantRunner
from repro_torch.data import make_batch_fn
from repro_torch.train import init_train_state, make_train_step
from repro_torch.utils.tree import flatten_with_paths

torch.set_num_threads(2)


def _cluster(cls, spec_cls):
    cluster = cls(spec_cls("t", nodes_per_pod=2, num_pods=1))
    cluster.allocate([0, 1], "train-job")
    for n in cluster.nodes.values():
        cluster.heartbeat(n.node_id, 0.0)
    return cluster


def build(tmp_path, tag, arch="olmo-1b", **runner_kw):
    cfg = reduce_for_smoke(get_config(arch))
    run = RunConfig(arch=arch, train=TrainConfig(global_batch=4, seq_len=16))
    return FaultTolerantRunner(
        step_fn=make_train_step(cfg, run),
        init_state=init_train_state(cfg, run, 0, device="cpu"),
        batch_fn=make_batch_fn(cfg, global_batch=4, seq_len=16, seed=0, device="cpu"),
        cluster=_cluster(Cluster, ClusterSpec),
        ckpt=CheckpointManager(tmp_path / tag, keep=3, async_save=False),
        checkpoint_every=5,
        **runner_kw,
    )


def states_equal(a, b) -> bool:
    pa, pb = flatten_with_paths(a), flatten_with_paths(b)
    return [p for p, _ in pa] == [p for p, _ in pb] and all(torch.equal(x, y) for (_, x), (_, y) in zip(pa, pb))


def test_failure_recovery_is_bit_exact(tmp_path):
    clean = build(tmp_path, "clean")
    r1 = clean.run(12)
    faulty = build(tmp_path, "faulty")
    r2 = faulty.run(12, failure_schedule={7: 1})
    assert r2.failures == 1 and r2.restores == 1 and r2.rollback_steps == 2
    assert r1.losses == r2.losses  # every step's loss, bit for bit
    assert states_equal(clean.state, faulty.state)
    # the two runners never shared a tensor: the restore built new ones
    ptrs = {x.data_ptr() for _, x in flatten_with_paths(clean.state)}
    assert not ptrs & {x.data_ptr() for _, x in flatten_with_paths(faulty.state)}


def test_multiple_failures_still_complete(tmp_path):
    runner = build(tmp_path, "multi")
    rep = runner.run(15, failure_schedule={4: 0, 9: 1, 13: 0})
    assert rep.failures == 3 and rep.restores == 3
    assert max(rep.losses) == 15


def test_heartbeat_detection_marks_failed(tmp_path):
    runner = build(tmp_path, "hb")
    cluster = runner.cluster
    cluster.heartbeat(0, 104.0)  # node 0 fresh
    cluster.heartbeat(1, 100.0)  # node 1 goes silent afterwards
    failed = cluster.sweep_heartbeats(105.0, suspect_after=0.5, fail_after=4.0)
    assert [n.node_id for n in failed] == [1]
    assert cluster.nodes[0].state.value in ("healthy", "suspect")


def test_energy_ledger_accumulates(tmp_path):
    runner = build(tmp_path, "energy")
    runner.run(6)
    rep = runner.ledger.report()
    assert rep["it_kwh"] >= 0 and runner.ledger.job_joules["train-job"] > 0
    assert rep["effective_pue"] < 1.1  # the paper's headline PUE target
    # every step's wall (taken after the loss reached the host) is charged to 8 chips
    assert runner.ledger.job_chipseconds["train-job"] > 0
    assert all(n >= 6 for n in runner.straggler.samples.values())


@pytest.mark.parametrize("precision", ["fp32", "fp8"])
def test_runner_matches_the_jax_runner(tmp_path, precision):
    """One failure schedule from one state on the JAX package's batches."""
    jcfg, tcfg = jax_reduce(jax_get_config("olmo-1b")), reduce_for_smoke(get_config("olmo-1b"))
    prec = {"compute_dtype": "float32"} if precision == "fp32" else {"fp8": True}
    tr = dict(global_batch=4, seq_len=16, warmup_steps=2, total_steps=20)
    jrun = JaxRunConfig(arch="olmo-1b", train=JaxTrainConfig(**tr), precision=JaxPrecisionConfig(**prec))
    trun = RunConfig(arch="olmo-1b", train=TrainConfig(**tr), precision=PrecisionConfig(**prec))
    jstate = jax_init_train_state(jcfg, jrun, jax.random.PRNGKey(0))
    tstate = train_state_from_jax(tcfg, jax.tree.map(np.asarray, jstate), device="cpu")
    jbatch = jax_make_batch_fn(jcfg, global_batch=4, seq_len=16, seed=0)
    batches = {s: jbatch(s) for s in range(8)}
    schedule, kw = {5: 1}, dict(checkpoint_every=3, job_id="train-job")
    jr = JaxRunner(step_fn=jax.jit(jax_make_train_step(jcfg, jrun)), init_state=jstate, batch_fn=batches.__getitem__,
                   cluster=_cluster(JaxCluster, JaxClusterSpec),
                   ckpt=JaxManager(tmp_path / "jax", keep=2, async_save=False), **kw)
    tr_ = FaultTolerantRunner(
        step_fn=make_train_step(tcfg, trun), init_state=tstate,
        batch_fn=lambda s: {k: torch.from_numpy(np.array(v)) for k, v in batches[s].items()},
        cluster=_cluster(Cluster, ClusterSpec), ckpt=CheckpointManager(tmp_path / "torch", keep=2, async_save=False),
        **kw)
    ref, got = jr.run(8, failure_schedule=dict(schedule)), tr_.run(8, failure_schedule=dict(schedule))
    for field in ("steps_run", "failures", "restores", "rollback_steps", "events"):
        assert getattr(got, field) == getattr(ref, field), field
    assert (got.failures, got.restores, got.rollback_steps) == (1, 1, 2)
    assert sorted(got.losses) == sorted(ref.losses) == list(range(1, 9))
    rel = 1e-6 if precision == "fp32" else 2e-3
    for s, loss in ref.losses.items():
        assert got.losses[s] == pytest.approx(loss, rel=rel), s
    assert [(n.state.value, n.job) for n in tr_.cluster.nodes.values()] == [
        (n.state.value, n.job) for n in jr.cluster.nodes.values()]
    assert sorted(p.name for p in (tmp_path / "torch").iterdir()) == sorted(p.name for p in (tmp_path / "jax").iterdir())
