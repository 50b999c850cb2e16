"""Elastic scaling and tenant meshes of the port (``core/elastic.py``,
``TenantManager.make_tenant_mesh``) against the JAX package's, on the CPU.

* The resize plan: the JAX package's ``tests/test_elastic.py`` plan cases,
  its property over random capacities (``hypothesis``), and every plan
  equal to the JAX package's; ``resize_batch`` equal to the JAX package's,
  dropping and repeating rows.
* On four gloo ranks in one spawn (``torch_sharded_ranks.elastic_cases``;
  the ranks import no JAX):

  - ``make_tenant_mesh`` for tenants of 1 to 4 of 4 nodes at model
    parallelism 1, 2 and 8: the JAX package's proportional share of the
    world's ranks, rounded down to the model degree, as a ``(share / mp,
    mp)`` mesh over the first ranks, None on the other ranks, and
    ``ValueError`` where one model group needs more ranks than the world
    has (the JAX package's reshape fails there);
  - a ``(2, 2)`` -> ``(1, 2)`` shrink after 3 fp32 steps: the full state
    gathered on the new mesh equals the old one bit for bit (params, ``m``,
    ``v``, step), and 3 more steps on ``resize_batch``'s batches (8 -> 4
    rows) equal the port's unsharded step on the same batches within the
    fp32 limits of ``test_torch_sharded_train.py`` (loss 1e-6 relative,
    parameters 1e-6);
  - the JAX package's ``test_elastic_resume_continues_training`` scenario
    (smoke olmo-1b, its default bf16 run, global batch 8 x 16 of the
    synthetic data, 3 steps, a shrink to half the chips at model degree 1
    there and from ``(2, 2)`` to ``(1, 2)`` here, both halving the batch to
    4, then 5 steps), from the bridged JAX initialisation: the state
    resharded bit for bit, the reference's own checks (finite losses, the
    last below the one before the shrink plus 1), and every loss within
    the bf16 limit (1e-3 relative) of the JAX run's, every parameter within
    2 lr a step of it.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

pytest.importorskip("hypothesis")
from hypothesis import given, settings, strategies as st  # noqa: E402

import repro.core as jax_core  # noqa: E402
from repro.config import RunConfig as JaxRunConfig  # noqa: E402
from repro.config import TrainConfig as JaxTrainConfig  # noqa: E402
from repro.config.model import reduce_for_smoke as jax_reduce  # noqa: E402
from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.data import make_batch_fn as jax_make_batch_fn  # noqa: E402
from repro.train.step import init_train_state as jax_init_train_state  # noqa: E402
from repro.train.step import make_train_step as jax_make_train_step  # noqa: E402
import repro_torch.core as core  # noqa: E402
from repro_torch.bridge import params_from_jax, train_state_from_jax  # noqa: E402
from repro_torch.config import ParallelConfig, PrecisionConfig, RunConfig, TrainConfig, reduce_for_smoke  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.launch.mesh import run_ranks  # noqa: E402
from repro_torch.train import init_train_state, make_train_step  # noqa: E402
from repro_torch.utils.tree import tree_leaves  # noqa: E402

import torch_sharded_ranks  # noqa: E402

torch.set_num_threads(2)

PLAN_FIELDS = ("old_chips", "new_chips", "data", "model", "old_global_batch", "new_global_batch")
# (tenant's nodes, nodes of the cluster, model_parallel) -> the mesh's shape, or None for an error
SHARES = [((2, 4, 1), (2, 1)), ((2, 4, 2), (1, 2)), ((4, 4, 2), (2, 2)), ((1, 4, 2), (1, 2)), ((3, 4, 2), (1, 2)),
          ((4, 4, 1), (4, 1)), ((1, 4, 8), None)]
SHRINK = dict(old_chips=4, new_chips=2, model_parallel=2, global_batch=8)
STEPS_BEFORE, STEPS_AFTER, JAX_STEPS_AFTER = 3, 3, 5


def _fields(plan):
    return tuple(getattr(plan, f) for f in PLAN_FIELDS)


def test_plan_shrink_keeps_per_chip_batch():
    plan = core.plan_resize(old_chips=256, new_chips=192, model_parallel=16, global_batch=256)
    assert plan.model == 16 and plan.data == 12 and plan.shape == (12, 16)
    # per-data-shard batch was 16 -> new global = 12 * 16
    assert plan.new_global_batch == 192
    assert _fields(plan) == _fields(jax_core.plan_resize(old_chips=256, new_chips=192, model_parallel=16,
                                                         global_batch=256))


def test_plan_rejects_too_small():
    with pytest.raises(ValueError, match="model_parallel=16"):
        core.plan_resize(old_chips=256, new_chips=8, model_parallel=16, global_batch=256)


@settings(max_examples=100, deadline=None)
@given(st.integers(1, 8), st.integers(16, 512), st.integers(16, 512), st.integers(1, 8))
def test_plan_properties(mp, old, new, divisor):
    if new < mp:
        return
    kw = dict(old_chips=old, new_chips=new, model_parallel=mp, global_batch=64, batch_divisor=divisor)
    plan = core.plan_resize(**kw)
    assert plan.data * plan.model <= new
    assert plan.new_global_batch >= 1
    assert plan.model == mp
    assert _fields(plan) == _fields(jax_core.plan_resize(**kw))


@pytest.mark.parametrize("rows", [2, 4, 6])
def test_resize_batch_equals_jax(rows):
    plan = core.plan_resize(old_chips=8, new_chips=rows, model_parallel=1, global_batch=4)
    x = np.arange(4 * 3, dtype=np.int32).reshape(4, 3)
    got = core.resize_batch({"tokens": torch.from_numpy(x)}, plan)["tokens"].numpy()
    ref = np.asarray(jax_core.resize_batch({"tokens": jnp.asarray(x)}, plan)["tokens"])
    np.testing.assert_array_equal(got, ref)
    assert got.shape[0] == plan.new_global_batch


def _fp32_shrink_case():
    cfg = reduce_for_smoke(get_config("olmo-1b"))
    run = RunConfig(arch="olmo-1b", train=TrainConfig(global_batch=8, seq_len=16, learning_rate=1e-3, warmup_steps=2,
                                                      total_steps=10),
                    parallel=ParallelConfig(remat="full"), precision=PrecisionConfig(compute_dtype="float32"))
    rng = np.random.default_rng(3)
    batches = []
    for _ in range(STEPS_BEFORE + STEPS_AFTER):
        tok = rng.integers(0, cfg.vocab_size, (8, 16)).astype(np.int32)
        batches.append({"tokens": torch.from_numpy(tok), "labels": torch.from_numpy(np.roll(tok, -1, axis=1))})
    return {"cfg": cfg, "run": run, "state": init_train_state(cfg, run, 0, device="cpu"), "batches": batches}


def _unsharded(case, plan):
    """The port on one process: the same steps, the last ones on the
    resized batches."""
    cfg, run = case["cfg"], case["run"]
    state = init_train_state(cfg, run, 0, device="cpu")
    step = make_train_step(cfg, run)
    losses = []
    for i, batch in enumerate(case["batches"]):
        state, m = step(state, batch if i < STEPS_BEFORE else core.resize_batch(batch, plan))
        losses.append(float(m["loss"]))
    return losses, [t.numpy() for t in tree_leaves(state.params)]


def _jax_scenario():
    """The JAX package's ``test_elastic_resume_continues_training``, with
    its state at the start and its losses, rates and final parameters."""
    jcfg = jax_reduce(jax_get_config("olmo-1b"))
    run = JaxRunConfig(arch="olmo-1b", train=JaxTrainConfig(global_batch=8, seq_len=16))
    state = jax_init_train_state(jcfg, run, jax.random.PRNGKey(0))
    start = jax.tree.map(np.asarray, state)
    step = jax.jit(jax_make_train_step(jcfg, run))
    batch_fn = jax_make_batch_fn(jcfg, global_batch=8, seq_len=16)
    losses, lrs, batches = [], [], []
    for s in range(STEPS_BEFORE):
        batches.append(batch_fn(s))
        state, m = step(state, batches[-1])
        losses.append(float(m["loss"]))
        lrs.append(float(m["lr"]))
    plan = jax_core.plan_resize(old_chips=8, new_chips=4, model_parallel=1, global_batch=8)
    mesh = jax_core.make_elastic_mesh(plan)
    from jax.sharding import NamedSharding, PartitionSpec as P

    state = jax_core.reshard_state(state, jax.tree.map(lambda _: NamedSharding(mesh, P()), state))
    small_step = jax.jit(jax_make_train_step(jcfg, run))
    for s in range(STEPS_BEFORE, STEPS_BEFORE + JAX_STEPS_AFTER):
        batches.append(batch_fn(s))
        small = jax_core.resize_batch(batches[-1], plan)
        state, m = small_step(state, small)
        losses.append(float(m["loss"]))
        lrs.append(float(m["lr"]))
    return start, batches, plan, losses, lrs, jax.tree.map(np.asarray, state.params)


@pytest.fixture(scope="module")
def runs():
    fp32 = _fp32_shrink_case()
    tcfg = reduce_for_smoke(get_config("olmo-1b"))
    start, jbatches, jplan, jlosses, jlrs, jparams = _jax_scenario()
    trun = RunConfig(arch="olmo-1b", train=TrainConfig(global_batch=8, seq_len=16))
    scenario = {"cfg": tcfg, "run": trun, "state": train_state_from_jax(tcfg, start, device="cpu"),
                "batches": [{k: torch.from_numpy(np.array(v)) for k, v in b.items()} for b in jbatches]}
    shrinks = [(fp32, SHRINK, STEPS_AFTER), (scenario, SHRINK, JAX_STEPS_AFTER)]
    ranks = run_ranks(torch_sharded_ranks.elastic_cases, (2, 2), device="cpu", timeout_s=300,
                      args=([s for s, _ in SHARES], shrinks))
    reference = _unsharded(fp32, core.plan_resize(**SHRINK))
    jax_ref = {"plan": jplan, "losses": jlosses, "lrs": jlrs,
               "params": [t.numpy() for t in tree_leaves(params_from_jax(tcfg, jparams, device="cpu"))]}
    return ranks, reference, jax_ref


@pytest.mark.parametrize("i", range(len(SHARES)), ids=[f"{n}of{t}-mp{m}" for (n, t, m), _ in SHARES])
def test_tenant_mesh(runs, i):
    ranks, _, _ = runs
    shape = SHARES[i][1]
    got = [r["tenants"][i] for r in ranks]
    if shape is None:
        assert all(g[0] == "ValueError" and "model_parallel=8" in g[1] for g in got), got
        return
    members = shape[0] * shape[1]
    for rank, g in enumerate(got):
        if rank >= members:
            assert g is None
        else:
            names, mesh_shape, coord = g
            assert names == ("data", "model") and mesh_shape == shape
            assert list(coord) == [rank // shape[1], rank % shape[1]]


def _bit_exact(a, b) -> bool:
    return a["step"] == b["step"] and all(np.array_equal(x, y) for k in ("params", "m", "v")
                                          for x, y in zip(a[k], b[k]))


def test_shrink_reshards_bit_for_bit_and_continues_as_one_card(runs):
    ranks, (ref_losses, ref_params), _ = runs
    r0 = ranks[0]["shrinks"][0]
    assert r0["mesh"] == (1, 2) and ranks[1]["shrinks"][0]["mesh"] == (1, 2)
    assert ranks[2]["shrinks"][0] == {"plan": r0["plan"], "mesh": None}  # outside the new mesh
    assert r0["plan"].new_global_batch == 4 and r0["sizes"] == [4] * STEPS_AFTER
    assert _bit_exact(r0["before"], r0["after"])
    assert ranks[1]["shrinks"][0]["losses"] == r0["losses"]
    assert all(abs(a - b) <= 1e-6 * abs(b) for a, b in zip(r0["losses"], ref_losses)), (r0["losses"], ref_losses)
    diff = max(float(np.abs(a - b).max()) for a, b in zip(r0["end"]["params"], ref_params))
    assert diff < 1e-6, diff


def test_jax_elastic_scenario(runs):
    ranks, _, jax_ref = runs
    r0 = ranks[0]["shrinks"][1]
    assert r0["plan"].new_global_batch == jax_ref["plan"].new_global_batch == 4
    assert _bit_exact(r0["before"], r0["after"])
    losses = r0["losses"]
    assert np.isfinite(losses).all() and losses[-1] < losses[STEPS_BEFORE - 1] + 1.0  # the reference's checks
    assert all(abs(a - b) <= 1e-3 * abs(b) for a, b in zip(losses, jax_ref["losses"])), (losses, jax_ref["losses"])
    limit = 2 * sum(jax_ref["lrs"])
    diff = max(float(np.abs(a - b).max()) for a, b in zip(r0["end"]["params"], jax_ref["params"]))
    assert 0 < limit and diff <= limit, (diff, limit)


def test_ranks_import_no_jax(runs):
    ranks, _, _ = runs
    assert not any(r["jax_loaded"] for r in ranks)
