"""The ``"grouped"`` attention layout (``parallel.sharding.attention_layout``)
on the CPU, in one spawn of four gloo ranks at ``(1, 4)``.  The smoke
configs have 4 query heads over 2 kv heads: the query heads split one a
rank, the kv heads do not divide the model axis, so rank r holds every kv
head's ``wk`` / ``wv`` and attends over its GQA group's, ``r // 2``.

* the layout: a rank's ``wq`` / ``wo`` hold one head, ``wk`` / ``wv``
  every kv head, its engine's pools one kv head;
* sharded train steps (remat full, three steps from one state) of
  olmo-1b, olmo-1b with q/k/v biases, olmo-1b under sequence parallelism
  and qwen3-moe (q/k norms, experts over the model axis) in fp32, and of
  olmo-1b with fp8 (the plain GEMM; each rank records the whole wk / wv's
  amax), against the port's one-process steps, within
  ``torch_sharded_parity.close``'s tight and fp8 limits; olmo-1b's four
  fresh steps of 8 x 16 against the JAX package's sharded step on a ``(1,
  4)`` mesh of forced host devices (``tests/jax_sharded_train.py --mesh
  1x4``), as ``check_jax_sharded`` holds the ``(2, 2)`` run;
* sharded evals of olmo-1b and qwen3-moe, with and without sequence
  parallelism, within 1e-6 of one process's loss;
* TP=4 serving of smoke olmo-1b (fp32 pools, K1/K2's plain versions):
  greedy tokens equal to TP=1's and to the JAX engine's, on every rank;
* two controls, each of which must fail the limits its case passes: the
  kv head taken as ``r % KV`` (ranks 1 and 2 attend over the other
  group's head) and the rank's kv head of ``wk`` / ``wv`` sliced without
  ``copy_to_model`` (each rank then keeps its own share of the leaves'
  gradients).
"""

import dataclasses
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import batches, to_torch
from torch_sharded_parity import (
    LR,
    close,
    finish_jax_sharded,
    fresh_case,
    jax_sharded_params,
    leaf_paths,
    passes,
    readings,
    start_jax_sharded,
)

import torch_sharded_ranks
import torch_tp_ranks
from repro.config.model import reduce_for_smoke as jax_reduce
from repro.configs import get_config as jax_get_config
from repro.models import init_params as jax_init_params
from repro.serving import InferenceEngine as JaxEngine
from repro_torch.bridge import params_from_jax
from repro_torch.config import ParallelConfig, PrecisionConfig, RunConfig, TrainConfig, reduce_for_smoke
from repro_torch.configs import get_config
from repro_torch.launch.mesh import run_ranks
from repro_torch.parallel.sharding import attention_layout
from repro_torch.train import init_train_state, loss_fn, make_train_step

torch.set_num_threads(2)

MESH = (1, 4)
B, S = 4, 32
EOS_OUT = 1 << 30  # outside every vocab: requests run to their length
PROMPTS = [[11, 12, 13, 14, 15, 16, 17, 18, 7, 3, 9, 4, 5], [5, 9, 12, 5, 9, 12, 2], [21, 22, 23, 24]]
ENGINE = dict(max_batch=2, max_seq=64, block_size=8, eos_token=EOS_OUT)
# (name, arch, config overrides, sequence parallelism, fp8)
CASES = [("olmo", "olmo-1b", {}, False, False), ("olmo-bias", "olmo-1b", dict(use_bias=True), False, False),
         ("olmo-sp", "olmo-1b", {}, True, False), ("olmo-fp8", "olmo-1b", {}, False, True),
         ("qwen3", "qwen3-moe-235b-a22b", {}, False, False)]
CONTROLS = {name: "olmo" for name in torch_sharded_ranks.GROUPED_CONTROLS}
EVALS = [("olmo-1b", False), ("olmo-1b", True), ("qwen3-moe-235b-a22b", False), ("qwen3-moe-235b-a22b", True)]


def _cfg(arch, **kw):
    cfg = reduce_for_smoke(get_config(arch)).replace(**kw)
    if cfg.moe is not None:  # capacity cannot bind
        cfg = cfg.replace(moe=dataclasses.replace(cfg.moe, capacity_factor=8.0))
    return cfg


def _run(arch, sp=False, fp8=False):
    prec = PrecisionConfig(fp8=True, fp8_gemm="plain") if fp8 else PrecisionConfig(compute_dtype="float32")
    return RunConfig(arch=arch, train=TrainConfig(global_batch=B, seq_len=S, learning_rate=LR, warmup_steps=2,
                                                  total_steps=10),
                     parallel=ParallelConfig(remat="full", sequence_parallel=sp), precision=prec)


def _case(arch, kw, sp, fp8):
    cfg, run = _cfg(arch, **kw), _run(arch, sp, fp8)
    data = [to_torch(b) for b in batches(cfg, 3, seed=1)]
    return {"cfg": cfg, "run": run, "state": init_train_state(cfg, run, 0, "cpu"), "batches": data}


def _one_process(case):
    """The case's steps in one process: (readings, the parameters before)."""
    from torch_sharded_ranks import _numpy_state

    from repro_torch.utils.tree import tree_leaves, tree_map

    state = case["state"]
    before = [t.numpy().copy() for t in tree_leaves(state.params)]
    state = state._replace(params=tree_map(torch.clone, state.params),
                           opt=state.opt._replace(m=tree_map(torch.clone, state.opt.m),
                                                  v=tree_map(torch.clone, state.opt.v)))
    step, metrics = make_train_step(case["cfg"], case["run"]), []
    for b in case["batches"]:
        state, m = step(state, b)
        metrics.append({k: float(v) for k, v in m.items()})
    return readings(metrics, _numpy_state(state)), before


def _jax_engine_tokens(jcfg, jparams) -> list:
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        eng = JaxEngine(jcfg, jparams, cache_dtype=jnp.float32, **ENGINE)
        reqs = [eng.submit(p, max_new_tokens=6) for p in PROMPTS]
        eng.run_until_drained()
    return [list(r.generated) for r in reqs]


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """The references in this process and the JAX sharded step in its own,
    while the four ranks run every case, control, eval and the engine."""
    jcfg = jax_reduce(jax_get_config("olmo-1b"))
    proc, out_path, data = start_jax_sharded("olmo-1b", jcfg, tmp_path_factory.mktemp("grouped"), mesh=MESH)
    try:
        cases = {name: _case(arch, kw, sp, fp8) for name, arch, kw, sp, fp8 in CASES}
        cases["vs_jax"] = fresh_case("olmo-1b", jcfg, reduce_for_smoke(get_config("olmo-1b")), data)
        refs = {name: _one_process(cases[name]) for name, *_ in CASES}
        evals, eval_refs = [], []
        for arch, sp in EVALS:
            cfg = _cfg(arch)
            params = init_train_state(cfg, _run(arch), 2, "cpu").params
            batch = to_torch(batches(cfg, 1, seed=3)[0])
            evals.append((cfg, params, batch, sp))
            with torch.no_grad():
                eval_refs.append(float(loss_fn(cfg, params, batch)[0]))
        jparams = jax_init_params(jcfg, jax.random.PRNGKey(0), jnp.float32)
        tcfg = reduce_for_smoke(get_config("olmo-1b"))
        tparams = params_from_jax(tcfg, jax.tree.map(np.asarray, jparams), device="cpu")
        serve_case = {"cfg": tcfg, "params": tparams, "prompts": PROMPTS, "submit": [dict(max_new_tokens=6)] * 3,
                      "engine": dict(ENGINE, cache_dtype=torch.float32, attn_impl="kernel")}
        serve_ref = torch_tp_ranks.serve(tcfg, tparams, serve_case)
        serve_ref["jax"] = _jax_engine_tokens(jcfg, jparams)
        ordered = [cases[name] for name, *_ in CASES] + [cases["vs_jax"]]
        controls = {c: cases[name] for c, name in CONTROLS.items()}
        ranks = run_ranks(torch_sharded_ranks.grouped_checks, MESH, device="cpu", timeout_s=300,
                          args=(ordered, controls, evals, {"cfg": tcfg, "params": tparams, "case": serve_case}))
        jout = finish_jax_sharded(proc, out_path)
    finally:
        if proc.poll() is None:
            proc.kill()
    return {"cases": cases, "refs": refs, "eval_refs": eval_refs, "serve_ref": serve_ref, "ranks": ranks,
            "jout": jout}


def _got(world, i):
    r0 = world["ranks"][0]["train"][i]
    return readings(r0["metrics"], r0["state"])


def test_layout_of_a_rank(world):
    cfg = reduce_for_smoke(get_config("olmo-1b"))
    assert attention_layout(type("M", (), {"shape": {"data": 1, "model": 4}})(), cfg.num_heads,
                            cfg.num_kv_heads) == ("grouped", 1)
    D, hd = cfg.d_model, cfg.head_dim
    for r in world["ranks"]:
        assert r["shapes"] == {"wq": (D, 1, hd), "wk": (D, 2, hd), "wv": (D, 2, hd), "wo": (1, hd, D)}
        pool = r["serve"]["pool_shapes"]["k"]
        assert pool[3] == 1 and r["serve"]["stats"]["kv_heads_per_rank"] == 1
        assert r["jax_loaded"] is False
        assert not [w for w in r["serve"]["warnings"] if "head counts" in w]  # no replicated heads


@pytest.mark.parametrize("i,name", list(enumerate(name for name, *_ in CASES)))
def test_train_step_against_one_process(world, i, name):
    ranks = world["ranks"]
    assert all(r["train"][i]["metrics"] == ranks[0]["train"][i]["metrics"] for r in ranks), "ranks disagree"
    case, (ref, before) = world["cases"][name], world["refs"][name]
    kind = "fp8" if case["run"].precision.fp8 else "tight"
    r = close(_got(world, i), ref, before, case["cfg"], kind, leaf_paths(case["state"].params))
    assert passes(r), f"{name}: {r}"
    if name == "olmo-sp":
        assert ranks[0]["train"][i]["collectives"]["gather_seq"] > 0


def test_train_step_against_the_jax_sharded_step(world):
    """Four fresh fp32 steps at (1, 4) against the JAX package's sharded
    step on the same mesh shape: losses 1e-6 relative, gradient norms 1e-5,
    parameters 1e-6 absolute; the JAX run splits ``wq`` over ``"model"``
    too."""
    got, jout = _got(world, len(CASES)), world["jout"]
    n = len(got["loss"])
    for k, lim in (("loss", 1e-6), ("grad_norm", 1e-5)):
        ref = [float(jout[f"{k}_{i}"]) for i in range(n)]
        assert all(abs(a - b) <= lim * abs(b) for a, b in zip(got[k], ref)), (k, got[k], ref)
    cfg = world["cases"]["vs_jax"]["cfg"]
    paths = leaf_paths(world["cases"]["vs_jax"]["state"].params)
    for path, a, b in zip(paths, got["params"], jax_sharded_params(cfg, jout)):
        assert float(np.abs(a - b).max()) < 1e-6, (path, float(np.abs(a - b).max()))
    assert "model" in str(jout["spec_wq"])


@pytest.mark.parametrize("control", list(CONTROLS))
def test_control_fails(world, control):
    i = len(CASES) + 1 + list(CONTROLS).index(control)
    case, (ref, before) = world["cases"][CONTROLS[control]], world["refs"][CONTROLS[control]]
    r = close(_got(world, i), ref, before, case["cfg"], "tight", leaf_paths(case["state"].params))
    assert not passes(r), f"{control} passes the limits: {r}"


@pytest.mark.parametrize("i", range(len(EVALS)), ids=[f"{a}-{'sp' if sp else 'tp'}" for a, sp in EVALS])
def test_sharded_eval(world, i):
    ref = world["eval_refs"][i]
    for r in world["ranks"]:
        assert abs(r["evals"][i] - ref) <= 1e-6 * abs(ref), (r["evals"][i], ref)


def test_tp4_serving_equals_tp1_and_the_jax_engine(world):
    ref = world["serve_ref"]
    assert ref["tokens"] == ref["jax"]
    assert ref["pool_shapes"]["k"][3] == 2
    for r in world["ranks"]:
        assert r["serve"]["tokens"] == ref["tokens"] and r["serve"]["reasons"] == ref["reasons"]
        assert r["serve"]["stats"]["cache_bytes"] == ref["stats"]["cache_bytes"]
