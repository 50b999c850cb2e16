"""Sequence parallelism in the port's sharded training and sharded evals,
over gloo ranks on the CPU.

With ``ParallelConfig(sequence_parallel=True)`` the residual stream between
the sublayers is each model rank's contiguous slice ``(B, S / tp, D)`` of
the sequence, as the JAX package's rule engine lays out ``("batch", "seq",
"embed")``: each sublayer gathers its input over seq (``gather_seq``) and
reduce-scatters its output (``reduce_scatter_seq``).

* The sequence collectives on two ranks, forward and backward, against
  closed forms on integer inputs (every sum exact), with the collectives
  each issues: ``gather_seq`` (all-gather, reduce-scatter backward),
  ``SeqGather``'s ``whole()`` view (all-gather, this rank's slice of the
  gradient backward), ``reduce_scatter_seq`` (reduce-scatter, all-gather
  backward) and ``scatter_seq`` (this rank's slice, all-gather backward).
* ``parallel.sharding.seq_split`` follows the act rules' divisibility: a
  sequence the model axis does not divide runs unsplit, a step at S = 31
  on ``(1, 2)`` issues no sequence collective and equals the sharded step
  without sequence parallelism bit for bit.
* The dense family with sequence parallelism at ``(1, 2)`` and ``(2, 2)``:
  smoke olmo-1b and the dense variant (q/k norms, every bias, RMS norms
  with scales, an untied head) from the seed's state, 3 steps of 4 x 32
  (warmup 2), in fp32, fp32 in two microbatches, fp8 (K4's plain version
  on the CPU) and bf16 without remat.  Each is held to the port's
  one-process step and to the port's sharded step without sequence
  parallelism on the same mesh, under ``torch_sharded_parity``'s limits
  of its precision; at ``(2, 2)`` four fresh fp32 steps of 8 x 16 are held
  to the JAX package's sharded step with sequence parallelism
  (``tests/jax_sharded_train.py --sequence-parallel``) under the tight
  limits.
* Two controls must fail the limits their case passes against the
  one-process step: a norm's scale and bias on the seq slice without
  their ``copy_to_model`` (the variant, whose RMS norms have scales; each
  rank's gradient of them is then its positions' share), and
  ``reduce_scatter_seq`` as a plain slice of this rank's partial output.
  (The whole branch's control, the rwkv6 time mix's leaves unsummed,
  runs in ``test_torch_sharded_ssm.py``'s spawn.)
* Sharded evals with sequence parallelism at ``(1, 2)``, fp32, for smoke
  olmo-1b, qwen3-moe, hymba, hubert, rwkv6-7b and llama-3.2-vision (gates
  open): the attention through ``attn_impl="flash"`` and the WKV scan
  through ``wkv_impl="kernel"``, whose wrappers take their plain versions
  on CPU tensors, against the one-rank eval of the same impls.
"""

import dataclasses

import numpy as np
import pytest
import torch

import torch_sharded_parity as P
import torch_sharded_ranks as R
from repro.config.model import reduce_for_smoke as jax_reduce
from repro.configs import get_config as jax_get_config
from repro_torch.config import ParallelConfig, PrecisionConfig, RunConfig, TrainConfig, reduce_for_smoke
from repro_torch.configs import get_config
from repro_torch.data import make_batch_fn
from repro_torch.launch.mesh import MeshShape, run_ranks
from repro_torch.parallel.sharding import seq_split
from repro_torch.train import init_train_state, loss_fn, make_train_step
from repro_torch.utils.tree import tree_leaves, tree_map

torch.set_num_threads(2)

B, S, LR = P.B, P.S, P.LR
ODD_S = 31  # a sequence the model axis of 2 does not divide
VARIANT = dict(qk_norm=True, use_bias=True, norm="rmsnorm", tie_embeddings=False)
# name, variant?, precision, parallel
CASES = [
    ("fp32", False, {"compute_dtype": "float32"}, {"remat": "full"}),
    ("variant-fp32-mb2", True, {"compute_dtype": "float32"}, {"remat": "full", "num_microbatches": 2}),
    ("fp8", False, {"fp8": True}, {"remat": "full"}),
    ("variant-bf16-noremat", True, {}, {"remat": "none"}),
]
NAMES = [c[0] for c in CASES]
# control -> the case it runs at (1, 2)
CONTROLS = {"sp_norm_scale_sum_dropped": "variant-fp32-mb2", "sp_reduce_scatter_unsummed": "fp32"}
assert set(CONTROLS) == set(R.SP_CONTROLS)
EVAL_ARCHS = ("olmo-1b", "qwen3-moe-235b-a22b", "hymba-1.5b", "hubert-xlarge", "rwkv6-7b", "llama-3.2-vision-90b")
EVAL_KW = {"attn_impl": "flash", "wkv_impl": "kernel", "compute_dtype": torch.float32}
EVAL_REL = 1e-6  # the tight loss limit: one function, sums in another order


def _cfg(variant: bool):
    cfg = reduce_for_smoke(get_config("olmo-1b"))
    return cfg.replace(**VARIANT) if variant else cfg


def _batches(n, seed=0, batch=B, seq=S):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        tok = rng.integers(0, 256, (batch, seq)).astype(np.int32)
        out.append({"tokens": torch.from_numpy(tok), "labels": torch.from_numpy(np.roll(tok, -1, axis=1))})
    return out


def _case(variant, prec, par, sp, seq=S) -> dict:
    cfg = _cfg(variant)
    run = RunConfig(arch="olmo-1b", train=TrainConfig(global_batch=B, seq_len=seq, learning_rate=LR, warmup_steps=2,
                                                      total_steps=10),
                    parallel=ParallelConfig(sequence_parallel=sp, **par), precision=PrecisionConfig(**prec))
    return {"cfg": cfg, "run": run, "state": init_train_state(cfg, run, 0, device="cpu"),
            "batches": _batches(3, seq=seq)}


def _one_process(case) -> dict:
    """The port's one-process steps of ``case`` (on copies of its state)."""
    st = case["state"]
    copy = lambda tree: tree_map(torch.clone, tree)  # noqa: E731  (the step updates in place)
    st = st._replace(params=copy(st.params), opt=st.opt._replace(m=copy(st.opt.m), v=copy(st.opt.v)))
    step = make_train_step(case["cfg"], case["run"])
    metrics = []
    for b in case["batches"]:
        st, m = step(st, b)
        metrics.append({k: float(v) for k, v in m.items()})
    return P.readings(metrics, R._numpy_state(st))


def _eval_input(arch):
    """(cfg, full fp32 parameters, a 2 x 32 batch) of an eval case."""
    cfg = reduce_for_smoke(get_config(arch))
    if cfg.moe is not None:
        cfg = cfg.replace(moe=dataclasses.replace(cfg.moe, capacity_factor=cfg.moe.num_experts / cfg.moe.top_k))
    run = RunConfig(arch=arch, train=TrainConfig(global_batch=2, seq_len=S))
    params = init_train_state(cfg, run, 0, device="cpu").params
    for group in params["blocks"] if cfg.family == "vlm" else ():
        group["cross"]["attn"]["gate"].fill_(1.0)
        group["cross"]["gate_mlp"].fill_(1.0)
    return cfg, params, make_batch_fn(cfg, global_batch=2, seq_len=S, seed=0, device="cpu")(0)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    jcfg, tcfg = jax_reduce(jax_get_config("olmo-1b")), _cfg(False)
    proc, out_path, jax_batches = P.start_jax_sharded("olmo-1b", jcfg, tmp_path_factory.mktemp("jax_sp"),
                                                      data=[{k: v.numpy() for k, v in b.items()}
                                                            for b in _batches(4, seed=5, batch=8, seq=16)],
                                                      sequence_parallel=True)
    try:
        sp = {name: _case(v, prec, par, True) for name, v, prec, par in CASES}
        tp = {name: _case(v, prec, par, False) for name, v, prec, par in CASES}
        refs = {name: _one_process(sp[name]) for name in NAMES}
        befores = {name: [t.numpy().copy() for t in tree_leaves(sp[name]["state"].params)] for name in NAMES}
        odd = {"sp": _case(False, {"compute_dtype": "float32"}, {"remat": "full"}, True, seq=ODD_S)}
        odd["tp"] = dict(odd["sp"], run=dataclasses.replace(odd["sp"]["run"], parallel=ParallelConfig(remat="full")))
        refs["odd"] = _one_process(odd["sp"])
        vs_jax = P.with_sp(P.fresh_case("olmo-1b", jcfg, tcfg, jax_batches))
        evals = {arch: _eval_input(arch) for arch in EVAL_ARCHS}
        one_rank = {}
        with torch.no_grad():
            for arch, (cfg, params, batch) in evals.items():
                one_rank[arch] = float(loss_fn(cfg, params, batch, **EVAL_KW)[0])
        ranks, index = {}, {}
        for mesh in P.SP_MESHES:
            todo = [(f"sp/{n}", sp[n]) for n in NAMES] + [(f"tp/{n}", tp[n]) for n in NAMES]
            todo += [("odd/sp", odd["sp"]), ("odd/tp", odd["tp"])] if mesh == (1, 2) else [("vs_jax", vs_jax)]
            controls = {c: sp[name] for c, name in CONTROLS.items()} if mesh == (1, 2) else {}
            keys = [k for k, _ in todo] + list(controls)
            ev = [(cfg, params, batch, EVAL_KW) for cfg, params, batch in evals.values()] if mesh == (1, 2) else []
            keys += [f"eval/{a}" for a in EVAL_ARCHS] if ev else []
            index[mesh] = {k: i for i, k in enumerate(keys)}
            ranks[mesh] = run_ranks(R.train_cases, mesh, device="cpu", timeout_s=300,
                                    args=([c for _, c in todo], controls, None, None, (), ev))
        collective_ranks = run_ranks(R.seq_primitives, (1, 2), device="cpu", timeout_s=120)
        jout_sp = P.finish_jax_sharded(proc, out_path)
    finally:
        if proc.poll() is None:
            proc.kill()
    return {"ranks": ranks, "index": index, "refs": refs, "befores": befores, "jout_sp": jout_sp,
            "paths": {n: P.leaf_paths(sp[n]["state"].params) for n in NAMES}, "one_rank": one_rank,
            "collectives": collective_ranks, "cfg": tcfg, "vs_jax_paths": P.leaf_paths(vs_jax["state"].params)}


def _got(runs, mesh, key) -> dict:
    r = runs["ranks"][mesh][0][runs["index"][mesh][key]]
    return P.readings(r["metrics"], r["state"])


def _close(runs, got, ref, name) -> dict:
    _, variant, prec, par = CASES[NAMES.index(name)]
    return P.close(got, ref, runs["befores"][name], _cfg(variant), P.kind_of(prec, par), runs["paths"][name])


def _closed_form(name: str):
    """Each rank's (output, input gradient) of collective ``name`` from
    both ranks' ``seq_inputs``."""
    (x0, g0), (x1, g1) = (R.seq_inputs(name, r) for r in range(R.SEQ_N))
    sl = R.SEQ_SL
    own = lambda t, r: t[:, r * sl:(r + 1) * sl]  # noqa: E731
    if name == "gather_seq":
        return [(torch.cat([x0, x1], 1), own(g0 + g1, r)) for r in range(2)]
    if name == "whole_seq":
        return [(torch.cat([x0, x1], 1), own(g, r)) for r, g in enumerate((g0, g1))]
    if name == "reduce_scatter_seq":
        return [(own(x0 + x1, r), torch.cat([g0, g1], 1)) for r in range(2)]
    return [(own(x, r), torch.cat([g0, g1], 1)) for r, x in enumerate((x0, x1))]  # scatter_seq


@pytest.mark.parametrize("name", ["gather_seq", "whole_seq", "reduce_scatter_seq", "scatter_seq"])
def test_sequence_collectives_match_their_closed_forms(runs, name):
    """Forward and backward on each of two ranks equal the closed forms
    exactly (``whole_seq``: ``SeqGather``'s ``whole()`` view, whose
    backward keeps this rank's slice), and each counts the collectives it
    issues (all-gathers of the slice's bytes, reduce-scatters of the whole
    sequence's)."""
    slice_bytes = R.SEQ_B * R.SEQ_SL * R.SEQ_D * 4
    gather = {"gather_seq": 1, "gather_seq_bytes": slice_bytes}
    scatter = {"reduce_scatter_seq": 1, "reduce_scatter_seq_bytes": 2 * slice_bytes}
    want = {"gather_seq": gather | scatter, "whole_seq": gather, "reduce_scatter_seq": gather | scatter,
            "scatter_seq": gather}[name]
    for rank, (y, g) in enumerate(_closed_form(name)):
        got = runs["collectives"][rank][name]
        np.testing.assert_array_equal(got["y"], y.numpy())
        np.testing.assert_array_equal(got["grad"], g.numpy())
        assert got["collectives"] == want, got["collectives"]


def test_seq_split_follows_the_act_rules():
    """The residual stream splits where the act rule of "seq" claims the
    model axis: sequence parallelism on, a model axis of more than one
    rank, and a sequence it divides (the rule engine's divisibility)."""
    m22, m14, m21 = (MeshShape({"data": d, "model": t}) for d, t in ((2, 2), (1, 4), (2, 1)))
    assert seq_split(m22, (4, 32, 64), True) and seq_split(m14, (4, 8, 64), True)
    assert not seq_split(m22, (4, ODD_S, 64), True) and not seq_split(m14, (4, 6, 64), True)
    assert not seq_split(m22, (4, 32, 64), False) and not seq_split(m21, (4, 32, 64), True)
    assert not seq_split(None, (4, 32, 64), True)


def test_indivisible_sequence_runs_unsplit(runs):
    """S = 31 on (1, 2) with sequence parallelism: no sequence collective,
    the sharded step without it bit for bit, and the one-process step
    within the tight limits."""
    ranks, index = runs["ranks"][(1, 2)], runs["index"][(1, 2)]
    sp, tp = ranks[0][index["odd/sp"]], ranks[0][index["odd/tp"]]
    assert "gather_seq" not in sp["collectives"] and sp["collectives"] == tp["collectives"]
    assert sp["metrics"] == tp["metrics"]
    assert all(np.array_equal(a, b) for a, b in zip(sp["state"]["params"], tp["state"]["params"]))
    got = P.readings(sp["metrics"], sp["state"])
    r = _close(runs, got, runs["refs"]["odd"], "fp32")
    assert P.passes(r), r


@pytest.mark.parametrize("mesh", P.SP_MESHES, ids=lambda m: f"{m[0]}x{m[1]}")
@pytest.mark.parametrize("name", NAMES)
def test_sp_step_matches_the_one_process_step(runs, name, mesh):
    """Loss, gradient norm, fp8 state and every gathered parameter after
    three steps within the case's limits of the port's one-process step;
    every rank reads the same metrics."""
    ranks, i = runs["ranks"][mesh], runs["index"][mesh][f"sp/{name}"]
    assert P.ranks_agree(ranks, i), "ranks disagree"
    r = _close(runs, _got(runs, mesh, f"sp/{name}"), runs["refs"][name], name)
    assert P.passes(r), f"{name} at {mesh}: {r}"


@pytest.mark.parametrize("mesh", P.SP_MESHES, ids=lambda m: f"{m[0]}x{m[1]}")
@pytest.mark.parametrize("name", NAMES)
def test_sp_step_matches_the_sharded_step_without_it(runs, name, mesh):
    """The same steps against the sharded step without sequence
    parallelism on the same mesh, within the same limits; the sequence
    collectives take the place of the row-parallel products' all-reduces
    (only the vocab-parallel cross-entropy keeps ``sum_over_model``)."""
    sp = runs["ranks"][mesh][0][runs["index"][mesh][f"sp/{name}"]]
    tp = runs["ranks"][mesh][0][runs["index"][mesh][f"tp/{name}"]]
    r = _close(runs, _got(runs, mesh, f"sp/{name}"), _got(runs, mesh, f"tp/{name}"), name)
    assert P.passes(r), f"{name} at {mesh}: {r}"
    c_sp, c_tp = sp["collectives"], tp["collectives"]
    assert c_sp["gather_seq"] > 0 and c_sp["reduce_scatter_seq"] > 0 and "gather_seq" not in c_tp
    microbatches = CASES[NAMES.index(name)][3].get("num_microbatches", 1)
    assert c_sp["sum_over_model"] == 2 * 3 * microbatches < c_tp["sum_over_model"], (c_sp, c_tp)


def test_sp_matches_the_jax_sharded_step(runs):
    """The port at (2, 2) with sequence parallelism against the JAX
    package's sharded step with ``sequence_parallel=True``: four fresh fp32
    steps of 8 x 16, the tight limits."""
    P.check_jax_sharded({"ranks": runs["ranks"], "index": {(2, 2): {"vs_jax_sp": runs["index"][(2, 2)]["vs_jax"]}},
                         "jout_sp": runs["jout_sp"], "cfg": runs["cfg"], "paths": runs["vs_jax_paths"]}, sp=True)


@pytest.mark.parametrize("control", list(CONTROLS))
def test_controls_fail_the_limits(runs, control):
    """Each control keeps the steps running but must fail the limits its
    case passes against the one-process step."""
    name = CONTROLS[control]
    r = _close(runs, _got(runs, (1, 2), control), runs["refs"][name], name)
    assert not P.passes(r), f"{control} passes the limits: {r}"


@pytest.mark.parametrize("arch", EVAL_ARCHS)
def test_sp_eval_matches_the_one_rank_eval(runs, arch):
    """The sharded eval with sequence parallelism (the attention at the
    local heads, or whole in hymba, over the gathered sequence; rwkv6's
    whole time mix on each rank) against the one-rank eval, on both
    ranks."""
    evals = [r[runs["index"][(1, 2)][f"eval/{arch}"]]["loss"] for r in runs["ranks"][(1, 2)]]
    one = runs["one_rank"][arch]
    assert evals[0] == evals[1], evals
    assert abs(evals[0] - one) <= EVAL_REL * abs(one), (evals, one)


def test_ranks_import_no_jax(runs):
    assert not any(r[-1]["jax_loaded"] for m in P.SP_MESHES for r in runs["ranks"][m])
