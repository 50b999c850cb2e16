"""Shared helpers of the sharded-training parity tests of the moe, hybrid,
audio, ssm and vlm families (``test_torch_sharded_{moe,hybrid,audio,ssm,vlm}.py``),
on the pattern of ``test_torch_sharded_train.py`` (the dense family).

A case starts from one state: the JAX package initialises and takes one
step (so the AdamW moments, the step counter and the fp8 amax history are
mid-training), ``bridge.train_state_from_jax`` copies it into the port,
and three more steps follow on the same numpy batches (``torch_parity``'s:
tokens, or frames for audio, random labels and, for vlm, image tokens;
warmup 2, so the parameters move) in the JAX package, in the port on one process, and in
the port on the ranks of each mesh (``torch_sharded_ranks.train_cases``,
one spawn a mesh for every case and control of a file).  The ranks gather
the state back (``unshard_state``) and rank 0 returns it.  A vlm case opens
every cross layer's gates (``gates``) in the JAX state before its first
step, and the JAX sharded run after its initialisation: random init leaves
them at 0, which makes the cross layers the identity.

Limits (``close``), from ``test_torch_train.py``'s tight and loose ones:

* ``"tight"`` (fp32 compute): the same functions with sums in another
  order.  Losses and aux losses 1e-6 relative, gradient norms 1e-5,
  parameters 1e-6 absolute; a key bias's gradient is rounding noise
  (softmax cancels it), which AdamW normalises into moves of up to lr a
  step, so it is held to 2 lr a step;
* ``"loose"`` (bf16 compute) and ``"fp8"``: the two frameworks, and the
  sharded and unsharded steps, round at other places.  Losses and aux
  losses 1e-3 relative (2e-3 with fp8), gradient norms 5e-2, every
  parameter 2 lr a step, their mean lr / 10 (lr / 5 with fp8), the fp8
  scales and amax history 0.1 relative;
* the ssm family's bf16 gradient norms: 1e-1 (``LOOSE_GRAD_NORM``).  The
  norm is the token table's gradient (20.0 of 20.5 on the smoke rwkv6-7b),
  which ``norm1`` of the 0.02-scale embeddings amplifies about 50-fold, so
  one more bf16 rounding moves it.  The JAX package's own tensor-parallel
  split does: its (1, 2) step moves the smoke model's step-1 bf16 norm by
  +1.0%, -2.8%, -2.1% and -9.2% of its unsharded step's on four batches
  (-9.9% at (1, 4)), its fp32 norm by 3.5e-4 at most and its (2, 1) step
  neither (``tests/bf16_split_probe.py --jax``); the port's split in one
  process moves it by 2.2% (``port_rows``), and the JAX package's
  unsharded step parts from the port's by up to 7.3% on other seeds'
  batches;
* ``"int8"`` (int8 gradient compression in fp32 compute): a code whose
  gradient lies within rounding of a half step takes its neighbour,
  moving that element by one quantum for a step.  Losses as tight,
  gradient norms 1e-4, the mean parameter difference under lr / 1000 and
  at most 1 in 1000 elements beyond 1e-6.

Every reading but ``moved`` (the parameters' mean move, which must exceed
lr / 2) must stay within its limit; a control must fail one.

Sequence parallelism (``run_family(sp_of=)``): a case of ``sp_of`` runs
again with ``ParallelConfig(sequence_parallel=True)`` at ``(1, 2)`` and
``(2, 2)`` (at ``(2, 1)`` the model axis is 1 and nothing splits), in the
same spawns, held to the same references as its case and to its case's
sharded run on the same mesh (``check_sp_step``); ``jax_sp=True`` also runs
the JAX package's sharded step with sequence parallelism at ``(2, 2)``
(``check_jax_sharded(runs, sp=True)``).
"""

import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import torch
from jax_sharded_train import open_gates
from torch_parity import batches, to_jax, to_torch

import torch_sharded_ranks
from repro.config import ParallelConfig as JaxParallelConfig
from repro.config import PrecisionConfig as JaxPrecisionConfig
from repro.config import RunConfig as JaxRunConfig
from repro.config import TrainConfig as JaxTrainConfig
from repro.train.step import init_train_state as jax_init_train_state
from repro.train.step import make_train_step as jax_make_train_step
from repro_torch.bridge import params_from_jax, train_state_from_jax
from repro_torch.config import ParallelConfig, PrecisionConfig, RunConfig, TrainConfig
from repro_torch.launch.mesh import run_ranks
from repro_torch.train import make_train_step
from repro_torch.utils.tree import tree_leaves, tree_paths

ROOT = Path(__file__).resolve().parents[1]
B, S, LR = 4, 32, 1e-3
MESHES = [(1, 2), (2, 1), (2, 2)]
# the meshes a sequence-parallel case runs on: those whose model axis splits
SP_MESHES = [(1, 2), (2, 2)]
# the bf16 and fp8 gradient-norm limit of a family whose norm one rounding moves (module docstring)
LOOSE_GRAD_NORM = {"ssm": 1e-1}
# the run against the JAX package's sharded step: fresh states, 8 x 16, fp32
SHARDED_B, SHARDED_S = 8, 16


def _train(**kw):
    return dict(global_batch=kw.get("batch", B), seq_len=kw.get("seq", S), learning_rate=LR, warmup_steps=2,
                total_steps=10)


def np_tree(state):
    return jax.tree.map(np.asarray, state)


def readings(metrics, state_np) -> dict:
    return {k: [m[k] for m in metrics] for k in ("loss", "aux_loss", "grad_norm")} | state_np


def port_tuples(np_state):
    """A numpy JAX train state in the port's NamedTuples (the ranks must not
    unpickle the JAX package's classes)."""
    from repro_torch.fp8 import Fp8State
    from repro_torch.optim import AdamWState
    from repro_torch.train import TrainState

    f, o = np_state.fp8, np_state.opt
    fp8 = None if f is None else Fp8State(amax_history=dict(f.amax_history), scale=dict(f.scale), step=f.step)
    return TrainState(params=np_state.params, opt=AdamWState(step=o.step, m=o.m, v=o.v),
                      compress_residual=np_state.compress_residual, fp8=fp8)


def make_case(arch, jcfg, tcfg, prec: dict, par: dict, seed=0, data=None, gates=None):
    """One case: (JAX readings, the port's unsharded readings, the case for
    the ranks, the parameters before the three steps, the numpy JAX state
    they start from).  ``prec`` is the port's ``PrecisionConfig``
    overrides; fp8 runs the JAX package's ``"pallas"`` GEMM.  ``data``:
    the four numpy batches (default ``torch_parity.batches``); ``gates``:
    the value the vlm cross layers' gates take before the first step."""
    jprec = dict(prec, fp8_gemm="pallas") if prec.get("fp8") else prec
    jrun = JaxRunConfig(arch=arch, train=JaxTrainConfig(**_train()), parallel=JaxParallelConfig(**par),
                        precision=JaxPrecisionConfig(**jprec))
    trun = RunConfig(arch=arch, train=TrainConfig(**_train()), parallel=ParallelConfig(**par),
                     precision=PrecisionConfig(**prec))
    data = batches(jcfg, 4, seed=seed) if data is None else data
    jstate = jax_init_train_state(jcfg, jrun, jax.random.PRNGKey(seed))
    if gates is not None:
        jstate = open_gates(jstate, gates)
    jstep = jax.jit(jax_make_train_step(jcfg, jrun))
    jstate, _ = jstep(jstate, to_jax(data[0]))
    start_np = np_tree(jstate)
    jm = []
    for b in data[1:]:
        jstate, m = jstep(jstate, to_jax(b))
        jm.append({k: float(v) for k, v in m.items()})
    jax_ref = readings(jm, torch_sharded_ranks._numpy_state(train_state_from_jax(tcfg, np_tree(jstate), "cpu")))
    local = train_state_from_jax(tcfg, start_np, device="cpu")
    step = make_train_step(tcfg, trun)
    tm = []
    for b in data[1:]:
        local, m = step(local, to_torch(b))
        tm.append({k: float(v) for k, v in m.items()})
    port_ref = readings(tm, torch_sharded_ranks._numpy_state(local))
    state = train_state_from_jax(tcfg, start_np, device="cpu")
    case = {"cfg": tcfg, "run": trun, "state": state, "batches": [to_torch(b) for b in data[1:]]}
    before = [t.numpy().copy() for t in tree_leaves(state.params)]
    return jax_ref, port_ref, case, before, start_np


def start_jax_sharded(arch, jcfg, tmp: Path, data=None, gates=None, sequence_parallel=False, mesh=(2, 2)):
    """Start the JAX package's sharded step on a ``mesh`` (default (2, 2))
    of four forced host devices in a process of its own
    (``tests/jax_sharded_train.py --arch``, ``--open-gates`` with
    ``gates``, ``--sequence-parallel``, ``--mesh``) on ``data`` (default:
    ``torch_parity.batches`` of 8 x 16); returns (the process, its output
    file, the batches)."""
    data = batches(jcfg, 4, seed=5, batch=SHARDED_B, seq=SHARDED_S) if data is None else data
    tag = ("_sp" if sequence_parallel else "") + ("" if mesh == (2, 2) else f"_{mesh[0]}x{mesh[1]}")
    np.savez(tmp / f"batches{tag}.npz", **{f"{k}_{i}": b[k] for i, b in enumerate(data) for k in b})
    env = dict(os.environ, XLA_FLAGS="--xla_force_host_platform_device_count=4", JAX_PLATFORMS="cpu",
               PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.Popen([sys.executable, str(ROOT / "tests" / "jax_sharded_train.py"),
                             str(tmp / f"batches{tag}.npz"), str(tmp / f"out{tag}.npz"), "--arch", arch]
                            + ([] if gates is None else ["--open-gates", str(gates)])
                            + (["--sequence-parallel"] if sequence_parallel else [])
                            + ["--mesh", f"{mesh[0]}x{mesh[1]}"],
                            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
    return proc, tmp / f"out{tag}.npz", data


def with_sp(case: dict) -> dict:
    """``case`` with ``ParallelConfig(sequence_parallel=True)``."""
    run = case["run"]
    return dict(case, run=dataclasses.replace(run, parallel=dataclasses.replace(run.parallel, sequence_parallel=True)))


def fresh_case(arch, jcfg, tcfg, data, gates=None):
    """The port's case of the run against the JAX sharded step: the fresh
    JAX initialisation (its gates set to ``gates``) bridged, fp32, remat
    full, the sharded run's batches."""
    tr = _train(batch=SHARDED_B, seq=SHARDED_S)
    jrun = JaxRunConfig(arch=arch, train=JaxTrainConfig(**tr), parallel=JaxParallelConfig(remat="full"),
                        precision=JaxPrecisionConfig(compute_dtype="float32"))
    trun = RunConfig(arch=arch, train=TrainConfig(**tr), parallel=ParallelConfig(remat="full"),
                     precision=PrecisionConfig(compute_dtype="float32"))
    fresh = jax_init_train_state(jcfg, jrun, jax.random.PRNGKey(0))
    if gates is not None:
        fresh = open_gates(fresh, gates)
    fresh = train_state_from_jax(tcfg, np_tree(fresh), "cpu")
    return {"cfg": tcfg, "run": trun, "state": fresh, "batches": [to_torch(b) for b in data]}


def finish_jax_sharded(proc, out_path) -> dict:
    out, _ = proc.communicate(timeout=300)
    assert proc.returncode == 0, out.decode()[-3000:]
    return dict(np.load(out_path))


def jax_sharded_params(tcfg, jout) -> list:
    """The JAX sharded run's final parameters as the port's leaves."""
    tree = {}
    for k, v in jout.items():
        if k.startswith("param/"):
            node = tree
            *head, last = k.split("/")[1:]
            for h in head:
                node = node.setdefault(h, {})
            node[last] = v
    return [t.numpy() for t in tree_leaves(params_from_jax(tcfg, tree, device="cpu"))]


def close(got, ref, before, cfg, kind, paths) -> dict:
    """``{reading: (value, limit)}`` of ``got`` against ``ref`` under the
    module docstring's limits (``kind``: "tight", "loose" or "fp8");
    ``paths``: the parameters' paths in the order of their leaves (a
    bridged state's, whose dict keys are sorted)."""
    tight = kind in ("tight", "int8")
    rel_loss = 1e-6 if tight else (2e-3 if kind == "fp8" else 1e-3)
    rel_norm = {"tight": 1e-5, "int8": 1e-4}.get(kind, LOOSE_GRAD_NORM.get(cfg.family, 5e-2))
    rel = lambda a, b: max(abs(x - y) / max(abs(y), 1e-30) for x, y in zip(a, b))  # noqa: E731
    out = {"loss": (rel(got["loss"], ref["loss"]), rel_loss),
           "grad_norm": (rel(got["grad_norm"], ref["grad_norm"]), rel_norm)}
    if cfg.family == "moe":
        out["aux_loss"] = (rel(got["aux_loss"], ref["aux_loss"]), rel_loss)
    else:
        out["aux_loss"] = (max(abs(a - b) for a, b in zip(got["aux_loss"], ref["aux_loss"])), 1e-12)  # 0
    diff = np.concatenate([np.abs(a - b).ravel() for a, b in zip(got["params"], ref["params"])])
    steps = len(ref["loss"])
    if kind == "tight":
        key_bias = np.concatenate([np.full(a.size, p.endswith("/bk")) for p, a in zip(paths, got["params"])])
        out["param_max"] = (float(diff[~key_bias].max()), 1e-6)
        out["key_bias_max"] = (float(diff[key_bias].max(initial=0)), 2 * LR * steps)
    elif kind == "int8":
        out["param_mean"] = (float(diff.mean()), LR / 1000)
        out["share_beyond_1e-6"] = (float((diff > 1e-6).mean()), 1e-3)
    else:
        out["param_max"] = (float(diff.max()), 2 * LR * steps)
        out["param_mean"] = (float(diff.mean()), LR / 5 if kind == "fp8" else LR / 10)
    if "fp8_scale" in ref:
        out["fp8_rel"] = (max(float(np.max(np.abs(got[f][k] - ref[f][k]) / np.maximum(np.abs(ref[f][k]), 1e-30)))
                              for f in ("fp8_scale", "fp8_history") for k in ref[f]), 0.1)
    moved = np.concatenate([np.abs(a - b).ravel() for a, b in zip(got["params"], before)])
    out["moved"] = (float(moved.mean()), LR / 2)
    return out


def leaf_paths(tree) -> list[str]:
    return ["/".join(map(str, p)) for p in tree_paths(tree)]


def passes(r: dict) -> bool:
    return all((v > lim) if k == "moved" else (v <= lim) for k, (v, lim) in r.items())


def kind_of(prec: dict, par: dict | None = None) -> str:
    """The limits of a case of ``prec`` and ``par`` (the configs' overrides)."""
    if (par or {}).get("grad_compression") == "int8":
        return "int8"
    if prec.get("fp8"):
        return "fp8"
    return "tight" if prec.get("compute_dtype") == "float32" else "loose"


def got_readings(ranks, i) -> dict:
    """Rank 0's readings of the ``i``-th run of a spawn."""
    r0 = ranks[0][i]
    return readings(r0["metrics"], r0["state"])


def ranks_agree(ranks, i) -> bool:
    return all(r[i]["metrics"] == ranks[0][i]["metrics"] for r in ranks)


SHRINK = dict(old_chips=2, new_chips=1, model_parallel=1, global_batch=B)


def run_family(arch, cases: list, controls: dict, tmp: Path, *, bridged_case: str, shrink_case=None, wrap=None,
               gates=None, sp_of=(), jax_sp=False):
    """Every case of a family's test file on each of ``MESHES``, one spawn
    a mesh; the JAX package's sharded step meanwhile in its own process.
    ``cases``: ``(name, (jcfg, tcfg), prec, par)``; ``controls``: ``{name:
    (mesh, case name)}``; ``bridged_case``: the case whose bridged slices
    the ranks check; ``shrink_case``: the case the ``(2, 1)`` ranks shrink
    to one rank after its first two steps (``SHRINK``); ``wrap``: a context
    manager factory each unsharded run goes under; ``gates``: the vlm
    cross layers' gates before the first step; ``sp_of``: the cases that
    also run with sequence parallelism at ``(1, 2)`` and ``(2, 2)`` (as
    ``<name>-sp``; a control may run one); ``jax_sp``: also the JAX
    sharded step with sequence parallelism.  Returns a dict: ``refs``
    ``{name: (JAX readings, port readings)}``, ``befores``, ``cases``,
    ``ranks`` ``{mesh: each rank's results}``, ``index`` ``{mesh: {case or
    control: its place in the ranks' results}}``, ``jout`` (the JAX sharded
    run's) and ``jout_sp``, ``wrapped`` ``{name: the context manager}``."""
    from contextlib import nullcontext

    jcfg, tcfg = cases[0][1]
    proc, out_path, sharded_batches = start_jax_sharded(arch, jcfg, tmp, gates=gates)
    procs = [proc]
    if jax_sp:
        procs.append(start_jax_sharded(arch, jcfg, tmp, sharded_batches, gates, sequence_parallel=True)[0])
    try:
        refs, built, befores, wrapped = {}, {}, {}, {}
        for name, (jc, tc), prec, par in cases:
            with (wrap() if wrap else nullcontext()) as w:
                jax_ref, port_ref, case, before, start_np = make_case(arch, jc, tc, prec, par, gates=gates)
            refs[name], built[name], befores[name], wrapped[name] = (jax_ref, port_ref), case, before, w
            if name == bridged_case:
                bridged = (case, port_tuples(start_np))
        kinds = {c[0]: kind_of(c[2], c[3]) for c in cases}
        for name in sp_of:
            sp = f"{name}-sp"
            built[sp], refs[sp], befores[sp], kinds[sp] = with_sp(built[name]), refs[name], befores[name], kinds[name]
        fresh = {"vs_jax": fresh_case(arch, jcfg, tcfg, sharded_batches, gates)}
        if jax_sp:
            fresh["vs_jax_sp"] = with_sp(fresh["vs_jax"])
        ranks, index = {}, {}
        for mesh in MESHES:
            todo = [(c[0], built[c[0]]) for c in cases] + (list(fresh.items()) if mesh == (2, 2) else [])
            todo += [(f"{n}-sp", built[f"{n}-sp"]) for n in sp_of if mesh != (2, 1)]
            here = {c: built[case] for c, (m, case) in controls.items() if m == mesh}
            index[mesh] = {key: i for i, key in enumerate([k for k, _ in todo] + list(here))}
            shrinks = [(built[shrink_case], SHRINK, 1)] if shrink_case and mesh == (2, 1) else []
            ranks[mesh] = run_ranks(torch_sharded_ranks.train_cases, mesh, device="cpu", timeout_s=300,
                                    args=([c for _, c in todo], here, None, bridged, shrinks))
        jout = finish_jax_sharded(proc, out_path)
        jout_sp = finish_jax_sharded(procs[1], tmp / "out_sp.npz") if jax_sp else None
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    return {"refs": refs, "befores": befores, "cases": built, "ranks": ranks, "index": index, "jout": jout,
            "jout_sp": jout_sp, "wrapped": wrapped, "names": [c[0] for c in cases], "kinds": kinds, "cfg": tcfg,
            "controls": controls, "shrink_case": shrink_case, "paths": leaf_paths(built[cases[0][0]]["state"].params)}


def check_step(runs: dict, name: str, mesh) -> None:
    """Case ``name`` at ``mesh`` within its limits of the port's unsharded
    step and of the JAX package's; every rank reads the same metrics."""
    i = runs["index"][mesh][name]
    ranks = runs["ranks"][mesh]
    assert ranks_agree(ranks, i), "ranks disagree"
    got = got_readings(ranks, i)
    jax_ref, port_ref = runs["refs"][name]
    for which, ref in (("port", port_ref), ("jax", jax_ref)):
        r = close(got, ref, runs["befores"][name], runs["cfg"], runs["kinds"][name], runs["paths"])
        assert passes(r), f"{name} at {mesh} against the {which} step: {r}"


def check_sp_step(runs: dict, name: str, mesh) -> None:
    """``<name>-sp`` at ``mesh``: within the limits of ``check_step`` and of
    its case's sharded run on the same mesh, the residual stream split
    (gathers and reduce-scatters along seq issued, and no more
    ``sum_over_model`` than the vocab-parallel cross-entropy's, where the
    sharded run has one after each row-parallel product)."""
    check_step(runs, f"{name}-sp", mesh)
    ranks, index = runs["ranks"][mesh], runs["index"][mesh]
    sp, tp = ranks[0][index[f"{name}-sp"]], ranks[0][index[name]]
    r = close(readings(sp["metrics"], sp["state"]), readings(tp["metrics"], tp["state"]), runs["befores"][name],
              runs["cfg"], runs["kinds"][name], runs["paths"])
    assert passes(r), f"{name}-sp at {mesh} against its sharded run: {r}"
    assert sp["collectives"]["gather_seq"] > 0 and sp["collectives"]["reduce_scatter_seq"] > 0, sp["collectives"]
    assert "gather_seq" not in tp["collectives"], tp["collectives"]
    assert sp["collectives"]["sum_over_model"] < tp["collectives"]["sum_over_model"]


def check_control(runs: dict, control: str) -> None:
    """Control ``control`` fails the limits its case passes against the
    port's unsharded step."""
    mesh, name = runs["controls"][control]
    i = runs["index"][mesh][control]
    r = close(got_readings(runs["ranks"][mesh], i), runs["refs"][name][1], runs["befores"][name], runs["cfg"],
              runs["kinds"][name], runs["paths"])
    assert not passes(r), f"{control} passes the limits: {r}"


# The ssm family's limits against the JAX package's sharded step (gradient
# norm relative, parameters absolute): from fresh smoke rwkv6-7b weights the
# norm grows to 49 by the third step, and the port's own unsharded fp32
# steps read 6.9e-5 and 9.8e-6 against that run, and 5.5e-5 and 9.7e-6
# against the JAX package's unsharded steps on the same batches (whose
# parameters lie 2.2e-6 from the sharded run's).  The JAX package's own
# split moves this norm as much in fp32: its (1, 2) step-1 norm parts from
# its unsharded one by 3.5e-4 on one of four batches
# (``tests/bf16_split_probe.py --jax``).
JAX_SHARDED_LIMITS = {"ssm": {"grad_norm": 2e-4, "params": 5e-5}}


def check_jax_sharded(runs: dict, sp: bool = False) -> None:
    """The port at (2, 2) against the JAX package's sharded step: four
    fresh fp32 steps of 8 x 16, the tight limits (a key bias's rounding
    noise held to 2 lr a step; the ssm family's ``JAX_SHARDED_LIMITS``);
    ``sp``: both with sequence parallelism."""
    got = got_readings(runs["ranks"][(2, 2)], runs["index"][(2, 2)]["vs_jax_sp" if sp else "vs_jax"])
    jout = runs["jout_sp" if sp else "jout"]
    n = len(got["loss"])
    family = JAX_SHARDED_LIMITS.get(runs["cfg"].family, {})
    for k, lim in (("loss", 1e-6), ("aux_loss", 1e-6), ("grad_norm", family.get("grad_norm", 1e-5))):
        ref = [float(jout[f"{k}_{i}"]) for i in range(n)]
        assert all(abs(a - b) <= lim * abs(b) for a, b in zip(got[k], ref)), (k, got[k], ref)
    for path, a, b in zip(runs["paths"], got["params"], jax_sharded_params(runs["cfg"], jout)):
        lim = 2 * LR * n if path.endswith("/bk") else family.get("params", 1e-6)
        assert float(np.abs(a - b).max()) < lim, (path, float(np.abs(a - b).max()))


def jax_spec(runs: dict, path: str) -> tuple:
    """The JAX sharded run's spec of the stacked leaf ``path``, without its
    layer entries where it has them (a vlm self layer's two)."""
    spec = eval(str(runs["jout"][f"spec/{path}"]))  # a repr of a tuple of None / str / tuple
    lead = 2 if path.startswith("blocks/self/") else 1 if path.startswith("blocks/") else 0  # vlm: (G, g, ...)
    return tuple(spec[lead:])


def check_specs_against_jax(runs: dict) -> dict:
    """Every parameter's executed spec at (2, 2) against the JAX sharded
    run's spec of its stacked leaf: equal, but that the port keeps the leaves
    ``replicated_claims`` lists whole over ``"model"``.  Returns those."""
    from repro_torch.config import ParallelConfig
    from repro_torch.launch.mesh import MeshShape
    from repro_torch.parallel.sharding import executed_specs, replicated_claims, training_rules

    mesh, rules = MeshShape({"data": 2, "model": 2}), training_rules(ParallelConfig(remat="full"))
    port = executed_specs(runs["cfg"], mesh, rules)["executed"]
    kept = replicated_claims(runs["cfg"], mesh, rules)
    for path, spec in zip(leaf_paths(port), tree_leaves(port)):
        want = jax_spec(runs, "/".join(k for k in path.split("/") if not k.isdigit()))
        if path in kept:
            want = tuple(None if e == "model" else e for e in want)
        assert spec == want, (path, spec, want)
    return kept


def check_shrink(runs: dict) -> None:
    """The ``(2, 1)`` ranks' shrink to one rank: the gathered state equal
    before and after the reshard, then one step on the resized batch within
    the fp32 limits of the port's unsharded steps on the same batches."""
    from repro_torch.core import plan_resize, resize_batch
    from repro_torch.utils.tree import tree_map

    ranks = runs["ranks"][(2, 1)]
    r0, r1 = ranks[0][-2], ranks[1][-2]
    assert r0["mesh"] == (1, 1) and r1["mesh"] is None
    assert r0["before"]["step"] == r0["after"]["step"]
    assert all(np.array_equal(x, y) for k in ("params", "m", "v") for x, y in zip(r0["before"][k], r0["after"][k]))
    case = runs["cases"][runs["shrink_case"]]
    state = case["state"]
    state = state._replace(params=tree_map(torch.clone, state.params),
                           opt=state.opt._replace(m=tree_map(torch.clone, state.opt.m),
                                                  v=tree_map(torch.clone, state.opt.v)))
    step = make_train_step(case["cfg"], case["run"])
    plan, losses = plan_resize(**SHRINK), []
    for i, b in enumerate(case["batches"]):
        state, m = step(state, resize_batch(b, plan) if i == len(case["batches"]) - 1 else b)
        losses.append(float(m["loss"]))
    assert all(abs(a - b) <= 1e-6 * abs(b) for a, b in zip(r0["losses"], losses)), (r0["losses"], losses)
    diff = max(float(np.abs(a - b.numpy()).max()) for a, b in zip(r0["end"]["params"], tree_leaves(state.params)))
    assert diff < 1e-6, diff


def bridged_ok(runs: dict, mesh) -> bool:
    return all(r[-1]["bridged_shard"] for r in runs["ranks"][mesh])


def jax_free(runs: dict) -> bool:
    return not any(r[-1]["jax_loaded"] for m in MESHES for r in runs["ranks"][m])
