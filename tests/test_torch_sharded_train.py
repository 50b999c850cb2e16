"""Sharded and FSDP training of the port over gloo ranks on the CPU, held
to the port's unsharded step, to the JAX package's unsharded step and,
once, to the JAX package's sharded step.

Every case starts from one state: the JAX package initialises and takes
one step (so the AdamW moments, the step counter and the fp8 amax history
are mid-training), ``bridge.train_state_from_jax`` copies it into the
port, and three more steps follow on the same numpy batches (4 x 32,
warmup 2, so the parameters move) in the JAX package, in the port on one
process, and in the port on each of the meshes ``(1, 2)`` (tensor
parallelism), ``(2, 1)`` (FSDP and data parallelism) and ``(2, 2)``.
The ranks of a mesh run every case in one spawn
(``torch_sharded_ranks.train_cases``; they import no JAX) and gather the
state back (``unshard_state``).  Compared: each step's loss, aux loss (0
for the dense family) and gradient norm (clipping at 1.0 is on), the fp8
scales and amax history, and every parameter leaf; and each rank's
slices bridged straight from the JAX state (``train_state_from_jax(specs=,
mesh=)``) against the slices of the full bridge.  The cases cover smoke olmo-1b and a dense variant with
q/k norms, biases, RMS norms (FSDP shards their scales) and an untied
head; one and two microbatches; fp32 and bf16 compute; fp8 on olmo-1b
(K4's plain version on the CPU); int8 gradient compression; remat
``"full"`` and ``"none"``.  (The variant with fp8 sits at the fp8 limits
against the JAX package unsharded already: a loss 2.0e-3 apart, amaxes
0.115; its sharded runs are no farther, but the case would test the
limits, not the sharding.)

Limits, from ``test_torch_train.py``'s tight and loose ones:

* fp32 compute: the same functions with sums in another order (the
  all-reduces and reduce-scatters add the ranks' partial sums).  Losses
  agree to 1e-6 relative, gradient norms to 1e-5, parameters to 1e-6
  absolute; a key bias's gradient is rounding noise, held to 2 lr a step
  (``test_torch_train.py``).
* bf16 compute and fp8: the two frameworks, and the sharded and
  unsharded steps (a row-parallel product's bf16 partial outputs summed
  after rounding, FSDP's bf16 gradients reduce-scattered), round at other
  places.  Losses agree to 1e-3 relative (2e-3 with fp8), gradient norms
  to 5e-2, every parameter to 2 lr a step, the mean parameter difference
  under lr / 10 (lr / 5 with fp8); fp8 scales and amax history to 0.1
  relative.
* int8 compression in fp32 compute: a code whose gradient lies within
  rounding of a half step takes its neighbour, moving that element by one
  quantum (``max|g| / 127`` of its stacked leaf) for a step.  Losses as in
  fp32, gradient norms (taken after compression) to 1e-4, parameters: the
  mean difference under lr / 1000 and at most 1 in 1000 elements beyond
  the fp32 limit.

Three controls, each a change to one collective, must fail these limits:
the copy-to-model backward dropped (``(1, 2)``, fp32), a replicated leaf's
square sum counted on every rank in the clipping norm (``(2, 1)``, fp32:
the token table), and int8's scale taken from the local shard (``(2, 2)``).

One run holds the port at ``(2, 2)`` to the JAX package's own sharded step
on a ``(data=2, model=2)`` mesh of four forced host devices, run in a
process of its own (``tests/jax_sharded_train.py``), from the JAX
initialisation over four fresh steps of 8 x 16 tokens (fp32: the tight
limits).  At ``(2, 1)`` a rank holds half of the params, ``m`` and ``v``
bytes of the unsharded state, but for the leaves no axis shards: the
token table.
"""

import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config import ParallelConfig as JaxParallelConfig
from repro.config import PrecisionConfig as JaxPrecisionConfig
from repro.config import RunConfig as JaxRunConfig
from repro.config import TrainConfig as JaxTrainConfig
from repro.config.model import reduce_for_smoke as jax_reduce
from repro.configs import get_config as jax_get_config
from repro.train.step import init_train_state as jax_init_train_state
from repro.train.step import make_train_step as jax_make_train_step
from repro_torch.bridge import params_from_jax, train_state_from_jax
from repro_torch.config import ParallelConfig, PrecisionConfig, RunConfig, TrainConfig, reduce_for_smoke
from repro_torch.configs import get_config
from repro_torch.launch.mesh import run_ranks
from repro_torch.train import make_train_step
from repro_torch.utils.tree import tree_leaves, tree_paths

import torch_sharded_ranks

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parents[1]
B, S, LR = 4, 32, 1e-3
TRAIN = dict(global_batch=B, seq_len=S, learning_rate=LR, warmup_steps=2, total_steps=10)
# the dense variant: q/k norms, every bias, RMS norms with scales, an untied head
VARIANT = dict(qk_norm=True, use_bias=True, norm="rmsnorm", tie_embeddings=False)
MESHES = [(1, 2), (2, 1), (2, 2)]
INT8_NORM_REL = 1e-4  # a code that takes its neighbour moves the norm by up to one quantum

# name, variant?, precision, parallel
CASES = [
    ("fp32", False, {"compute_dtype": "float32"}, {"remat": "full"}),
    ("fp32-mb2-noremat", False, {"compute_dtype": "float32"}, {"remat": "none", "num_microbatches": 2}),
    ("fp8", False, {"fp8": True}, {"remat": "full"}),
    ("int8", False, {"compute_dtype": "float32"}, {"remat": "full", "grad_compression": "int8"}),
    ("variant-fp32-mb2", True, {"compute_dtype": "float32"}, {"remat": "full", "num_microbatches": 2}),
    ("variant-bf16-noremat", True, {}, {"remat": "none"}),
]
NAMES = [c[0] for c in CASES]
# control -> (mesh, the case it runs)
CONTROLS = {
    "copy_to_model_backward_dropped": ((1, 2), "fp32"),
    "replicated_leaf_counted_on_every_rank": ((2, 1), "fp32"),
    "int8_scale_from_local_shard": ((2, 2), "int8"),
}
assert set(CONTROLS) == set(torch_sharded_ranks.CONTROLS)


def _configs(variant):
    jcfg, tcfg = jax_reduce(jax_get_config("olmo-1b")), reduce_for_smoke(get_config("olmo-1b"))
    return (jcfg.replace(**VARIANT), tcfg.replace(**VARIANT)) if variant else (jcfg, tcfg)


def _batches(vocab, n, seed=0, batch=B, seq=S):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        tok = rng.integers(0, vocab, (batch, seq)).astype(np.int32)
        out.append({"tokens": tok, "labels": np.roll(tok, -1, axis=1)})
    return out


def _torch(b):
    return {k: torch.from_numpy(v) for k, v in b.items()}


def _np_tree(state):
    return jax.tree.map(np.asarray, state)


def _readings(metrics, state_np):
    return {k: [m[k] for m in metrics] for k in ("loss", "aux_loss", "grad_norm")} | state_np


def _port_tuples(np_state):
    """A numpy JAX train state in the port's NamedTuples (the ranks must not
    unpickle the JAX package's classes)."""
    from repro_torch.fp8 import Fp8State
    from repro_torch.optim import AdamWState
    from repro_torch.train import TrainState

    f, o = np_state.fp8, np_state.opt
    fp8 = None if f is None else Fp8State(amax_history=dict(f.amax_history), scale=dict(f.scale), step=f.step)
    return TrainState(params=np_state.params, opt=AdamWState(step=o.step, m=o.m, v=o.v),
                      compress_residual=np_state.compress_residual, fp8=fp8)


def _case(variant, prec, par):
    """(JAX readings, the port's unsharded readings, the case for the
    ranks, the parameters before the three steps, the numpy JAX state they
    start from)."""
    jcfg, tcfg = _configs(variant)
    jrun = JaxRunConfig(arch="olmo-1b", train=JaxTrainConfig(**TRAIN), parallel=JaxParallelConfig(**par),
                        precision=JaxPrecisionConfig(**(dict(prec, fp8_gemm="pallas") if prec.get("fp8") else prec)))
    trun = RunConfig(arch="olmo-1b", train=TrainConfig(**TRAIN), parallel=ParallelConfig(**par),
                     precision=PrecisionConfig(**prec))
    batches = _batches(jcfg.vocab_size, 4)
    jstate = jax_init_train_state(jcfg, jrun, jax.random.PRNGKey(0))
    jstep = jax.jit(jax_make_train_step(jcfg, jrun))
    jstate, _ = jstep(jstate, {k: jnp.asarray(v) for k, v in batches[0].items()})
    start_np = _np_tree(jstate)
    jm = []
    for b in batches[1:]:
        jstate, m = jstep(jstate, {k: jnp.asarray(v) for k, v in b.items()})
        jm.append({k: float(v) for k, v in m.items()})
    jax_ref = _readings(jm, torch_sharded_ranks._numpy_state(train_state_from_jax(tcfg, _np_tree(jstate), "cpu")))
    state = train_state_from_jax(tcfg, start_np, device="cpu")
    step = make_train_step(tcfg, trun)
    local = train_state_from_jax(tcfg, start_np, device="cpu")
    tm = []
    for b in batches[1:]:
        local, m = step(local, _torch(b))
        tm.append({k: float(v) for k, v in m.items()})
    port_ref = _readings(tm, torch_sharded_ranks._numpy_state(local))
    case = {"cfg": tcfg, "run": trun, "state": state, "batches": [_torch(b) for b in batches[1:]]}
    before = [t.numpy().copy() for t in tree_leaves(state.params)]
    return jax_ref, port_ref, case, before, start_np


def _jax_sharded(tmp: Path):
    """Start the JAX sharded run in a process of its own; returns (the
    process, its output file, the batches)."""
    batches = _batches(256, 4, seed=5, batch=8, seq=16)
    np.savez(tmp / "batches.npz", **{f"{k}_{i}": b[k] for i, b in enumerate(batches) for k in b})
    env = dict(os.environ, XLA_FLAGS="--xla_force_host_platform_device_count=4", JAX_PLATFORMS="cpu",
               PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.Popen([sys.executable, str(ROOT / "tests" / "jax_sharded_train.py"), str(tmp / "batches.npz"),
                             str(tmp / "out.npz")], env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
    return proc, tmp / "out.npz", batches


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("jax_sharded")
    proc, out_path, sharded_batches = _jax_sharded(tmp)
    try:
        refs, cases, befores = {}, {}, {}
        for name, variant, prec, par in CASES:
            jax_ref, port_ref, case, before, start_np = _case(variant, prec, par)
            refs[name], cases[name], befores[name] = (jax_ref, port_ref), case, before
            if name == "fp8":  # the sharded bridge: fp8 state, moments, step
                bridged = (case, _port_tuples(start_np))
        # the fresh JAX initialisation, for the run against the JAX sharded step
        jcfg, tcfg = _configs(False)
        trun = RunConfig(arch="olmo-1b", train=TrainConfig(**dict(TRAIN, global_batch=8, seq_len=16)),
                         parallel=ParallelConfig(remat="full"), precision=PrecisionConfig(compute_dtype="float32"))
        jrun = JaxRunConfig(arch="olmo-1b", train=JaxTrainConfig(**dict(TRAIN, global_batch=8, seq_len=16)),
                            parallel=JaxParallelConfig(remat="full"), precision=JaxPrecisionConfig(compute_dtype="float32"))
        fresh = train_state_from_jax(tcfg, _np_tree(jax_init_train_state(jcfg, jrun, jax.random.PRNGKey(0))), "cpu")
        vs_jax_sharded = {"cfg": tcfg, "run": trun, "state": fresh, "batches": [_torch(b) for b in sharded_batches]}
        memory_of = (tcfg, RunConfig(arch="olmo-1b", parallel=ParallelConfig(remat="full")))
        ranks = {}
        for mesh in MESHES:
            todo = [cases[n] for n in NAMES] + ([vs_jax_sharded] if mesh == (2, 2) else [])
            controls = {c: cases[case] for c, (m, case) in CONTROLS.items() if m == mesh}
            ranks[mesh] = run_ranks(torch_sharded_ranks.train_cases, mesh, device="cpu", timeout_s=300,
                                    args=(todo, controls, memory_of if mesh == (2, 1) else None, bridged))
        out, _ = proc.communicate(timeout=300)
        assert proc.returncode == 0, out.decode()[-3000:]
        jax_sharded = dict(np.load(out_path))
    finally:
        if proc.poll() is None:
            proc.kill()
    return refs, befores, ranks, jax_sharded


def _param_tree(name):
    from repro_torch.models import param_specs

    return param_specs(_configs(CASES[NAMES.index(name)][1])[1])


def _close(got, ref, before, name, kind) -> dict:
    """``{reading: (value, limit)}`` of ``got`` against ``ref`` (``kind``:
    "tight", "loose", "fp8" or "int8"); a reading keeps its limit when
    value <= limit, but ``moved``, which must exceed its own."""
    tight = kind in ("tight", "int8")
    rel_loss = 1e-6 if tight else (2e-3 if kind == "fp8" else 1e-3)
    rel_norm = {"tight": 1e-5, "int8": INT8_NORM_REL}.get(kind, 5e-2)
    rel = lambda a, b: max(abs(x - y) / abs(y) for x, y in zip(a, b))  # noqa: E731
    out = {"loss": (rel(got["loss"], ref["loss"]), rel_loss),
           "aux_loss": (max(abs(a - b) for a, b in zip(got["aux_loss"], ref["aux_loss"])), 1e-12),  # 0: dense
           "grad_norm": (rel(got["grad_norm"], ref["grad_norm"]), rel_norm)}
    diff = np.concatenate([np.abs(a - b).ravel() for a, b in zip(got["params"], ref["params"])])
    steps = len(ref["loss"])
    if kind == "tight":
        paths = ["/".join(map(str, p)) for p in tree_paths(_param_tree(name))]
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


def _passes(readings: dict) -> bool:
    return all((v > lim) if k == "moved" else (v <= lim) for k, (v, lim) in readings.items())


def _kind(name):
    _, _, prec, par = CASES[NAMES.index(name)]
    if par.get("grad_compression") == "int8":
        return "int8"
    if prec.get("fp8"):
        return "fp8"
    return "tight" if prec.get("compute_dtype") == "float32" else "loose"


def _got(ranks, i):
    r0 = ranks[0][i]
    return _readings(r0["metrics"], r0["state"])


@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: f"{m[0]}x{m[1]}")
@pytest.mark.parametrize("name", NAMES)
def test_sharded_step_matches_the_unsharded_steps(runs, name, mesh):
    """Loss, gradient norm, fp8 state and every gathered parameter after
    three steps within the case's limits of the port's unsharded step and
    of the JAX package's; every rank reads the same metrics."""
    refs, befores, ranks, _ = runs
    (jax_ref, port_ref), i = refs[name], NAMES.index(name)
    got = _got(ranks[mesh], i)
    assert all(r[i]["metrics"] == ranks[mesh][0][i]["metrics"] for r in ranks[mesh]), "ranks disagree"
    for which, ref in (("port", port_ref), ("jax", jax_ref)):
        readings = _close(got, ref, befores[name], name, _kind(name))
        assert _passes(readings), f"{name} at {mesh} against the {which} step: {readings}"


@pytest.mark.parametrize("control", list(CONTROLS))
def test_controls_fail_the_limits(runs, control):
    """Each control keeps the steps running but must fail the limits its
    case passes."""
    refs, befores, ranks, _ = runs
    mesh, name = CONTROLS[control]
    controls_here = [c for c, (m, _) in CONTROLS.items() if m == mesh]
    i = len(NAMES) + (1 if mesh == (2, 2) else 0) + controls_here.index(control)
    got = _got(ranks[mesh], i)
    readings = _close(got, refs[name][1], befores[name], name, _kind(name))
    assert not _passes(readings), f"{control} passes the limits: {readings}"


def test_matches_the_jax_sharded_step(runs):
    """The port at (2, 2) against the JAX package's sharded step on four
    forced host devices: four fresh steps, tight limits, and the JAX
    layout the port executes (FSDP on the embed dim, TP on heads and the
    hidden dim)."""
    _, _, ranks, jout = runs
    got = _got(ranks[(2, 2)], len(NAMES))
    n = len(got["loss"])
    ref_loss = [float(jout[f"loss_{i}"]) for i in range(n)]
    ref_norm = [float(jout[f"grad_norm_{i}"]) for i in range(n)]
    assert all(abs(a - b) <= 1e-6 * abs(b) for a, b in zip(got["loss"], ref_loss)), (got["loss"], ref_loss)
    assert all(abs(a - b) <= 1e-5 * abs(b) for a, b in zip(got["grad_norm"], ref_norm)), (got["grad_norm"], ref_norm)
    tree = {}
    for k, v in jout.items():
        if k.startswith("param/"):
            node = tree
            *head, last = k.split("/")[1:]
            for h in head:
                node = node.setdefault(h, {})
            node[last] = v
    cfg = reduce_for_smoke(get_config("olmo-1b"))
    ref = [t.numpy() for t in tree_leaves(params_from_jax(cfg, tree, device="cpu"))]
    diff = max(float(np.abs(a - b).max()) for a, b in zip(got["params"], ref))
    assert diff < 1e-6, diff
    assert str(jout["spec_wq"]) == "(None, 'data', 'model', None)"
    assert str(jout["spec_w_down"]) == "(None, 'model', 'data')"


def test_fsdp_halves_the_state_at_2x1(runs):
    """At (2, 1) a rank holds half of the params, m and v bytes, but for
    the leaves no axis shards (the token table: its embed dim is
    ``embed_v``), and its fresh sharded state is the full one's slices."""
    _, _, ranks, _ = runs
    mem = ranks[(2, 1)][0][-2]
    assert mem["replicated"] == ["embed/tok"]
    rep = mem["replicated_param_bytes"]
    for local, full in zip(mem["local"], mem["full"]):
        assert local == (full - rep) // 2 + rep
    assert mem["init_equals_shard"]


@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: f"{m[0]}x{m[1]}")
def test_sharded_bridge_equals_shard_state(runs, mesh):
    """``train_state_from_jax(specs=, mesh=)`` gives each rank the slices
    of the full bridged state, fp8 state and moments included."""
    _, _, ranks, _ = runs
    assert all(r[-1]["bridged_shard"] for r in ranks[mesh])


def test_ranks_import_no_jax(runs):
    _, _, ranks, _ = runs
    assert not any(r[-1]["jax_loaded"] for m in MESHES for r in ranks[m])

