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

Limits: ``torch_sharded_parity``'s ``"tight"`` (fp32 compute), ``"loose"``
(bf16), ``"fp8"`` and ``"int8"`` (int8 gradient compression), with the
parameters' paths in the bridged state's leaf order.

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

import numpy as np
import pytest
import torch

import torch_sharded_parity as P
import torch_sharded_ranks
from repro.config.model import reduce_for_smoke as jax_reduce
from repro.configs import get_config as jax_get_config
from repro_torch.config import ParallelConfig, RunConfig, reduce_for_smoke
from repro_torch.configs import get_config
from repro_torch.launch.mesh import run_ranks
from repro_torch.utils.tree import tree_paths

torch.set_num_threads(2)

B, S, LR = P.B, P.S, P.LR
# the dense variant: q/k norms, every bias, RMS norms with scales, an untied head
VARIANT = dict(qk_norm=True, use_bias=True, norm="rmsnorm", tie_embeddings=False)
MESHES = P.MESHES

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


def _case(variant, prec, par):
    """``torch_sharded_parity.make_case`` on this file's batches: tokens and
    their next tokens as labels."""
    return P.make_case("olmo-1b", *_configs(variant), prec, par, data=_batches(256, 4))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    jcfg, tcfg = _configs(False)
    proc, out_path, sharded_batches = P.start_jax_sharded("olmo-1b", jcfg, tmp_path_factory.mktemp("jax_sharded"),
                                                          data=_batches(256, 4, seed=5, batch=8, seq=16))
    try:
        refs, cases, befores = {}, {}, {}
        for name, variant, prec, par in CASES:
            jax_ref, port_ref, case, before, start_np = _case(variant, prec, par)
            refs[name], cases[name], befores[name] = (jax_ref, port_ref), case, before
            PATHS[name] = ["/".join(map(str, p)) for p in tree_paths(case["state"].params)]
            if name == "fp8":  # the sharded bridge: fp8 state, moments, step
                bridged = (case, P.port_tuples(start_np))
        # the fresh JAX initialisation, for the run against the JAX sharded step
        vs_jax_sharded = P.fresh_case("olmo-1b", jcfg, tcfg, sharded_batches)
        memory_of = (tcfg, RunConfig(arch="olmo-1b", parallel=ParallelConfig(remat="full")))
        ranks = {}
        for mesh in MESHES:
            todo = [cases[n] for n in NAMES] + ([vs_jax_sharded] if mesh == (2, 2) else [])
            controls = {c: cases[case] for c, (m, case) in CONTROLS.items() if m == mesh}
            ranks[mesh] = run_ranks(torch_sharded_ranks.train_cases, mesh, device="cpu", timeout_s=300,
                                    args=(todo, controls, memory_of if mesh == (2, 1) else None, bridged))
        jax_sharded = P.finish_jax_sharded(proc, out_path)
    finally:
        if proc.poll() is None:
            proc.kill()
    return refs, befores, ranks, jax_sharded


# each case's parameter paths in the order of its leaves: a bridged state's,
# whose dict keys are sorted (``param_specs``'s order is another)
PATHS: dict = {}


def _close(got, ref, before, name) -> dict:
    _, _, prec, par = CASES[NAMES.index(name)]
    return P.close(got, ref, before, _configs(CASES[NAMES.index(name)][1])[1], P.kind_of(prec, par), PATHS[name])


@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: f"{m[0]}x{m[1]}")
@pytest.mark.parametrize("name", NAMES)
def test_sharded_step_matches_the_unsharded_steps(runs, name, mesh):
    """Loss, gradient norm, fp8 state and every gathered parameter after
    three steps within the case's limits of the port's unsharded step and
    of the JAX package's; every rank reads the same metrics."""
    refs, befores, ranks, _ = runs
    (jax_ref, port_ref), i = refs[name], NAMES.index(name)
    got = P.got_readings(ranks[mesh], i)
    assert P.ranks_agree(ranks[mesh], i), "ranks disagree"
    for which, ref in (("port", port_ref), ("jax", jax_ref)):
        readings = _close(got, ref, befores[name], name)
        assert P.passes(readings), f"{name} at {mesh} against the {which} step: {readings}"


@pytest.mark.parametrize("control", list(CONTROLS))
def test_controls_fail_the_limits(runs, control):
    """Each control keeps the steps running but must fail the limits its
    case passes."""
    refs, befores, ranks, _ = runs
    mesh, name = CONTROLS[control]
    controls_here = [c for c, (m, _) in CONTROLS.items() if m == mesh]
    i = len(NAMES) + (1 if mesh == (2, 2) else 0) + controls_here.index(control)
    readings = _close(P.got_readings(ranks[mesh], i), refs[name][1], befores[name], name)
    assert not P.passes(readings), f"{control} passes the limits: {readings}"


def test_matches_the_jax_sharded_step(runs):
    """The port at (2, 2) against the JAX package's sharded step on four
    forced host devices: four fresh steps, tight limits, and the JAX
    layout the port executes (FSDP on the embed dim, TP on heads and the
    hidden dim)."""
    _, _, ranks, jout = runs
    got = P.got_readings(ranks[(2, 2)], len(NAMES))
    n = len(got["loss"])
    ref_loss = [float(jout[f"loss_{i}"]) for i in range(n)]
    ref_norm = [float(jout[f"grad_norm_{i}"]) for i in range(n)]
    assert all(abs(a - b) <= 1e-6 * abs(b) for a, b in zip(got["loss"], ref_loss)), (got["loss"], ref_loss)
    assert all(abs(a - b) <= 1e-5 * abs(b) for a, b in zip(got["grad_norm"], ref_norm)), (got["grad_norm"], ref_norm)
    ref = P.jax_sharded_params(reduce_for_smoke(get_config("olmo-1b")), jout)
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

