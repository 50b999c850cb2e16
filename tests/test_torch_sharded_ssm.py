"""Sharded and FSDP training of the ssm family over gloo ranks on the CPU
(smoke rwkv6-7b: 4 heads of 16 in the time mix, a 128-wide channel mix),
held to the port's unsharded step, to the JAX package's unsharded step
and, once, to the JAX package's sharded step (``torch_sharded_parity``:
the cases, the limits).

The time mix runs whole on every model rank (``parallel.sharding``'s
``WHOLE_OVER_MODEL``): its r / k / v / g / o projections, its head-indexed
``bonus``, its LoRA mixes and decays and ``ln_x``, where the JAX package
shards the projections and ``bonus`` over ``"model"``; the channel mix
splits its hidden dim as an FFN does (``w_k`` column-parallel, ``w_v``
row-parallel, ``w_r`` whole), and the head's vocab splits.  At ``(2, 1)``
FSDP shards every ``"embed"`` dim, the time mix's included.  Cases, each
on ``(1, 2)``, ``(2, 1)`` and ``(2, 2)``: fp32 with remat full; fp32 in two
microbatches without remat; bf16 compute.

The control (``(1, 2)``, fp32) moves the channel mix's ``copy_to_model``
to the block input: the gradients of the whole time mix, which each rank
computes whole, and the residual's are then summed over the model ranks
(trap 1 of ``models.moe``), and must fail the limits.  The ``(2, 1)``
ranks also shrink to one rank after two fp32 steps (``core.elastic``): the
state reshards bit for bit and one more step stays within the fp32 limits
of the unsharded run on the resized batch.

Sequence parallelism: the ``fp32`` case runs again at ``(1, 2)`` and
``(2, 2)`` with the residual stream split over seq: the time mix runs
whole on every rank on the gathered sequence, as under tensor
parallelism, and ``scatter_seq`` cuts its output (whose backward gathers
the gradient, so the leaves take their whole gradients); the channel mix
gathers before its token shift.  It is held to the case's references, to the case's sharded
run on the mesh and, at ``(2, 2)``, to the JAX package's sharded step
with sequence parallelism.  Its control (``(1, 2)``) leaves the time
mix's leaves unsummed: ``scatter_seq`` does not gather the time mix's
output gradient, so each rank's gradient of its leaves is its slice's
share.
"""

import pytest
import torch

import bf16_split_probe
import torch_sharded_parity as P
import torch_sharded_ranks
from repro_torch.config import ParallelConfig
from repro_torch.configs import get_config
from repro_torch.launch.mesh import MeshShape
from repro_torch.parallel.sharding import executed_specs, replicated_claims, training_rules
from torch_parity import configs

torch.set_num_threads(2)

ARCH = "rwkv6-7b"
# name, precision, parallel
CASES = [
    ("fp32", {"compute_dtype": "float32"}, {"remat": "full"}),
    ("fp32-mb2-noremat", {"compute_dtype": "float32"}, {"remat": "none", "num_microbatches": 2}),
    ("bf16", {}, {"remat": "full"}),
]
NAMES = [c[0] for c in CASES]
CONTROLS = {"ssm_time_mix_summed_twice": ((1, 2), "fp32"),
            "ssm_time_mix_leaves_unsummed": ((1, 2), "fp32-sp")}
assert set(CONTROLS) <= set(torch_sharded_ranks.FAMILY_CONTROLS)
# the leaves whose model claim the port leaves whole, in each block
WHOLE = {"time_mix/bonus", "time_mix/w_r", "time_mix/w_k", "time_mix/w_v", "time_mix/w_g", "time_mix/w_o",
         "channel_mix/w_r"}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    cfgs = configs(ARCH)
    return P.run_family(ARCH, [(name, cfgs, prec, par) for name, prec, par in CASES], CONTROLS,
                        tmp_path_factory.mktemp("jax_sharded_ssm"), bridged_case="bf16", shrink_case="fp32",
                        sp_of=("fp32",), jax_sp=True)


@pytest.mark.parametrize("mesh", P.MESHES, ids=lambda m: f"{m[0]}x{m[1]}")
@pytest.mark.parametrize("name", NAMES)
def test_sharded_step_matches_the_unsharded_steps(runs, name, mesh):
    P.check_step(runs, name, mesh)


@pytest.mark.parametrize("control", list(CONTROLS))
def test_controls_fail_the_limits(runs, control):
    P.check_control(runs, control)


@pytest.mark.parametrize("mesh", P.SP_MESHES, ids=lambda m: f"{m[0]}x{m[1]}")
@pytest.mark.parametrize("name", ["fp32"])
def test_sequence_parallel_step_matches_the_sharded_steps(runs, name, mesh):
    """The case with sequence parallelism within its limits of the port's
    and the JAX package's unsharded steps and of its own sharded run on
    the mesh, the residual stream split (``check_sp_step``)."""
    P.check_sp_step(runs, name, mesh)


def test_sequence_parallel_matches_the_jax_sharded_step(runs):
    """The port at (2, 2) with sequence parallelism against the JAX
    package's sharded step with ``sequence_parallel=True`` (the rule engine
    splits the residual stream's "seq" over "model"), fresh fp32 steps."""
    P.check_jax_sharded(runs, sp=True)


@pytest.mark.parametrize("arch", ["smoke", "full"])
def test_time_mix_layout_is_whole_over_model(arch):
    """At (2, 2) and at (1, 2), smoke and full width (64 heads, which divide
    the model axis): no leaf of the time mix splits over "model", ``bonus``
    and the projections included, every embed dim of it takes "data" under
    FSDP; the channel mix splits its hidden dim; ``replicated_claims`` lists
    exactly the leaves the table would shard over "model"."""
    cfg = configs(ARCH)[1] if arch == "smoke" else get_config(ARCH)
    rules = training_rules(ParallelConfig())
    block = executed_specs(cfg, MeshShape({"data": 2, "model": 2}), rules)["executed"]["blocks"][0]
    assert all("model" not in s for s in block["time_mix"].values()), block["time_mix"]
    assert block["time_mix"]["bonus"] == (None, None) and block["time_mix"]["w_r"] == ("data", None)
    assert block["time_mix"]["w_o"] == (None, "data") and block["time_mix"]["maa_w2"] == (None, None, "data")
    cm = block["channel_mix"]
    assert cm["w_k"] == ("data", "model") and cm["w_v"] == ("model", "data") and cm["w_r"] == ("data", None)
    for shape in ({"data": 2, "model": 2}, {"data": 1, "model": 2}):
        kept = replicated_claims(cfg, MeshShape(shape), rules)
        assert {p.split("/", 2)[2] for p in kept} == WHOLE and len(kept) == len(WHOLE) * cfg.num_layers, kept


def test_matches_the_jax_sharded_step(runs):
    """The port at (2, 2) against the JAX package's sharded step; every
    leaf's spec equals the JAX package's but for the time mix's and
    ``channel_mix/w_r``'s model claims."""
    P.check_jax_sharded(runs)
    kept = P.check_specs_against_jax(runs)
    assert {p.split("/", 2)[2] for p in kept} == WHOLE
    assert P.jax_spec(runs, "blocks/time_mix/bonus") == ("model", None)


def test_shrink_reshards_bit_for_bit(runs):
    P.check_shrink(runs)


@pytest.mark.parametrize("mesh", P.MESHES, ids=lambda m: f"{m[0]}x{m[1]}")
def test_sharded_bridge_equals_shard_state(runs, mesh):
    assert P.bridged_ok(runs, mesh)


def test_ranks_import_no_jax(runs):
    assert P.jax_free(runs)


def test_split_rounds_only_where_bf16_rounds():
    """The channel mix's product summed from two halves of the hidden dim in
    one process (``bf16_split_probe``, the seed's smoke state): in fp32 the
    gradient norm is the unsplit one's to 1e-5 relative (the split computes
    the same function); in bf16 the split, and a split into even and odd
    halves, move it within ``LOOSE_GRAD_NORM`` of the unsplit bf16 norm."""
    rows = {r["run"]: r["grad_norm"] for r in bf16_split_probe.port_rows("cpu", smoke=True)}
    assert abs(rows["fp32_split"] / rows["fp32"] - 1) <= 1e-5, rows
    for name in ("bf16_split", "bf16_split_interleaved"):
        assert abs(rows[name] / rows["bf16"] - 1) <= P.LOOSE_GRAD_NORM["ssm"], rows
