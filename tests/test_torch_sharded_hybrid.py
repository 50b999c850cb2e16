"""Sharded and FSDP training of the hybrid family over gloo ranks on the
CPU (smoke hymba-1.5b: 5 attention heads over 1 kv head beside the SSM
heads, window 32), held to the port's unsharded step, to the JAX package's
unsharded step and, once, to the JAX package's sharded step
(``torch_sharded_parity``: the cases, the limits).

hymba's heads do not divide the model axis, so at ``(1, 2)`` the
attention stays whole on every rank, as in serving, and so do the SSM
heads (``parallel.sharding.REPLICATED_SUBTREES``); the FFN's hidden dim
and the vocab split.  At ``(2, 1)`` FSDP shards every ``"embed"`` dim
outside the SSM subtree (the attention, the FFN, the norms and
``beta_attn`` / ``beta_ssm``).  Cases, each on ``(1, 2)``, ``(2, 1)`` and
``(2, 2)``: fp32 with remat full; fp32 in two microbatches without remat;
bf16 compute.

The control (``(1, 2)``, fp32) moves the FFN input's ``copy_to_model`` to
the block input: the replicated attention and SSM branches' gradients,
and the residual's, are then summed over the model ranks that each hold
them whole (trap 1 of ``models.moe``), and must fail the limits.  The
``(2, 1)`` ranks also shrink to one rank after two fp32 steps
(``core.elastic``): the state reshards bit for bit and one more step stays
within the fp32 limits of the unsharded run on the resized batch.

Sequence parallelism: the ``fp32`` case runs again at ``(1, 2)`` and
``(2, 2)`` with the residual stream split over seq; hymba's whole
attention and SSM heads run on the gathered sequence on every rank and
``scatter_seq`` cuts their outputs; ``beta_attn`` / ``beta_ssm`` act on
the slice and sum their gradients (``copy_to_model``).  It is held to the
case's references and to the case's sharded run on the mesh.
"""

import pytest
import torch

import torch_sharded_parity as P
import torch_sharded_ranks
from repro_torch.config import ParallelConfig
from repro_torch.launch.mesh import MeshShape
from repro_torch.parallel.sharding import executed_specs, training_rules
from torch_parity import configs

torch.set_num_threads(2)

ARCH = "hymba-1.5b"
# name, precision, parallel
CASES = [
    ("fp32", {"compute_dtype": "float32"}, {"remat": "full"}),
    ("fp32-mb2-noremat", {"compute_dtype": "float32"}, {"remat": "none", "num_microbatches": 2}),
    ("bf16", {}, {"remat": "full"}),
]
NAMES = [c[0] for c in CASES]
CONTROLS = {"hybrid_branches_counted_twice": ((1, 2), "fp32")}
assert set(CONTROLS) <= set(torch_sharded_ranks.FAMILY_CONTROLS)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    cfgs = configs(ARCH)
    return P.run_family(ARCH, [(name, cfgs, prec, par) for name, prec, par in CASES], CONTROLS,
                        tmp_path_factory.mktemp("jax_sharded_hybrid"), bridged_case="bf16", shrink_case="fp32",
                        sp_of=("fp32",))


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


def test_layout_keeps_the_replicated_branches_whole():
    """At (2, 2): the attention (5 heads over 1) and the SSM heads stay
    whole over "model"; the SSM subtree stays whole over "data" too, the
    attention's embed dim takes "data"; the FFN splits its hidden dim."""
    cfg = configs(ARCH)[1]
    block = executed_specs(cfg, MeshShape({"data": 2, "model": 2}),
                           training_rules(ParallelConfig()))["executed"]["blocks"][0]
    assert all(s == (None,) * len(s) for s in block["ssm"].values())
    assert block["attn"]["wq"] == ("data", None, None) and block["beta_attn"] == ("data",)
    assert block["mlp"]["w_up"] == ("data", "model") and block["mlp"]["w_down"] == ("model", "data")


def test_matches_the_jax_sharded_step(runs):
    """The port at (2, 2) against the JAX package's sharded step; the FFN
    and the branch scales take the same layout in both."""
    P.check_jax_sharded(runs)
    port = executed_specs(runs["cfg"], MeshShape({"data": 2, "model": 2}),
                          training_rules(ParallelConfig(remat="full")))["executed"]["blocks"][0]
    for path in ("mlp/w_up", "mlp/w_gate", "mlp/w_down", "beta_attn", "beta_ssm"):
        node = port
        for k in path.split("/"):
            node = node[k]
        assert P.jax_spec(runs, f"blocks/{path}") == node, path


def test_shrink_reshards_bit_for_bit(runs):
    P.check_shrink(runs)


@pytest.mark.parametrize("mesh", P.MESHES, ids=lambda m: f"{m[0]}x{m[1]}")
def test_sharded_bridge_equals_shard_state(runs, mesh):
    assert P.bridged_ok(runs, mesh)


def test_ranks_import_no_jax(runs):
    assert P.jax_free(runs)
