"""Sharded and FSDP training of the audio family over gloo ranks on the
CPU (smoke hubert-xlarge: bidirectional dense blocks with biases and
layer norms over frame embeddings), held to the port's unsharded step, to
the JAX package's unsharded step and, once, to the JAX package's sharded
step (``torch_sharded_parity``: the cases, the limits).

The batch holds frames (B, S, D), split over the data ranks as token rows
are.  At ``(2, 1)`` FSDP shards the frame projection's ``"embed"`` dim and
the learned positions' (``models.forward`` gathers them, the positions cut
to the S they add first), and the blocks' as for the dense family; at
``(1, 2)`` the heads, the FFN's hidden dim and the head's vocab split
(the frame projection's ``heads_x_dim`` stays whole).  Cases, each on
``(1, 2)``, ``(2, 1)`` and ``(2, 2)``: fp32 with remat full; fp32 in two
microbatches without remat; bf16 compute.

The control (``(2, 1)``, fp32) gives FSDP's gather a backward without the
sum over the data ranks (each rank keeps its own gradient's slice), and
must fail the limits.

Sequence parallelism: the ``fp32`` case runs again at ``(1, 2)`` and
``(2, 2)`` with the residual stream split over seq (the frame embedding
cut by ``scatter_seq``), held to the case's references and to the case's
sharded run on the mesh.
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

ARCH = "hubert-xlarge"
# name, precision, parallel
CASES = [
    ("fp32", {"compute_dtype": "float32"}, {"remat": "full"}),
    ("fp32-mb2-noremat", {"compute_dtype": "float32"}, {"remat": "none", "num_microbatches": 2}),
    ("bf16", {}, {"remat": "full"}),
]
NAMES = [c[0] for c in CASES]
CONTROLS = {"fsdp_gather_backward_unsummed": ((2, 1), "fp32")}
assert set(CONTROLS) <= set(torch_sharded_ranks.FAMILY_CONTROLS)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    cfgs = configs(ARCH)
    return P.run_family(ARCH, [(name, cfgs, prec, par) for name, prec, par in CASES], CONTROLS,
                        tmp_path_factory.mktemp("jax_sharded_audio"), bridged_case="bf16", sp_of=("fp32",))


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


def test_matches_the_jax_sharded_step(runs):
    """The port at (2, 2) against the JAX package's sharded step; the
    positions and the blocks' projections take the same layout in both,
    the frame projection only the reference's data claim."""
    P.check_jax_sharded(runs)
    port = executed_specs(runs["cfg"], MeshShape({"data": 2, "model": 2}),
                          training_rules(ParallelConfig(remat="full")))["executed"]
    assert P.jax_spec(runs, "embed/pos") == port["embed"]["pos"] == (None, "data")
    assert port["embed"]["frame_proj"] == ("data", None) and P.jax_spec(runs, "embed/frame_proj")[0] == "data"
    for path in ("attn/wq", "attn/wo", "mlp/w_up", "mlp/w_down", "mlp/b_up"):
        node = port["blocks"][0]
        for k in path.split("/"):
            node = node[k]
        assert P.jax_spec(runs, f"blocks/{path}") == node, path


@pytest.mark.parametrize("mesh", P.MESHES, ids=lambda m: f"{m[0]}x{m[1]}")
def test_sharded_bridge_equals_shard_state(runs, mesh):
    assert P.bridged_ok(runs, mesh)


def test_ranks_import_no_jax(runs):
    assert P.jax_free(runs)
