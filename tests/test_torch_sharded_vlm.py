"""Sharded and FSDP training of the vlm family over gloo ranks on the CPU
(smoke llama-3.2-vision-90b: one layer group of 4 self layers and a cross
layer over 8 image tokens, 4 heads over 2 kv heads), held to the port's
unsharded step, to the JAX package's unsharded step and, once, to the JAX
package's sharded step (``torch_sharded_parity``: the cases, the limits).

Random init sets the cross layers' ``gate`` and ``gate_mlp`` to 0, which
makes them the identity and gives their projections no gradient: every
case opens them to 1.0 in the JAX state before its first step
(``run_family(gates=)``).  The self and cross layers split their heads
and the FFN's hidden dim over ``"model"`` (the cross layer's query input
through ``copy_to_model``; the image tokens carry no gradient), the gates
stay whole; at ``(2, 1)`` FSDP shards every ``"embed"`` dim, each self
layer and the cross layer gathered by its own spec of the group.  The
image tokens are split over the data ranks by rows with the tokens.
Cases, each on ``(1, 2)``, ``(2, 1)`` and ``(2, 2)``: fp32 with remat full;
fp32 in two microbatches without remat; bf16 compute.

The control (``(1, 2)``, fp32) leaves out the cross layer's query
``copy_to_model``: the residual then keeps one rank's heads' part of the
cross attention's input gradient, and must fail the limits.  The ``(2,
1)`` ranks also shrink to one rank after two fp32 steps (``core.elastic``).

Sequence parallelism: the ``fp32`` case runs again at ``(1, 2)`` and
``(2, 2)`` with the residual stream split over seq (the cross layers
gather their query input; the image tokens stay whole; the gates act on
the slice and sum their gradients), held to the case's references and to
the case's sharded run on the mesh.
"""

import pytest
import torch

import torch_sharded_parity as P
import torch_sharded_ranks
from torch_parity import configs

torch.set_num_threads(2)

ARCH = "llama-3.2-vision-90b"
GATES = 1.0
# name, precision, parallel
CASES = [
    ("fp32", {"compute_dtype": "float32"}, {"remat": "full"}),
    ("fp32-mb2-noremat", {"compute_dtype": "float32"}, {"remat": "none", "num_microbatches": 2}),
    ("bf16", {}, {"remat": "full"}),
]
NAMES = [c[0] for c in CASES]
CONTROLS = {"vlm_cross_query_sum_dropped": ((1, 2), "fp32")}
assert set(CONTROLS) <= set(torch_sharded_ranks.FAMILY_CONTROLS)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    cfgs = configs(ARCH)
    return P.run_family(ARCH, [(name, cfgs, prec, par) for name, prec, par in CASES], CONTROLS,
                        tmp_path_factory.mktemp("jax_sharded_vlm"), bridged_case="bf16", shrink_case="fp32",
                        gates=GATES, sp_of=("fp32",))


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


def test_gates_are_open(runs):
    """The cases start from opened gates, and the steps move them."""
    paths, start = runs["paths"], runs["befores"]["fp32"]
    gates = [i for i, p in enumerate(paths) if p.endswith("/gate") or p.endswith("/gate_mlp")]
    assert len(gates) == 2 and all(float(start[i][0]) == GATES for i in gates)
    end = runs["refs"]["fp32"][1]["params"]
    assert all(float(end[i][0]) != GATES for i in gates)


def test_matches_the_jax_sharded_step(runs):
    """The port at (2, 2) against the JAX package's sharded step; every
    leaf of the self and cross layers takes the JAX package's spec, the
    heads split in both (no claim of "model" is left whole)."""
    P.check_jax_sharded(runs)
    assert P.check_specs_against_jax(runs) == {}
    assert P.jax_spec(runs, "blocks/cross/attn/wq") == ("data", "model", None)
    assert P.jax_spec(runs, "blocks/self/attn/wo") == ("model", None, "data")
    assert P.jax_spec(runs, "blocks/cross/gate_mlp") == (None,)


def test_shrink_reshards_bit_for_bit(runs):
    P.check_shrink(runs)


@pytest.mark.parametrize("mesh", P.MESHES, ids=lambda m: f"{m[0]}x{m[1]}")
def test_sharded_bridge_equals_shard_state(runs, mesh):
    assert P.bridged_ok(runs, mesh)


def test_ranks_import_no_jax(runs):
    assert P.jax_free(runs)
