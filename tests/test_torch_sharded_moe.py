"""Sharded and FSDP training of the moe family over gloo ranks on the CPU
(smoke qwen3-moe-235b-a22b: 4 experts, top 2, capacity factor 1.25,
groups of 64 tokens), held to the port's unsharded step, to the JAX
package's unsharded step and, once, to the JAX package's sharded step
(``torch_sharded_parity``: the cases, the limits).

On ``(1, 2)`` each rank runs 2 of the 4 experts (expert parallelism: the
``"expert"`` dim claims ``"model"`` first), the attention's heads and half
the vocab; on ``(2, 1)`` FSDP shards every ``"embed"`` dim over the data
ranks (the router, the experts' ``w_up``/``w_gate``/``w_down``, the
attention, the norms), and the experts' hidden dim stays whole; ``(2, 2)``
does both.  Cases, each on every mesh:

* ``fp32``: 4 x 32 tokens, one microbatch: 128 tokens, two groups of 64,
  one a data rank at ``(2, 1)``;
* ``fp32-mb2-spanning``: 4 x 32 tokens in 2 microbatches: each microbatch
  routes one group of 64 tokens, whose rows sit on two data ranks at
  ``(2, 1)`` and ``(2, 2)`` (trap 2 of ``models.moe``: the capacity, each
  token's slot and the aux come from the global group); capacity binds
  there (the port's unsharded run drops pairs, counted);
* ``bf16``: bf16 compute, one microbatch (FSDP casts the experts to bf16
  before it gathers them).

The ``fp32`` case runs at the capacity factor E / k, where capacity cannot
bind, as ``test_torch_moe_train.py``'s fp32 case does: with capacity
binding, a near tie flipped by the two frameworks' sum orders moves every
later token's slot in two experts, and parts the JAX and port steps past
the fp32 limits (at cf 1.25 this case's embedding rows part from the JAX
step's by 3.4e-6 in the port's unsharded step already).  The spanning case
routes at cf 1.25, where capacity binds (the port's unsharded run drops
pairs, counted), and holds the fp32 limits against both steps.

Three controls, each one change, must fail the limits their case passes:
the gates' ``copy_to_model`` left out (``(1, 2)``, fp32: the router's
gradient through the gates keeps one rank's pairs), each data rank
counting its slots from 0 (``(2, 1)``, the spanning case: pairs that the
global order drops are kept), and the aux's sum over data with the
identity backward (``(2, 1)``, the spanning case: the router's aux
gradient comes out half the reference's).  The ``(2, 1)`` ranks also
shrink to one rank after two fp32 steps (``core.elastic``): the state
reshards bit for bit and one more step stays within the fp32 limits of
the unsharded run on the resized batch.

Sequence parallelism (``ParallelConfig(sequence_parallel=True)``): the
``fp32`` and spanning cases run again at ``(1, 2)`` and ``(2, 2)`` with the
residual stream split over seq between the blocks; each layer gathers its
tokens before the router (computed whole on every rank), so the routing
order, capacity and aux are the sharded run's, and the combine is
reduce-scattered.  Each is held to the
references of its case and to its case's sharded run on the mesh, and the
fp32 steps at ``(2, 2)`` to the JAX package's sharded step with sequence
parallelism.
"""

import dataclasses

import pytest
import torch

import torch_sharded_parity as P
import torch_sharded_ranks
from repro_torch.config import ParallelConfig
from repro_torch.launch.mesh import MeshShape
from repro_torch.models import moe
from repro_torch.parallel.sharding import executed_specs, training_rules
from torch_parity import configs

torch.set_num_threads(2)

ARCH = "qwen3-moe-235b-a22b"
UNBOUND = None  # the capacity factor E / k: every expert takes a whole group
# name, capacity factor, precision, parallel
CASES = [
    ("fp32", UNBOUND, {"compute_dtype": "float32"}, {"remat": "full"}),
    ("fp32-mb2-spanning", 1.25, {"compute_dtype": "float32"}, {"remat": "full", "num_microbatches": 2}),
    ("bf16", 1.25, {}, {"remat": "full"}),
]
NAMES = [c[0] for c in CASES]
# control -> (mesh, the case it runs)
CONTROLS = {
    "moe_gates_sum_dropped": ((1, 2), "fp32"),
    "moe_capacity_per_data_rank": ((2, 1), "fp32-mb2-spanning"),
    "moe_aux_data_sum_identity_backward": ((2, 1), "fp32-mb2-spanning"),
}
assert set(CONTROLS) <= set(torch_sharded_ranks.FAMILY_CONTROLS)


def _configs(cf=1.25):
    """The smoke configs at capacity factor ``cf`` (``UNBOUND``: E / k)."""
    jcfg, tcfg = configs(ARCH)
    cf = jcfg.moe.num_experts / jcfg.moe.top_k if cf is UNBOUND else cf
    return tuple(c.replace(moe=dataclasses.replace(c.moe, capacity_factor=cf)) for c in (jcfg, tcfg))


class _Drops:
    """Counts the pairs ``moe.route`` routes and drops while active."""

    def __enter__(self):
        self.pairs = self.dropped = 0
        self.inner = moe.route

        def counting(cfg, router_w, xg):
            r = self.inner(cfg, router_w, xg)
            self.pairs += r.keep.numel()
            self.dropped += int((~r.keep).sum())
            return r

        moe.route = counting
        return self

    def __exit__(self, *exc):
        moe.route = self.inner


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    cases = [(name, _configs(cf), prec, par) for name, cf, prec, par in CASES]
    # the JAX sharded run routes at the smoke cf 1.25: cases[1]'s configs first
    return P.run_family(ARCH, [cases[1], cases[0], cases[2]], CONTROLS, tmp_path_factory.mktemp("jax_sharded_moe"),
                        bridged_case="fp32-mb2-spanning", shrink_case="fp32", wrap=_Drops,
                        sp_of=("fp32", "fp32-mb2-spanning"), jax_sp=True)


@pytest.mark.parametrize("mesh", P.MESHES, ids=lambda m: f"{m[0]}x{m[1]}")
@pytest.mark.parametrize("name", NAMES)
def test_sharded_step_matches_the_unsharded_steps(runs, name, mesh):
    """Loss, aux loss, gradient norm and every gathered parameter after
    three steps within the case's limits of the port's unsharded step and
    of the JAX package's; every rank reads the same metrics."""
    P.check_step(runs, name, mesh)


def test_spanning_case_spans_the_data_ranks():
    """The spanning case's microbatch of 2 x 32 tokens routes as one group
    of 64 tokens with 40 slots an expert, whose rows sit 32 a rank on two
    data ranks."""
    m = _configs()[1].moe
    T_global = P.B // 2 * P.S
    assert moe.group_len(m, T_global) == T_global == 64 and moe.capacity(m, 64) == 40


def test_capacity_binds_in_the_spanning_case(runs):
    d = runs["wrapped"]["fp32-mb2-spanning"]
    assert d.pairs > 0 and d.dropped > 0, "capacity must bind in this case"


@pytest.mark.parametrize("control", list(CONTROLS))
def test_controls_fail_the_limits(runs, control):
    P.check_control(runs, control)


@pytest.mark.parametrize("mesh", P.SP_MESHES, ids=lambda m: f"{m[0]}x{m[1]}")
@pytest.mark.parametrize("name", ["fp32", "fp32-mb2-spanning"])
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


def test_matches_the_jax_sharded_step(runs):
    """The port at (2, 2) against the JAX package's sharded step, and the
    expert layout both execute: experts over "model", their embed dim over
    "data", their hidden dim whole (the reference's rule with fsdp on)."""
    P.check_jax_sharded(runs)
    port = executed_specs(runs["cfg"], MeshShape({"data": 2, "model": 2}),
                          training_rules(ParallelConfig(remat="full")))["executed"]["blocks"][0]["moe"]
    for leaf in ("w_up", "w_gate", "w_down"):
        assert P.jax_spec(runs, f"blocks/moe/{leaf}") == port[leaf], leaf
    assert port["w_up"] == ("model", "data", None) and port["w_down"] == ("model", None, "data")


def test_shrink_reshards_bit_for_bit(runs):
    """(2, 1) -> one rank after two fp32 steps (``core.elastic``)."""
    P.check_shrink(runs)


@pytest.mark.parametrize("mesh", P.MESHES, ids=lambda m: f"{m[0]}x{m[1]}")
def test_sharded_bridge_equals_shard_state(runs, mesh):
    assert P.bridged_ok(runs, mesh)


def test_ranks_import_no_jax(runs):
    assert P.jax_free(runs)
