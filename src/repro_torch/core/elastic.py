"""Elastic scaling: re-mesh and re-shard a live job when capacity changes.

The JAX package's ``core/elastic.py`` on the port's meshes.  Paper §III.F
lists elasticity as a first-class AI-platform requirement.  For a job
sharded over ``torch.distributed`` ranks that means: pick a new ``(data,
model)`` mesh for the surviving ranks, keep the per-rank batch constant
(the global batch scales with capacity, the standard elastic-training
contract), and move every state leaf onto the new layout.  Re-sharding
moves only data: the parameters, moments and fp8 state are resharded, not
re-initialized, so the resharded state's full leaves equal the old ones
bit for bit and training continues as one card would continue it on the
resized batches (``tests/test_torch_elastic.py``).

``ElasticPlan``, ``plan_resize`` and ``resize_batch`` are the JAX
package's; ``make_elastic_mesh`` carves the plan's mesh out of the world's
ranks (``launch.mesh.make_submesh``) and ``reshard_state`` gathers the
full state over the old mesh and keeps each survivor's slices of it
(``parallel.sharding.unshard_state`` / ``shard_state``).
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.distributed as dist

from repro_torch.launch.mesh import make_submesh
from repro_torch.parallel.sharding import shard_state, unshard_state
from repro_torch.utils.tree import tree_map


@dataclass(frozen=True)
class ElasticPlan:
    old_chips: int
    new_chips: int
    data: int  # new data-parallel degree
    model: int  # new model-parallel degree
    old_global_batch: int
    new_global_batch: int

    @property
    def shape(self) -> tuple[int, int]:
        return (self.data, self.model)


def plan_resize(
    *,
    old_chips: int,
    new_chips: int,
    model_parallel: int,
    global_batch: int,
    batch_divisor: int = 1,
) -> ElasticPlan:
    """Choose the largest usable mesh on the new capacity.

    Keeps the model-parallel degree (sharding the model differently would
    need a full re-layout); data-parallel shrinks to what fits; per-chip
    batch stays constant so step time is unchanged and throughput scales
    with capacity.
    """
    if new_chips < model_parallel:
        raise ValueError(f"cannot fit model_parallel={model_parallel} on {new_chips} chips")
    data = new_chips // model_parallel
    # keep global batch divisible by the new data degree (and any divisor)
    per_data = max(global_batch // max(old_chips // model_parallel, 1), 1)
    new_batch = max(per_data * data, batch_divisor)
    new_batch -= new_batch % max(batch_divisor, 1)
    return ElasticPlan(
        old_chips=old_chips,
        new_chips=new_chips,
        data=data,
        model=model_parallel,
        old_global_batch=global_batch,
        new_global_batch=max(new_batch, batch_divisor),
    )


def make_elastic_mesh(plan: ElasticPlan):
    """The plan's ``(data, model)`` mesh over the first ranks of the
    initialized process group.  Every rank of the world calls it; a rank
    outside the mesh gets None.  A world with fewer ranks than the plan
    takes the plan tiled onto what exists, as the JAX package tiles it onto
    the devices of a CPU test host."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    need = plan.data * plan.model
    if world < need:
        data = max(world // plan.model, 1)
        return make_submesh(data, min(plan.model, world))
    return make_submesh(plan.data, plan.model)


def reshard_state(state, *, old_specs, old_mesh, new_specs, new_mesh):
    """Move a sharded train state onto a new mesh (data motion only).

    Every rank of ``old_mesh`` calls it with its slices (``old_specs``:
    ``parallel.sharding.state_shardings`` on the old mesh): the full state
    is gathered on each, and each rank of ``new_mesh`` keeps its slices
    under ``new_specs``; a rank outside the new mesh (``new_mesh`` None)
    gets None.  Every rank of the new mesh must hold a slice of the old
    one: a job that grows restores from a checkpoint instead."""
    if state is None:
        raise ValueError("reshard_state needs this rank's slices of the old state")
    full = unshard_state(state, old_specs, old_mesh)
    if new_mesh is None:
        return None
    return shard_state(full, new_specs, new_mesh)


def resize_batch(batch, plan: ElasticPlan):
    """Shrink/grow the global batch to the plan (drop or repeat tail)."""

    def fix(x):
        b = x.shape[0]
        if b == plan.new_global_batch:
            return x
        if b > plan.new_global_batch:
            return x[: plan.new_global_batch]
        reps = -(-plan.new_global_batch // b)
        return torch.cat([x] * reps, dim=0)[: plan.new_global_batch]

    return tree_map(fix, batch)
