"""Rank functions of the port's sharded-training CPU tests.

``launch.mesh.run_ranks`` runs them in spawned processes, one a rank of a
``(data, model)`` gloo mesh.  This module imports ``torch`` and
``repro_torch`` only, so the ranks never load JAX (each rank reports
whether it did).  Each function runs every case of its test file for one
mesh in one spawn.

A case is a dict: ``cfg`` and ``run`` (the port's configs), ``state`` (the
full train state every rank starts from, on the CPU) and ``batches`` (the
global batches, one a step).  A rank cuts its slices out of the state
(``parallel.sharding.shard_state``), takes the steps on its mesh and
gathers the state back (``unshard_state``), which rank 0 returns.
"""

from __future__ import annotations

import sys

import torch

from repro_torch.core import make_elastic_mesh, plan_resize, reshard_state, resize_batch
from repro_torch.optim import adamw
from repro_torch.parallel import collectives
from repro_torch.parallel.sharding import (
    replicated_leaves,
    shard_state,
    state_shardings,
    training_rules,
    unshard_state,
)
from repro_torch.train import make_train_step
from repro_torch.utils.tree import tree_leaves, tree_paths, tree_size_bytes

# the controls that must fail the limits, each a change to one collective
CONTROLS = ("copy_to_model_backward_dropped", "replicated_leaf_counted_on_every_rank", "int8_scale_from_local_shard")


def _numpy_state(state) -> dict:
    """What the tests compare of a full state, as numpy."""
    out = {k: [t.numpy() for t in tree_leaves(tree)] for k, tree in (("params", state.params), ("m", state.opt.m),
                                                                      ("v", state.opt.v))}
    out["step"] = int(state.opt.step)
    if state.fp8 is not None:
        out["fp8_scale"] = {k: v.numpy() for k, v in state.fp8.scale.items()}
        out["fp8_history"] = {k: v.numpy() for k, v in state.fp8.amax_history.items()}
    return out


def train(case: dict, mesh) -> dict:
    """The case's steps on this rank: metrics a step and (rank 0) the full
    state gathered back."""
    cfg, run = case["cfg"], case["run"]
    rules = training_rules(run.parallel)
    specs = state_shardings(cfg, run, rules, mesh)
    state = shard_state(case["state"], specs, mesh)
    step = make_train_step(cfg, run, rules, mesh)
    metrics = []
    for batch in case["batches"]:
        state, m = step(state, batch)
        metrics.append({k: float(v) for k, v in m.items()})
    full = unshard_state(state, specs, mesh)
    rank = torch.distributed.get_rank()
    return {"metrics": metrics, "state": _numpy_state(full) if rank == 0 else None}


def _control(name: str):
    """Install control ``name`` in this process; returns its undo."""
    if name == "copy_to_model_backward_dropped":
        cls, attr = collectives._CopyToModel, "backward"
        new = staticmethod(lambda ctx, g: (g, None))
    elif name == "replicated_leaf_counted_on_every_rank":
        cls, attr = adamw, "all_reduce_over"
        orig = adamw.all_reduce_over
        new = lambda x, mesh, axes: orig(x, mesh, ("data", "model"))  # noqa: E731
    elif name == "int8_scale_from_local_shard":
        cls, attr = collectives, "all_reduce_max"
        new = lambda x, mesh: x  # noqa: E731
    else:
        raise ValueError(name)
    old = cls.__dict__[attr]
    setattr(cls, attr, new)
    return lambda: setattr(cls, attr, old)


def jax_loaded() -> bool:
    return any(m.split(".")[0] in ("jax", "repro") for m in sys.modules)


def bridged_shard(mesh, case: dict, np_state) -> bool:
    """Whether ``bridge.train_state_from_jax(specs=, mesh=)`` of the numpy
    state ``np_state`` gives this rank's slices of ``case["state"]`` (its
    full bridge) bit for bit."""
    from repro_torch.bridge import train_state_from_jax

    cfg, run = case["cfg"], case["run"]
    specs = state_shardings(cfg, run, training_rules(run.parallel), mesh)
    got = train_state_from_jax(cfg, np_state, "cpu", specs=specs, mesh=mesh)
    ref = shard_state(case["state"], specs, mesh)
    trees = lambda s: (s.params, s.opt.m, s.opt.v, [s.opt.step], s.fp8.scale, s.fp8.amax_history)  # noqa: E731
    return all(torch.equal(a, b) for x, y in zip(trees(got), trees(ref)) for a, b in zip(tree_leaves(x), tree_leaves(y)))


def train_cases(rank, mesh, cases: list, controls: dict, memory_of=None, bridged=None) -> list:
    """Every case of ``test_torch_sharded_train.py`` on this mesh, then
    each control ``{name: case}`` with its change installed, then
    ``memory(*memory_of)`` and ``bridged_shard(*bridged)`` where given;
    last, whether this rank loaded JAX."""
    torch.set_num_threads(1)
    out = [train(case, mesh) for case in cases]
    for name, case in controls.items():
        undo = _control(name)
        try:
            out.append(train(case, mesh))
        finally:
            undo()
    if memory_of is not None:
        out.append(memory(mesh, *memory_of))
    bridge_ok = bridged_shard(mesh, *bridged) if bridged is not None else None
    return out + [{"jax_loaded": jax_loaded(), "bridged_shard": bridge_ok}]


def elastic_shrink(mesh, case: dict, plan_kw: dict, steps_after: int) -> dict:
    """A shrink: the case's first steps on this mesh, then ``plan_resize``
    to the surviving ranks, ``make_elastic_mesh``, ``reshard_state`` onto
    it and the last ``steps_after`` steps on ``resize_batch``'s batches.
    Rank 0 returns the full state before and after the reshard and at the
    end; a rank outside the new mesh returns the plan alone."""
    cfg, run = case["cfg"], case["run"]
    rules = training_rules(run.parallel)
    specs = state_shardings(cfg, run, rules, mesh)
    state = shard_state(case["state"], specs, mesh)
    step = make_train_step(cfg, run, rules, mesh)
    batches = case["batches"]
    losses = []
    for batch in batches[: len(batches) - steps_after]:
        state, m = step(state, batch)
        losses.append(float(m["loss"]))
    before = unshard_state(state, specs, mesh)
    plan = plan_resize(**plan_kw)
    new_mesh = make_elastic_mesh(plan)
    new_specs = state_shardings(cfg, run, rules, new_mesh) if new_mesh is not None else None
    state = reshard_state(state, old_specs=specs, old_mesh=mesh, new_specs=new_specs, new_mesh=new_mesh)
    out = {"plan": plan, "mesh": None if new_mesh is None else tuple(new_mesh.shape)}
    if new_mesh is None:
        return out
    after = unshard_state(state, new_specs, new_mesh)
    step = make_train_step(cfg, run, rules, new_mesh)
    sizes = []
    for batch in batches[len(batches) - steps_after:]:
        small = resize_batch(batch, plan)
        sizes.append(int(small["labels"].shape[0]))
        state, m = step(state, small)
        losses.append(float(m["loss"]))
    end = unshard_state(state, new_specs, new_mesh)
    if torch.distributed.get_rank() == 0:
        out.update(before=_numpy_state(before), after=_numpy_state(after), end=_numpy_state(end))
    out.update(losses=losses, sizes=sizes)
    return out


def elastic_cases(rank, mesh, shares: list, shrinks: list) -> dict:
    """``test_torch_elastic.py`` on a 4-rank world: the tenant meshes of
    ``shares`` (``tenant_meshes``), then each ``(case, plan_kw,
    steps_after)`` of ``shrinks`` (``elastic_shrink``); every rank waits
    for the others at the end, so none leaves while the survivors step."""
    torch.set_num_threads(1)
    out = {"tenants": tenant_meshes(shares), "shrinks": [elastic_shrink(mesh, *s) for s in shrinks]}
    torch.distributed.barrier()
    return dict(out, jax_loaded=jax_loaded())


def tenant_meshes(shares: list) -> list:
    """``TenantManager.make_tenant_mesh`` on this rank of a 4-rank world for
    each ``(nodes_of_tenant, total_nodes, model_parallel)``: the mesh's
    shape and this rank's coordinate, or the error's type and text."""
    from repro_torch import core

    out = []
    for tenant_nodes, total, mp in shares:
        cluster = core.Cluster(core.ClusterSpec("t", nodes_per_pod=total, num_pods=1))
        iam = core.IAM(clock=lambda: 0.0)
        tok = iam.federated_login("ops", "uob")
        iam.grant("ops", core.Role.INFRA_ADMIN)
        mgr = core.TenantManager(cluster, iam)
        mgr.create_tenant("t1", quota_nodes=tenant_nodes, admin="a", token=tok)
        mgr.grow_tenant("t1", tenant_nodes, token=tok)
        try:
            m = mgr.make_tenant_mesh("t1", model_parallel=mp)
            got = None if m is None else (tuple(m.mesh_dim_names), tuple(m.shape), m.get_coordinate())
        except ValueError as e:
            got = ("ValueError", str(e))
        out.append(got)
    return out


def memory(mesh, cfg, run) -> dict:
    """The bytes of params, m and v a rank holds of a fresh state, against
    the full state's, and the leaves no axis shards."""
    from repro_torch.train import init_train_state

    full = init_train_state(cfg, run, 0, device="cpu")
    rules = training_rules(run.parallel)
    local = init_train_state(cfg, run, 0, device="cpu", rules=rules, mesh=mesh)
    specs = state_shardings(cfg, run, rules, mesh)
    reps = replicated_leaves(specs.params, mesh)
    rep_bytes = sum(t.numel() * t.element_size() for p, t in zip(_paths(specs.params), tree_leaves(full.params))
                    if p in reps)
    trees = lambda s: (s.params, s.opt.m, s.opt.v)  # noqa: E731
    same = all(torch.equal(a, b) for a, b in zip(tree_leaves(shard_state(full, specs, mesh).params),
                                                 tree_leaves(local.params)))
    return {"local": [tree_size_bytes(t) for t in trees(local)], "full": [tree_size_bytes(t) for t in trees(full)],
            "replicated": reps, "replicated_param_bytes": rep_bytes, "init_equals_shard": same}


def _paths(tree) -> list[str]:
    return ["/".join(map(str, p)) for p in tree_paths(tree)]


def cuda_checks(rank, mesh, device="cuda") -> dict:
    """``test_torch_cuda_sharded_train.py`` on one rank of a ``(1, 2)`` gloo
    mesh on the card: K4 on this rank's column slice of ``w_up`` and, for
    ``w_down``'s input gradient, on the transposed row slice, against the
    plain GEMM; then the smoke olmo-1b's TP=2 step (fp8 through K4) over 3
    steps, and the same steps at TP=1 on rank 0 first, from one state.
    ``device="cpu"`` rehearses it (K4's plain version, no launches)."""
    from repro_torch.config import ParallelConfig, PrecisionConfig, RunConfig, TrainConfig, reduce_for_smoke
    from repro_torch.configs import get_config
    from repro_torch.data import synthetic_batch
    from repro_torch.fp8 import E4M3, E5M2, compute_scale, fp8_gemm, fp8_gemm_plain, quantize, tensor_amax
    from repro_torch.fp8 import gemm as K4
    from repro_torch.train import init_train_state
    from repro_torch.utils.tree import tree_map

    torch.set_num_threads(1)
    cfg = reduce_for_smoke(get_config("olmo-1b"))
    run = RunConfig(arch="olmo-1b", train=TrainConfig(global_batch=4, seq_len=32, learning_rate=1e-3, warmup_steps=0,
                                                      total_steps=10),
                    parallel=ParallelConfig(remat="full"), precision=PrecisionConfig(fp8=True, fp8_gemm="kernel"))
    full = init_train_state(cfg, run, 0, device=device)
    rules = training_rules(run.parallel)
    specs = state_shardings(cfg, run, rules, mesh)
    local = shard_state(full, specs, mesh)
    mlp = local.params["blocks"][0]["mlp"]
    g = torch.Generator(device=device).manual_seed(rank)
    x, dy = (torch.randn((128, cfg.d_model), generator=g, device=device) for _ in range(2))

    def q(t, dtype):
        s = compute_scale(tensor_amax(t), dtype)
        return quantize(t, s, dtype), s

    (qx, sx), (qu, su), (qg, sg), (qd, sd) = q(x, E4M3), q(mlp["w_up"], E4M3), q(dy, E5M2), q(mlp["w_down"], E4M3)
    K4.reset_launches()
    errs = {}
    for name, (a, b, sa, sb) in {"ffn_up": (qx, qu, sx, su), "ffn_down_dx": (qg, qd.T, sg, sd)}.items():
        ref = fp8_gemm_plain(a, b, sa, sb)
        errs[name] = float((fp8_gemm(a, b, sa, sb) - ref).abs().max() / ref.abs().max())
    kernel_launches = K4.LAUNCHES["fp8_gemm"]
    batches = [synthetic_batch(cfg, step=s, global_batch=4, seq_len=32, device=device) for s in range(3)]
    tp1 = None
    if rank == 0:
        copy = lambda tree: tree_map(torch.clone, tree)  # noqa: E731  (the step updates in place)
        state = full._replace(params=copy(full.params), opt=full.opt._replace(m=copy(full.opt.m), v=copy(full.opt.v)))
        step = make_train_step(cfg, run)
        metrics = []
        for b in batches:
            state, m = step(state, b)
            metrics.append({k: float(v) for k, v in m.items()})
        tp1 = {"metrics": metrics, "params": [t.cpu().numpy() for t in tree_leaves(state.params)]}
    torch.distributed.barrier()
    K4.reset_launches()
    step = make_train_step(cfg, run, rules, mesh)
    metrics = []
    for b in batches:
        local, m = step(local, b)
        metrics.append({k: float(v) for k, v in m.items()})
    gathered = unshard_state(local, specs, mesh)
    return {"local_mlp": (tuple(mlp["w_up"].shape), tuple(mlp["w_down"].shape)), "k4_errs": errs,
            "kernel_launches": kernel_launches, "tp1": tp1, "step_launches": K4.LAUNCHES["fp8_gemm"],
            "tp2": {"metrics": metrics, "params": [t.cpu().numpy() for t in tree_leaves(gathered.params)]},
            "jax_loaded": jax_loaded()}
