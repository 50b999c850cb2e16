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
# sequence parallelism's controls (test_torch_sequence_parallel.py)
SP_CONTROLS = (
    "sp_norm_scale_sum_dropped",  # a norm's scale and bias on the seq slice without their copy_to_model
    "sp_reduce_scatter_unsummed",  # reduce_scatter_seq as a plain slice of this rank's partial output
)
# the moe, hybrid, audio, ssm and vlm families' controls (test_torch_sharded_<family>.py)
FAMILY_CONTROLS = (
    "moe_gates_sum_dropped",  # the gates' copy_to_model left out: their gradient keeps this rank's pairs only
    "moe_capacity_per_data_rank",  # each data rank counts its experts' slots from 0 in a spanning group
    "moe_aux_data_sum_identity_backward",  # the aux's sum over data with the identity backward
    "hybrid_branches_counted_twice",  # the FFN input's copy_to_model moved to the block input
    "fsdp_gather_backward_unsummed",  # FSDP's gather backward keeps this rank's own gradient slice
    "ssm_time_mix_summed_twice",  # the channel mix's copy_to_model moved to the block input
    "vlm_cross_query_sum_dropped",  # the cross layers' query input without its copy_to_model
    # under sequence parallelism, the whole time mix's output gradient not gathered (scatter_seq's backward keeps
    # this rank's slice), so its leaves keep this rank's share of their gradients, unsummed
    "ssm_time_mix_leaves_unsummed",
)
# the "grouped" attention layout's controls (test_torch_grouped_heads.py)
GROUPED_CONTROLS = (
    "grouped_kv_head_rank_mod_kv",  # rank r attends over kv head r % KV, not its group's r // (tp / KV)
    "grouped_kv_slice_unsummed",  # the rank's kv head of wk / wv sliced without copy_to_model
)


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
    """The case's steps on this rank: metrics a step, the training
    collectives the steps issued (``TRAIN_COLLECTIVES``, calls only) and
    (rank 0) the full state gathered back."""
    cfg, run = case["cfg"], case["run"]
    rules = training_rules(run.parallel)
    specs = state_shardings(cfg, run, rules, mesh)
    state = shard_state(case["state"], specs, mesh)
    step = make_train_step(cfg, run, rules, mesh)
    metrics = []
    collectives.reset_collectives()
    for batch in case["batches"]:
        state, m = step(state, batch)
        metrics.append({k: float(v) for k, v in m.items()})
    issued = {k: v for k, v in collectives.TRAIN_COLLECTIVES.items() if v and not k.endswith("_bytes")}
    full = unshard_state(state, specs, mesh)
    rank = torch.distributed.get_rank()
    return {"metrics": metrics, "collectives": issued, "state": _numpy_state(full) if rank == 0 else None}


def _input_summed(block):
    """``block`` with its input through ``copy_to_model``: the gradient of
    the branches each rank computes whole (hymba's attention and SSM
    heads, rwkv6's time mix) and of the residual summed over the model
    ranks, which hold it whole already."""
    from repro_torch.parallel.collectives import copy_to_model

    def wrapped(cfg, p, x, *, mesh=None, **kw):
        return block(cfg, p, copy_to_model(x, mesh), mesh=mesh, **kw)

    return wrapped


def _ungathered_scatter_backward(ctx, g):
    """``scatter_seq``'s backward without the all-gather: this rank's
    slice of the gradient, zeros elsewhere."""
    out = g.new_zeros(g.shape[:1] + (g.shape[1] * ctx.n,) + g.shape[2:])
    s = g.shape[1]
    out.narrow(1, torch.distributed.get_rank(ctx.group) * s, s).copy_(g)
    return out, None, None


def _unsummed_reduce_scatter(ctx, x, group, n):
    """``reduce_scatter_seq``'s forward without the sum: this rank's slice
    of its own partial output."""
    ctx.group, ctx.n = group, n
    s = x.shape[1] // n
    return x.narrow(1, torch.distributed.get_rank(group) * s, s).contiguous()


def _unsummed_gather_backward(ctx, g):
    n = g.shape[ctx.dim] // ctx.n
    return g.narrow(ctx.dim, torch.distributed.get_rank(ctx.group) * n, n).contiguous(), None, None, None


def _family_control(name: str, case: dict):
    """(owner, attribute, replacement) of a family control; a control
    needing two changes returns a list of them."""
    from repro_torch.models import attention as attn_mod
    from repro_torch.models import ffn as ffn_mod
    from repro_torch.models import model as model_mod
    from repro_torch.models import moe as moe_mod
    from repro_torch.models import rwkv as rwkv_mod

    if name == "moe_gates_sum_dropped":
        k, inner = case["cfg"].moe.top_k, moe_mod.copy_to_model
        return [(moe_mod, "copy_to_model", lambda x, mesh: x if x.shape[-1] == k else inner(x, mesh))]
    if name == "moe_capacity_per_data_rank":
        return [(moe_mod, "lower_ranks", lambda counts, rank: torch.zeros_like(counts[0]))]
    if name == "moe_aux_data_sum_identity_backward":
        return [(collectives._SumOverData, "backward", staticmethod(lambda ctx, g: (g, None)))]
    if name == "hybrid_branches_counted_twice":
        blocks = dict(model_mod.TRAIN_BLOCKS, hybrid=_input_summed(model_mod.TRAIN_BLOCKS["hybrid"]))
        return [(ffn_mod, "copy_to_model", lambda x, mesh: x), (model_mod, "TRAIN_BLOCKS", blocks)]
    if name == "ssm_time_mix_summed_twice":
        blocks = dict(model_mod.TRAIN_BLOCKS, ssm=_input_summed(model_mod.TRAIN_BLOCKS["ssm"]))
        return [(rwkv_mod, "copy_to_model", lambda x, mesh: x), (model_mod, "TRAIN_BLOCKS", blocks)]
    if name == "vlm_cross_query_sum_dropped":
        inner = attn_mod._qkv

        def qkv(cfg, p, x, kv_x=None, fp8=None, mesh=None, sp=False):
            return inner(cfg, p, x, kv_x, fp8, mesh if kv_x is None else None, sp)

        return [(attn_mod, "_qkv", qkv)]
    if name == "ssm_time_mix_leaves_unsummed":  # rwkv6's only scatter_seq: its vocab splits
        return [(collectives._ScatterSeq, "backward", staticmethod(_ungathered_scatter_backward))]
    if name == "fsdp_gather_backward_unsummed":
        return [(collectives._GatherOverData, "backward", staticmethod(_unsummed_gather_backward))]
    if name == "grouped_kv_head_rank_mod_kv":
        from repro_torch.parallel.sharding import model_rank

        return [(attn_mod, "kv_group", lambda cfg, mesh: model_rank(mesh) % cfg.num_kv_heads)]
    if name == "grouped_kv_slice_unsummed":
        inner = attn_mod._kv_weights

        def unsummed(cfg, p, mesh, whole_kv):
            summed, attn_mod.copy_to_model = attn_mod.copy_to_model, lambda x, mesh: x
            try:
                return inner(cfg, p, mesh, whole_kv)
            finally:
                attn_mod.copy_to_model = summed

        return [(attn_mod, "_kv_weights", unsummed)]
    raise ValueError(name)


def _control(name: str, case: dict):
    """Install control ``name`` in this process; returns its undo."""
    if name in FAMILY_CONTROLS + GROUPED_CONTROLS:
        changes = _family_control(name, case)
        kept = [(owner, attr, owner.__dict__[attr]) for owner, attr, _ in changes]
        for owner, attr, new in changes:
            setattr(owner, attr, new)
        return lambda: [setattr(owner, attr, old) for owner, attr, old in kept]
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
    elif name == "sp_norm_scale_sum_dropped":
        from repro_torch.models import layers

        cls, attr = layers, "copy_leaves_to_model"
        new = lambda tree, mesh, names=None: tree  # noqa: E731
    elif name == "sp_reduce_scatter_unsummed":
        cls, attr = collectives._ReduceScatterSeq, "forward"
        new = staticmethod(_unsummed_reduce_scatter)
    else:
        raise ValueError(name)
    old = cls.__dict__[attr]
    setattr(cls, attr, new)
    return lambda: setattr(cls, attr, old)


def large_state(rank, mesh, n: int, shape: tuple) -> list:
    """``n`` fp32 tensors of ``shape`` drawn from a generator seeded with
    the rank: what ``test_torch_collectives.py`` holds ``run_ranks``'s
    results to."""
    g = torch.Generator().manual_seed(rank)
    return [torch.randn(shape, generator=g) for _ in range(n)]


def data_primitives(rank, mesh) -> dict:
    """``test_torch_collectives.py``'s data-axis pair on a (2, 1) mesh:
    ``sum_over_data`` forward and backward, ``exchange_counts``, and the
    counters they add."""
    collectives.reset_collectives()
    x = torch.tensor([1.0, 2.0]) * (rank + 1)
    x.requires_grad_(True)
    y = collectives.sum_over_data(x, mesh)
    (g,) = torch.autograd.grad(y, x, grad_outputs=torch.full((2,), float(rank + 1)))
    counts = collectives.exchange_counts(torch.eye(2, dtype=torch.int32) * (rank + 1), mesh)
    return {"sum": y.tolist(), "grad": g.tolist(), "counts": counts.tolist(), "counts_dtype": str(counts.dtype),
            "collectives": {k: v for k, v in collectives.TRAIN_COLLECTIVES.items() if v}}


def seq_primitives(rank, mesh) -> dict:
    """``test_torch_sequence_parallel.py``'s sequence collectives on a
    ``(1, 2)`` mesh (``whole_seq``: ``SeqGather``'s ``whole()`` view): each
    one's output and its input's gradient, fp32, on
    inputs and output gradients made from the rank (``seq_inputs``), with
    the collectives each issued."""
    out = {}
    for name in ("gather_seq", "whole_seq", "reduce_scatter_seq", "scatter_seq"):
        collectives.reset_collectives()
        x, g = seq_inputs(name, rank)
        x.requires_grad_(True)
        y = collectives.SeqGather(x, mesh).whole() if name == "whole_seq" else getattr(collectives, name)(x, mesh)
        (gx,) = torch.autograd.grad(y, x, grad_outputs=g)
        out[name] = {"y": y.detach().numpy(), "grad": gx.numpy(),
                     "collectives": {k: v for k, v in collectives.TRAIN_COLLECTIVES.items() if v}}
    return out


# the sequence collectives' test shapes: batch, slice length, width, ranks
SEQ_B, SEQ_SL, SEQ_D, SEQ_N = 2, 3, 4, 2


def seq_inputs(name: str, rank: int) -> tuple:
    """(input, output gradient) of collective ``name`` on ``rank``: the
    slice (B, SL, D) in and the whole sequence out for ``gather_seq`` and
    ``whole_seq`` (``SeqGather.whole``), the whole sequence in and the
    slice out for ``reduce_scatter_seq`` and ``scatter_seq``; distinct
    integers scaled by the rank, so every sum is exact."""
    whole = (SEQ_B, SEQ_SL * SEQ_N, SEQ_D)
    part = (SEQ_B, SEQ_SL, SEQ_D)
    shape_in, shape_out = {"gather_seq": (part, whole), "whole_seq": (part, whole),
                           "reduce_scatter_seq": (whole, part), "scatter_seq": (whole, part)}[name]
    make = lambda shape, k: torch.arange(float(torch.Size(shape).numel())).reshape(shape) * (rank + 1) + k  # noqa: E731
    return make(shape_in, 0.0), make(shape_out, 100.0)


def sp_eval(mesh, cfg, params, batch, kw: dict) -> dict:
    """A sharded eval under sequence parallelism: ``loss_fn`` of this
    rank's slices of the full ``params`` (``shard_params`` by the executed
    layout) on ``batch`` without gradients, ``kw`` its keywords (the
    attention and scan impls, the compute dtype)."""
    from repro_torch.config import ParallelConfig
    from repro_torch.parallel.sharding import executed_specs, shard_params
    from repro_torch.train import loss_fn

    rules = training_rules(ParallelConfig(sequence_parallel=True))
    local = shard_params(cfg, params, executed_specs(cfg, mesh, rules)["executed"], mesh)
    with torch.no_grad():
        loss, _ = loss_fn(cfg, local, batch, mesh=mesh, sequence_parallel=True, **kw)
    return {"loss": float(loss)}


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
    fp8 = lambda s: () if s.fp8 is None else (s.fp8.scale, s.fp8.amax_history)  # noqa: E731
    trees = lambda s: (s.params, s.opt.m, s.opt.v, [s.opt.step], *fp8(s))  # noqa: E731
    return all(torch.equal(a, b) for x, y in zip(trees(got), trees(ref)) for a, b in zip(tree_leaves(x), tree_leaves(y)))


def train_cases(rank, mesh, cases: list, controls: dict, memory_of=None, bridged=None, shrinks=(), evals=()) -> list:
    """Every case of a sharded-training test file on this mesh, then each
    control ``{name: case}`` with its change installed, then
    ``memory(*memory_of)`` where given and ``elastic_shrink(mesh, *s)`` for
    each of ``shrinks``, then ``sp_eval(mesh, *e)`` for each of ``evals``,
    then ``bridged_shard(*bridged)`` where given; last, whether this rank
    loaded JAX."""
    torch.set_num_threads(1)
    out = [train(case, mesh) for case in cases]
    for name, case in controls.items():
        undo = _control(name, case)
        try:
            out.append(train(case, mesh))
        finally:
            undo()
    if memory_of is not None:
        out.append(memory(mesh, *memory_of))
    out += [elastic_shrink(mesh, *s) for s in shrinks]
    if shrinks:
        torch.distributed.barrier()  # no rank leaves while the survivors step
    out += [sp_eval(mesh, *e) for e in evals]
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


# test_torch_cuda_sharded_train.py's family cases: arch, mesh (the moe
# capacity factor E / k, where capacity cannot bind, so a near tie that bf16
# flips moves one token's output, not every later token's slot)
CUDA_FAMILY_CASES = (("qwen3-moe-235b-a22b", (1, 2)), ("hymba-1.5b", (1, 2)), ("hubert-xlarge", (2, 1)),
                     ("rwkv6-7b", (1, 2)), ("rwkv6-7b", (2, 1)), ("llama-3.2-vision-90b", (1, 2)))
# one sequence-parallel case a family, at (1, 2): the residual stream split over the two ranks
CUDA_SP_CASES = tuple((arch, (1, 2)) for arch in ("olmo-1b", "qwen3-moe-235b-a22b", "hymba-1.5b", "hubert-xlarge",
                                                   "rwkv6-7b", "llama-3.2-vision-90b"))


def cuda_case_id(arch: str, shape: tuple, sp: bool = False) -> str:
    return f"{arch} {shape[0]}x{shape[1]}" + (" sp" if sp else "")


def cuda_family_checks(rank, mesh, device="cuda") -> dict:
    """``test_torch_cuda_sharded_train.py``'s family cases on two gloo ranks
    of the card: for each of ``CUDA_FAMILY_CASES``, the smoke model's 3
    steps (fp8 through K4 where the family takes it, bf16 compute, remat
    full, warmup 0, 4 x 32 tokens or frames; a vlm model's gates opened to
    1.0) on its mesh against the one-rank steps on rank 0 from one state,
    and each rank's K4 launches over the sharded steps; for the ssm and vlm
    families also each rank's K5 or K3 launches in one sharded eval
    forward (``wkv_impl="kernel"``, ``attn_impl="flash"``) from that
    state.  Then each of ``CUDA_SP_CASES`` the same way with sequence
    parallelism, its sharded eval (fp32 compute, sequence parallelism)
    through K3 or K5 and through the plain attention and scan, with K3's
    or K5's launches."""
    import dataclasses

    from repro_torch.config import ParallelConfig, PrecisionConfig, RunConfig, TrainConfig, reduce_for_smoke
    from repro_torch.configs import get_config
    from repro_torch.data import make_batch_fn
    from repro_torch.fp8 import fp8_supported
    from repro_torch.fp8 import gemm as K4
    from repro_torch.kernels import flash_attention as K3
    from repro_torch.kernels import rwkv6_scan as K5
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.train import init_train_state, loss_fn
    from repro_torch.utils.tree import tree_map

    torch.set_num_threads(1)
    meshes = {(1, 2): mesh, (2, 1): make_local_mesh(2, 1, backend="gloo", device=device)}
    out = {"jax_loaded": jax_loaded()}
    cases = [(a, m, False) for a, m in CUDA_FAMILY_CASES] + [(a, m, True) for a, m in CUDA_SP_CASES]
    for arch, shape, sp in cases:
        cfg = reduce_for_smoke(get_config(arch))
        if cfg.moe is not None:
            cfg = cfg.replace(moe=dataclasses.replace(cfg.moe, capacity_factor=cfg.moe.num_experts / cfg.moe.top_k))
        run = RunConfig(arch=arch, train=TrainConfig(global_batch=4, seq_len=32, learning_rate=1e-3, warmup_steps=0,
                                                     total_steps=10),
                        parallel=ParallelConfig(remat="full", sequence_parallel=sp),
                        precision=PrecisionConfig(fp8=fp8_supported(cfg), fp8_gemm="kernel"))
        batch_fn = make_batch_fn(cfg, global_batch=4, seq_len=32, seed=0, device=device)
        batches = [batch_fn(s) for s in range(3)]
        full = init_train_state(cfg, run, 0, device=device)
        for group in full.params["blocks"] if cfg.family == "vlm" else ():
            group["cross"]["attn"]["gate"].fill_(1.0)
            group["cross"]["gate_mlp"].fill_(1.0)
        one = None
        if rank == 0:
            copy = lambda tree: tree_map(torch.clone, tree)  # noqa: E731  (the step updates in place)
            state = full._replace(params=copy(full.params), opt=full.opt._replace(m=copy(full.opt.m),
                                                                                  v=copy(full.opt.v)))
            step = make_train_step(cfg, run)
            metrics = []
            for b in batches:
                state, m = step(state, b)
                metrics.append({k: float(v) for k, v in m.items()})
            one = {"metrics": metrics, "params": [t.cpu().numpy() for t in tree_leaves(state.params)]}
        torch.distributed.barrier()
        m = meshes[shape]
        rules = training_rules(run.parallel)
        specs = state_shardings(cfg, run, rules, m)
        local = shard_state(full, specs, m)
        eval_launches, eval_losses = None, None
        if cfg.family in ("ssm", "vlm") or sp:
            dtype = torch.float32 if sp else torch.bfloat16
            K3.reset_launches()
            K5.reset_launches()
            with torch.no_grad():
                kernel = float(loss_fn(cfg, local.params, batches[0], wkv_impl="kernel", attn_impl="flash",
                                       compute_dtype=dtype, mesh=m, sequence_parallel=sp)[0])
                eval_launches = K5.LAUNCHES["rwkv6_scan"] if cfg.family == "ssm" else K3.LAUNCHES["flash_attention"]
                if sp:
                    plain = float(loss_fn(cfg, local.params, batches[0], compute_dtype=dtype, mesh=m,
                                          sequence_parallel=True)[0])
                    eval_losses = (kernel, plain)
        step = make_train_step(cfg, run, rules, m)
        K4.reset_launches()
        metrics = []
        for b in batches:
            local, mt = step(local, b)
            metrics.append({k: float(v) for k, v in mt.items()})
        launches = K4.LAUNCHES["fp8_gemm"]
        gathered = unshard_state(local, specs, m)
        out[cuda_case_id(arch, shape, sp)] = {"mesh": shape, "one_rank": one, "launches": launches,
                     "layers": cfg.num_layers, "eval_launches": eval_launches, "eval_losses": eval_losses,
                     "sharded": {"metrics": metrics, "params": [t.cpu().numpy() for t in tree_leaves(gathered.params)]}}
    return out


def step_collectives(rank, mesh, cases: list) -> list[dict]:
    """One step of each case (``cfg``, ``run``, ``batch``) on this rank, from
    the rank's slices of a state drawn from seed 0 (``init_train_state(rules=,
    mesh=)``): every training collective's calls and operand bytes
    (``TRAIN_COLLECTIVES``, the ones issued) and the serving table's
    (``COLLECTIVES``), for ``test_torch_dryrun_mesh.py``."""
    from repro_torch.train import init_train_state

    out = []
    for case in cases:
        cfg, run = case["cfg"], case["run"]
        rules = training_rules(run.parallel)
        state = init_train_state(cfg, run, 0, "cpu", rules=rules, mesh=mesh)
        step = make_train_step(cfg, run, rules, mesh)
        collectives.reset_collectives()
        step(state, case["batch"])
        tables = {**collectives.COLLECTIVES, **collectives.TRAIN_COLLECTIVES}
        out.append({k: v for k, v in tables.items() if v})
    return out


def seq_split_decode(rank, mesh, cfg, B: int, seq_len: int, steps: int) -> dict:
    """The dense ring split over the model axis (``decode_step(kv_seq_split=
    True)``, for ``cfg`` whose heads do not divide it) against the whole
    ring on every rank, on the serving layout's slices of seed 0's
    parameters: ``steps`` greedy decode steps of ``B`` rows from seed 1's
    first tokens, the logits of each layout at each step, and the
    collectives of one split step (``COLLECTIVES``); then ``prefill``'s
    cache with ``kv_seq_split=True`` against this rank's share of the whole
    one."""
    from repro_torch.models import decode_step, init_cache, init_params, prefill
    from repro_torch.parallel.sharding import executed_specs, kv_seq_shards, model_axis_size, model_rank, shard_params

    n = kv_seq_shards(cfg, mesh, seq_len)
    params = shard_params(cfg, init_params(cfg, 0, "cpu"), executed_specs(cfg, mesh)["executed"], mesh)
    first = torch.randint(0, cfg.vocab_size, (B, 1), generator=torch.Generator().manual_seed(1), dtype=torch.int32)
    out = {"shards": n, "logits": {}, "collectives": None}
    for split in (False, True):
        cache = init_cache(cfg, B, seq_len, torch.float32, device="cpu", seq_shards=n if split else 1)
        tok, got = first, []
        for t in range(steps):
            collectives.reset_collectives()
            logits, cache = decode_step(cfg, params, cache, tok, torch.full((B,), t, dtype=torch.int32), mesh=mesh,
                                        kv_seq_split=split)
            if split and t == 0:
                out["collectives"] = {k: v for k, v in collectives.COLLECTIVES.items() if v}
            got.append(logits.numpy().copy())
            tok = logits.argmax(-1, keepdim=True).to(torch.int32)
        out["logits"][split] = got
    g = torch.Generator().manual_seed(2)
    tokens = torch.randint(0, cfg.vocab_size, (B, seq_len), generator=g, dtype=torch.int32)
    whole = prefill(cfg, params, {"tokens": tokens}, mesh=mesh)[1]
    mine = prefill(cfg, params, {"tokens": tokens}, mesh=mesh, kv_seq_split=True)[1]
    share = seq_len // model_axis_size(mesh)
    out["prefill_equal"] = all(torch.equal(mine[k], whole[k].narrow(-3, model_rank(mesh) * share, share))
                               for k in ("k", "v"))
    return out


def mesh_checks(rank, mesh, cases: list, decode: dict) -> dict:
    """``test_torch_dryrun_mesh.py``'s world: ``step_collectives`` of the
    train ``cases``, then ``seq_split_decode`` of ``decode``'s arguments."""
    return {"steps": step_collectives(rank, mesh, cases), "decode": seq_split_decode(rank, mesh, **decode)}


def grouped_checks(rank, mesh, cases: list, controls: dict, evals: list, serving: dict) -> dict:
    """``test_torch_grouped_heads.py``'s world (one spawn at ``(1, 4)``):
    ``train_cases`` of ``cases`` and ``controls``; each eval ``(cfg,
    params, batch, sequence_parallel)``'s loss on this rank's slices of
    the full ``params`` (``loss_fn`` under the training table, no
    gradients); the shapes of this rank's attention slices of
    ``serving["params"]`` and ``serving["case"]`` served on them
    (``torch_tp_ranks.serve``)."""
    import torch_tp_ranks
    from repro_torch.config import ParallelConfig
    from repro_torch.parallel.sharding import executed_specs, shard_params
    from repro_torch.train import loss_fn

    out = {"train": train_cases(rank, mesh, cases, controls), "evals": []}
    for cfg, params, batch, sp in evals:
        rules = training_rules(ParallelConfig(sequence_parallel=sp))
        local = shard_params(cfg, params, executed_specs(cfg, mesh, rules)["executed"], mesh)
        with torch.no_grad():
            out["evals"].append(float(loss_fn(cfg, local, batch, mesh=mesh, sequence_parallel=sp)[0]))
    cfg = serving["cfg"]
    local = shard_params(cfg, serving["params"], executed_specs(cfg, mesh)["executed"], mesh)
    out["shapes"] = {k: tuple(t.shape) for k, t in local["blocks"][0]["attn"].items()}
    out["serve"] = torch_tp_ranks.serve(cfg, local, serving["case"], mesh)
    out["jax_loaded"] = jax_loaded()
    return out
