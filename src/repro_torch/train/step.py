"""Train step: mixed precision, remat, microbatched grad accumulation, FP8.

The JAX package's ``train/step.py`` on one card.  ``make_train_step(model_cfg,
run_cfg)`` returns ``step(state, batch) -> (state, metrics)``.

Mixed precision follows the reference: master params in
``precision.param_dtype`` (fp32), the activation stream in
``compute_dtype`` (bf16), softmax and norm statistics in fp32, logits in
fp32.  With ``precision.fp8`` the projection GEMMs of every block run
through ``repro_torch.fp8`` (e4m3 forward, e5m2 gradients, delayed scaling):
the state carries an ``Fp8State``, the forward reports per-layer amaxes and
the step folds them into the next step's scales.

``parallel.grad_compression`` (``"bf16"`` or ``"int8"``) compresses the
gradients before the optimizer, with the error-feedback residual in the
state (``compress_residual``), where the JAX package does
(``parallel.collectives.compress_gradients``).

The step updates the parameters and the AdamW moments in place (see
``optim.adamw``): the state it returns holds the same parameter tensors as
the one it was given.

**Sharded and FSDP training** (``make_train_step(cfg, run, rules, mesh)``,
every family of ``models.model.FORWARD_FAMILIES``):
one state spans the ``(data, model)`` mesh of
``launch.mesh.make_local_mesh``, each rank holding its slices
(``parallel.sharding.shard_state``; ``init_train_state(rules=, mesh=)``
draws the full state from the seed, then keeps the rank's).  The step
takes the global batch and computes the JAX package's step on it:

* the batch is split into microbatches first, then each microbatch over
  ``"data"`` (each data rank takes its contiguous rows of each), as the
  JAX step reshapes the global batch to ``(nmb, B / nmb, ...)`` before
  sharding it (a moe layer routes each microbatch's groups in that global
  token order, however its groups fall over the data ranks:
  ``models.moe``);
* the forward runs the model slices under autograd with FSDP gathers
  inside the layers (``models.forward(mesh=)``) and the cross-entropy is
  vocab-parallel (``cross_entropy(mesh=)``): the max, the sum of
  exponentials and the label's logit each reduced over ``"model"``, the
  z-loss on the global log-sum-exp, never the full logits;
* gradients: FSDP's reduce-scatter sums the sharded leaves over the data
  ranks inside the backward; the leaves replicated over ``"data"`` are
  summed by one all-reduce after the microbatches; all are divided by the
  data degree, and the loss and aux metrics are their data ranks' mean
  (every rank computes the moe aux of the whole microbatch, so its mean is
  the reference's aux);
* fp8: the amaxes of each microbatch are reduced with ``MAX`` over the
  mesh before ``update_fp8_state`` (so every rank holds the same scales),
  and each backward gradient's just-in-time scale too (``fp8_dot``);
* int8 compression takes each leaf's scale from its whole gradient, and
  the clipping norm counts every leaf once (``optim.adamw.global_norm``).

The ssm family's time mix runs whole on every model rank and the vlm
family's cross layers split their heads like the self layers (a batch's
``vision_tokens`` are split by rows with the rest).  With
``parallel.sequence_parallel`` the residual stream between the sublayers
is each model rank's slice of the sequence where the model axis divides
it (``models.forward(sequence_parallel=)``, ``parallel.sharding.seq_split``);
the loss and the metrics are the same function's.  The JAX package
executes the same function through GSPMD.
"""

from __future__ import annotations

from typing import Any, NamedTuple

import torch

from functools import partial

from repro_torch.device import resolve_device
from repro_torch.fp8 import FP8_DTYPES, fp8_supported, make_fp8_ctx, make_fp8_state, update_fp8_state
from repro_torch.models import forward, init_params
from repro_torch.optim import AdamWState, adamw_init, adamw_update, make_schedule
from repro_torch.parallel.collectives import (
    COMPRESSION_METHODS,
    all_reduce_max,
    all_reduce_over,
    compress_gradients,
    init_compression_state,
    max_over_model,
    sum_over_model,
)
from repro_torch.parallel.sharding import DATA, executed_specs, model_rank
from repro_torch.utils.tree import tree_leaves, tree_map


class TrainState(NamedTuple):
    params: Any
    opt: AdamWState
    compress_residual: Any  # error-feedback residual of grad_compression, or None
    fp8: Any = None  # Fp8State unless precision.fp8 is off or unsupported


DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16, "float16": torch.float16}


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor, *, z_loss: float = 0.0, mesh=None) -> torch.Tensor:
    """Mean CE over all positions (logits fp32), with optional z-loss.
    Under a ``mesh`` the logits are this rank's contiguous slice of the
    vocab and the CE is vocab-parallel: the max, the sum of exponentials
    and the label's logit are each reduced over ``"model"``, as GSPMD runs
    it on vocab-sharded logits (the max outside autograd: the log-sum-exp's
    gradient does not depend on it)."""
    logits = logits.float()
    if mesh is None:
        lse = torch.logsumexp(logits, dim=-1)
        ll = torch.gather(logits, -1, labels.long()[..., None])[..., 0]
    else:
        V = logits.shape[-1]
        m = max_over_model(torch.amax(logits, dim=-1), mesh)
        lse = m + torch.log(sum_over_model(torch.sum(torch.exp(logits - m[..., None]), dim=-1), mesh))
        local = labels.long() - model_rank(mesh) * V
        mine = (local >= 0) & (local < V)
        picked = torch.gather(logits, -1, local.clamp(0, V - 1)[..., None])[..., 0]
        ll = sum_over_model(torch.where(mine, picked, torch.zeros((), device=picked.device)), mesh)
    loss = torch.mean(lse - ll)
    if z_loss > 0:
        loss = loss + z_loss * torch.mean(torch.square(lse))
    return loss


def loss_fn(
    model_cfg, params, batch, *, q_chunk=0, remat="none", z_loss=0.0, attn_impl="torch", wkv_impl="chunked",
    compute_dtype=None, fp8=None, mesh=None, sequence_parallel=False,
):
    """Returns (loss, (ce, aux)): the loss is the cross-entropy plus the
    forward's aux loss (the moe family's load-balance loss, else 0); with an
    ``fp8`` context the aux grows a third slot, the per-site amax
    observations of the delayed-scaling update.  ``attn_impl="flash"`` runs K3 and ``wkv_impl="kernel"`` runs
    K5, both forward only: call them under ``torch.no_grad()``.  ``mesh``:
    sharded training's, with this rank's slices and rows (the loss is then
    this rank's rows' mean); ``sequence_parallel``: the run's
    ``ParallelConfig.sequence_parallel`` (``models.forward``)."""
    out = forward(
        model_cfg, params, batch, q_chunk=q_chunk, remat=remat, attn_impl=attn_impl, wkv_impl=wkv_impl,
        compute_dtype=compute_dtype, fp8=fp8, mesh=mesh, sequence_parallel=sequence_parallel,
    )
    vocab_split = mesh is not None and out[0].shape[-1] != model_cfg.padded_vocab
    ce = cross_entropy(out[0], batch["labels"], z_loss=z_loss, mesh=mesh if vocab_split else None)
    return ce + out[1], (ce,) + tuple(out[1:])


def _fp8_enabled(model_cfg, prec) -> bool:
    return bool(prec.fp8) and fp8_supported(model_cfg)


def _check_run(run_cfg) -> None:
    if run_cfg.parallel.grad_compression not in COMPRESSION_METHODS:
        raise ValueError(f"unknown grad_compression {run_cfg.parallel.grad_compression!r}")


def _check_sharded(model_cfg, run_cfg, rules, mesh) -> None:
    if (rules is None) != (mesh is None):
        raise ValueError("sharded training takes both rules and a mesh")
    if mesh is None:
        return
    if tuple(getattr(mesh, "mesh_dim_names", ())) != ("data", "model"):
        raise ValueError(f"sharded training runs a ('data', 'model') mesh, not {mesh!r}")


def init_train_state(
    model_cfg, run_cfg, generator: torch.Generator | int = 0, device="cuda", *, rules=None, mesh=None
) -> TrainState:
    """Random parameters (``models.init_params``), zero AdamW moments, a zero
    compression residual with ``grad_compression`` and, with fp8, a fresh
    ``Fp8State``.  Runs on the card unless ``device`` says otherwise.
    With ``rules`` and a ``mesh`` (sharded training) it draws the
    parameters from the seed leaf by leaf, as one card would, keeps this
    rank's slice of each as it goes, and makes the rest of the state at
    the slices' shapes: ``parallel.sharding.shard_state`` of the full
    state, bit for bit, without ever holding it."""
    _check_run(run_cfg)
    _check_sharded(model_cfg, run_cfg, rules, mesh)
    device = resolve_device(device)
    prec = run_cfg.precision
    shardings = None
    if mesh is not None:
        from repro_torch.parallel.sharding import executed_specs

        shardings = executed_specs(model_cfg, mesh, rules)["executed"]
    params = init_params(model_cfg, generator, device, DTYPES[prec.param_dtype], shardings=shardings, mesh=mesh)
    opt = adamw_init(params, dtype=DTYPES[prec.optimizer_dtype])
    residual = init_compression_state(params, run_cfg.parallel.grad_compression)
    fp8 = make_fp8_state(model_cfg, prec, device) if _fp8_enabled(model_cfg, prec) else None
    return TrainState(params=params, opt=opt, compress_residual=residual, fp8=fp8)


def lr_schedule(run_cfg):
    """The step's learning-rate schedule: ``schedule(opt.step)`` is the rate
    the step applies."""
    tr = run_cfg.train
    return make_schedule("cosine", base_lr=tr.learning_rate, warmup_steps=tr.warmup_steps, total_steps=tr.total_steps)


def grads_of(model_cfg, run_cfg, state: TrainState, batch, *, q_chunk=0, mesh=None):
    """(grads, ce, aux, amaxes) of one (micro)batch at ``state``, which it
    leaves as it was; a fresh FP8 context per forward, so its observations
    belong to this batch alone (``amaxes`` is None without fp8).  Under a
    ``mesh``: this rank's, of its rows (the step reduces them)."""
    prec, par, tr = run_cfg.precision, run_cfg.parallel, run_cfg.train
    use_fp8 = _fp8_enabled(model_cfg, prec)
    leaves = tree_leaves(state.params)
    amax_reduce = partial(all_reduce_max, mesh=mesh) if mesh is not None else None
    fp8 = make_fp8_ctx(model_cfg, prec, state.fp8, amax_reduce) if use_fp8 else None
    for t in leaves:
        t.requires_grad_(True)
    try:
        with torch.enable_grad():
            loss, aux = loss_fn(
                model_cfg, state.params, batch, q_chunk=q_chunk, remat=par.remat, z_loss=tr.z_loss,
                compute_dtype=DTYPES[prec.compute_dtype], fp8=fp8, mesh=mesh, sequence_parallel=par.sequence_parallel,
            )
            g = torch.autograd.grad(loss, leaves, allow_unused=True)
    finally:
        for t in leaves:
            t.requires_grad_(False)
    g = [torch.zeros_like(p) if gi is None else gi for p, gi in zip(leaves, g)]
    it = iter(g)
    grads = tree_map(lambda _: next(it), state.params)
    ce, aux_loss = aux[0].detach(), aux[1].detach()
    return grads, ce, aux_loss, (aux[2] if use_fp8 else None)


def local_rows(batch: dict, nmb: int, mesh) -> dict:
    """This data rank's rows of a global batch: each of the ``nmb``
    microbatches split over ``"data"``, the rank's contiguous rows of each
    in microbatch order (so the step's microbatch loop finds its part of
    microbatch i at i)."""
    d = mesh.size(mesh.mesh_dim_names.index(DATA))
    B = batch["labels"].shape[0]
    if B % (nmb * d):
        raise ValueError(f"batch {B} does not split into {nmb} microbatches over {d} data ranks")
    if d == 1:
        return batch
    mb, part, r = B // nmb, B // (nmb * d), mesh.get_local_rank(DATA)
    return {k: torch.cat([v[i * mb + r * part : i * mb + (r + 1) * part] for i in range(nmb)]) for k, v in batch.items()}


def make_train_step(model_cfg, run_cfg, rules=None, mesh=None, *, q_chunk=0, param_shardings=None):
    """Build step(state, batch) -> (state, metrics).

    metrics: ``loss`` (cross-entropy, mean over microbatches), ``aux_loss``,
    ``lr`` (the rate this step applied; 0 at step 0 with warmup, so the
    parameters first move at the second step) and, with clipping,
    ``grad_norm`` (before clipping); all () fp32 tensors on the card.

    ``rules`` (``parallel.sharding.make_rules``) and ``mesh`` (a ``(data,
    model)`` ``DeviceMesh``): sharded training (module docstring); the
    state is this rank's (``init_train_state(rules=, mesh=)``,
    ``parallel.sharding.shard_state``), the batch the global one, and the
    metrics the whole batch's on every rank.  ``param_shardings``: the
    executed specs of the parameters (default: ``executed_specs`` of the
    rules on the mesh).
    """
    _check_run(run_cfg)
    _check_sharded(model_cfg, run_cfg, rules, mesh)
    # The first torch.utils.checkpoint call of a process imports torch._dynamo,
    # and that import's frames stay in a reference cycle holding the calling
    # stack (the first step's state included) until the cyclic collector runs.
    # Imported here, before any step holds a state: every forward may
    # checkpoint (remat, the chunked WKV scan, q_chunk).
    import torch._dynamo  # noqa: F401
    if param_shardings is not None and mesh is None:
        raise ValueError("param_shardings needs a mesh")
    specs = None
    if mesh is not None:
        specs = param_shardings if param_shardings is not None else executed_specs(model_cfg, mesh, rules)["executed"]
        data = mesh.size(mesh.mesh_dim_names.index(DATA))
    prec, par, tr = run_cfg.precision, run_cfg.parallel, run_cfg.train
    schedule = lr_schedule(run_cfg)
    use_fp8 = _fp8_enabled(model_cfg, prec)

    def step(state: TrainState, batch):
        nmb = par.num_microbatches
        if mesh is not None:
            batch = local_rows(batch, nmb, mesh)
        if nmb > 1:
            B = batch["labels"].shape[0]  # every family's batch has labels (audio has no tokens)
            if B % nmb:
                raise ValueError(f"batch {B} is not a multiple of num_microbatches={nmb}")
            mb = B // nmb
            grads = tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device), state.params)
            ce = torch.zeros((), dtype=torch.float32, device=batch["labels"].device)
            aux = torch.zeros_like(ce)
            amaxes = {k: torch.zeros_like(s) for k, s in state.fp8.scale.items()} if use_fp8 else None
            for i in range(nmb):
                part = {k: v[i * mb : (i + 1) * mb] for k, v in batch.items()}
                g, c, a, am = grads_of(model_cfg, run_cfg, state, part, q_chunk=q_chunk, mesh=mesh)
                for acc, gi in zip(tree_leaves(grads), tree_leaves(g)):
                    acc.add_(gi.float())
                ce, aux = ce + c, aux + a
                if use_fp8:
                    amaxes = {k: torch.maximum(amaxes[k], am[k]) for k in amaxes}
            grads = tree_map(lambda g: g / nmb, grads)
            ce, aux = ce / nmb, aux / nmb
        else:
            grads, ce, aux, amaxes = grads_of(model_cfg, run_cfg, state, batch, q_chunk=q_chunk, mesh=mesh)

        if mesh is not None:
            grads, ce, aux, amaxes = _reduce_over_mesh(grads, ce, aux, amaxes, mesh, data, specs)

        new_fp8 = state.fp8
        if use_fp8:
            new_fp8 = update_fp8_state(state.fp8, amaxes, dtype=FP8_DTYPES[prec.fp8_dtype], margin=prec.fp8_margin)

        residual = state.compress_residual
        if par.grad_compression != "none":
            grads, residual = compress_gradients(grads, residual, par.grad_compression, mesh=mesh)

        lr = schedule(state.opt.step)
        new_params, new_opt, om = adamw_update(
            state.params, grads, state.opt, lr=lr, beta1=tr.beta1, beta2=tr.beta2, eps=tr.eps,
            weight_decay=tr.weight_decay, grad_clip=tr.grad_clip, layer_scan=par.optimizer_layer_scan,
            specs=specs, mesh=mesh,
        )
        metrics = {"loss": ce, "aux_loss": aux, "lr": lr, **om}
        return TrainState(params=new_params, opt=new_opt, compress_residual=residual, fp8=new_fp8), metrics

    return step


def _reduce_over_mesh(grads, ce, aux, amaxes, mesh, data: int, specs):
    """A rank's microbatch-mean gradients and metrics -> the whole batch's:
    the leaves replicated over ``"data"`` (which FSDP's reduce-scatter did
    not sum) summed by one all-reduce of their concatenation, every leaf
    divided by the data degree, the metrics averaged over the data ranks
    and the fp8 amaxes maximised over the mesh (one collective each)."""
    leaves = tree_leaves(grads)
    # paired by key: a bridged state may order its dict keys otherwise
    reps = [g for g, s in tree_leaves(tree_map(lambda g, s: (g, s), grads, specs)) if DATA not in s]
    if data > 1 and reps:
        flat = all_reduce_over(torch.cat([g.reshape(-1).float() for g in reps]), mesh, (DATA,))
        for g, part in zip(reps, flat.split([g.numel() for g in reps])):
            g.copy_(part.view_as(g))
    if data > 1:
        for g in leaves:
            g.div_(data)
    ce, aux = (all_reduce_over(torch.stack([ce, aux]), mesh, (DATA,)) / data).unbind()
    if amaxes is not None:
        keys = list(amaxes)
        got = all_reduce_max(torch.stack([amaxes[k] for k in keys]), mesh).unbind()
        amaxes = dict(zip(keys, got))
    return grads, ce, aux, amaxes
