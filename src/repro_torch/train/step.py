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
the one it was given.  Sharded training (``rules``, ``mesh``,
``param_shardings``) raises ``NotImplementedError``: tensor-parallel
serving is ported, sharded and FSDP training come in the next slice.
"""

from __future__ import annotations

from typing import Any, NamedTuple

import torch

from repro_torch.device import resolve_device
from repro_torch.fp8 import FP8_DTYPES, fp8_supported, make_fp8_ctx, make_fp8_state, update_fp8_state
from repro_torch.models import forward, init_params
from repro_torch.optim import AdamWState, adamw_init, adamw_update, make_schedule
from repro_torch.parallel.collectives import COMPRESSION_METHODS, compress_gradients, init_compression_state
from repro_torch.utils.tree import tree_leaves, tree_map


class TrainState(NamedTuple):
    params: Any
    opt: AdamWState
    compress_residual: Any  # error-feedback residual of grad_compression, or None
    fp8: Any = None  # Fp8State unless precision.fp8 is off or unsupported


DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16, "float16": torch.float16}


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor, *, z_loss: float = 0.0) -> torch.Tensor:
    """Mean CE over all positions (logits fp32), with optional z-loss."""
    logits = logits.float()
    lse = torch.logsumexp(logits, dim=-1)
    ll = torch.gather(logits, -1, labels.long()[..., None])[..., 0]
    loss = torch.mean(lse - ll)
    if z_loss > 0:
        loss = loss + z_loss * torch.mean(torch.square(lse))
    return loss


def loss_fn(
    model_cfg, params, batch, *, q_chunk=0, remat="none", z_loss=0.0, attn_impl="torch", wkv_impl="chunked",
    compute_dtype=None, fp8=None,
):
    """Returns (loss, (ce, aux)): the loss is the cross-entropy plus the
    forward's aux loss (the moe family's load-balance loss, else 0); with an
    ``fp8`` context the aux grows a third slot, the per-site amax
    observations of the delayed-scaling update.  ``attn_impl="flash"`` runs K3 and ``wkv_impl="kernel"`` runs
    K5, both forward only: call them under ``torch.no_grad()``."""
    out = forward(
        model_cfg, params, batch, q_chunk=q_chunk, remat=remat, attn_impl=attn_impl, wkv_impl=wkv_impl,
        compute_dtype=compute_dtype, fp8=fp8,
    )
    ce = cross_entropy(out[0], batch["labels"], z_loss=z_loss)
    return ce + out[1], (ce,) + tuple(out[1:])


def _fp8_enabled(model_cfg, prec) -> bool:
    return bool(prec.fp8) and fp8_supported(model_cfg)


def _check_run(run_cfg) -> None:
    if run_cfg.parallel.grad_compression not in COMPRESSION_METHODS:
        raise ValueError(f"unknown grad_compression {run_cfg.parallel.grad_compression!r}")


def init_train_state(model_cfg, run_cfg, generator: torch.Generator | int = 0, device="cuda") -> TrainState:
    """Random parameters (``models.init_params``), zero AdamW moments, a zero
    compression residual with ``grad_compression`` and, with fp8, a fresh
    ``Fp8State``.  Runs on the card unless ``device`` says otherwise."""
    _check_run(run_cfg)
    device = resolve_device(device)
    prec = run_cfg.precision
    params = init_params(model_cfg, generator, device, DTYPES[prec.param_dtype])
    opt = adamw_init(params, dtype=DTYPES[prec.optimizer_dtype])
    residual = init_compression_state(params, run_cfg.parallel.grad_compression)
    fp8 = make_fp8_state(model_cfg, prec, device) if _fp8_enabled(model_cfg, prec) else None
    return TrainState(params=params, opt=opt, compress_residual=residual, fp8=fp8)


def lr_schedule(run_cfg):
    """The step's learning-rate schedule: ``schedule(opt.step)`` is the rate
    the step applies."""
    tr = run_cfg.train
    return make_schedule("cosine", base_lr=tr.learning_rate, warmup_steps=tr.warmup_steps, total_steps=tr.total_steps)


def grads_of(model_cfg, run_cfg, state: TrainState, batch, *, q_chunk=0):
    """(grads, ce, aux, amaxes) of one (micro)batch at ``state``, which it
    leaves as it was; a fresh FP8 context per forward, so its observations
    belong to this batch alone (``amaxes`` is None without fp8)."""
    prec, par, tr = run_cfg.precision, run_cfg.parallel, run_cfg.train
    use_fp8 = _fp8_enabled(model_cfg, prec)
    leaves = tree_leaves(state.params)
    fp8 = make_fp8_ctx(model_cfg, prec, state.fp8) if use_fp8 else None
    for t in leaves:
        t.requires_grad_(True)
    try:
        with torch.enable_grad():
            loss, aux = loss_fn(
                model_cfg, state.params, batch, q_chunk=q_chunk, remat=par.remat, z_loss=tr.z_loss,
                compute_dtype=DTYPES[prec.compute_dtype], fp8=fp8,
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


def make_train_step(model_cfg, run_cfg, rules=None, mesh=None, *, q_chunk=0, param_shardings=None):
    """Build step(state, batch) -> (state, metrics).

    metrics: ``loss`` (cross-entropy, mean over microbatches), ``aux_loss``,
    ``lr`` (the rate this step applied; 0 at step 0 with warmup, so the
    parameters first move at the second step) and, with clipping,
    ``grad_norm`` (before clipping); all () fp32 tensors on the card.
    """
    if rules is not None or mesh is not None or param_shardings is not None:
        raise NotImplementedError(
            "sharded training is not ported yet: tensor-parallel serving is, sharded and FSDP training come next"
        )
    _check_run(run_cfg)
    prec, par, tr = run_cfg.precision, run_cfg.parallel, run_cfg.train
    schedule = lr_schedule(run_cfg)
    use_fp8 = _fp8_enabled(model_cfg, prec)

    def step(state: TrainState, batch):
        nmb = par.num_microbatches
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
                g, c, a, am = grads_of(model_cfg, run_cfg, state, part, q_chunk=q_chunk)
                for acc, gi in zip(tree_leaves(grads), tree_leaves(g)):
                    acc.add_(gi.float())
                ce, aux = ce + c, aux + a
                if use_fp8:
                    amaxes = {k: torch.maximum(amaxes[k], am[k]) for k in amaxes}
            grads = tree_map(lambda g: g / nmb, grads)
            ce, aux = ce / nmb, aux / nmb
        else:
            grads, ce, aux, amaxes = grads_of(model_cfg, run_cfg, state, batch, q_chunk=q_chunk)

        new_fp8 = state.fp8
        if use_fp8:
            new_fp8 = update_fp8_state(state.fp8, amaxes, dtype=FP8_DTYPES[prec.fp8_dtype], margin=prec.fp8_margin)

        residual = state.compress_residual
        if par.grad_compression != "none":
            grads, residual = compress_gradients(grads, residual, par.grad_compression)

        lr = schedule(state.opt.step)
        new_params, new_opt, om = adamw_update(
            state.params, grads, state.opt, lr=lr, beta1=tr.beta1, beta2=tr.beta2, eps=tr.eps,
            weight_decay=tr.weight_decay, grad_clip=tr.grad_clip, layer_scan=par.optimizer_layer_scan,
        )
        metrics = {"loss": ce, "aux_loss": aux, "lr": lr, **om}
        return TrainState(params=new_params, opt=new_opt, compress_residual=residual, fp8=new_fp8), metrics

    return step
