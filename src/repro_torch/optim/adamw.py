"""AdamW with a configurable moment dtype and global-norm clipping.

The JAX package's ``optim/adamw.py`` on the port's parameter trees (dicts,
with one dict per layer in a list under ``"blocks"``).  The update runs in
place: parameters and both moments are overwritten where they lie, so a
step needs no second copy of the model's 16 bytes per parameter.

Weight decay follows the reference's rule ``wd if p.ndim >= 2`` on the
*stacked* rank: the JAX tree stacks every block leaf over layers, so a
per-layer norm scale ``(D,)`` is ``(L, D)`` there and is decayed.  A leaf
under ``"blocks"`` therefore counts one extra dimension here.
"""

from __future__ import annotations

from typing import Any, NamedTuple

import torch

from repro_torch.utils.tree import tree_leaves, tree_map, tree_paths


class AdamWState(NamedTuple):
    step: torch.Tensor  # () int32
    m: Any  # tree like params
    v: Any  # tree like params


def adamw_init(params, *, dtype=torch.float32) -> AdamWState:
    first = tree_leaves(params)[0]
    return AdamWState(
        step=torch.zeros((), dtype=torch.int32, device=first.device),
        m=tree_map(lambda p: torch.zeros(p.shape, dtype=dtype, device=p.device), params),
        v=tree_map(lambda p: torch.zeros(p.shape, dtype=dtype, device=p.device), params),
    )


def global_norm(tree) -> torch.Tensor:
    leaves = [torch.sum(torch.square(x.float())) for x in tree_leaves(tree)]
    return torch.sqrt(torch.sum(torch.stack(leaves)))


def clip_by_global_norm(grads, max_norm: float):
    norm = global_norm(grads)
    # a true division: ``float / tensor`` would multiply by the reciprocal
    scale = torch.clamp(torch.div(torch.full_like(norm, max_norm), torch.clamp(norm, min=1e-12)), max=1.0)
    return tree_map(lambda g: (g.float() * scale).to(g.dtype), grads), norm


def stacked_rank(path: tuple, p: torch.Tensor) -> int:
    """The leaf's rank in the JAX package's stacked tree."""
    return p.dim() + (1 if path and path[0] == "blocks" else 0)


@torch.no_grad()
def adamw_update(
    params,
    grads,
    state: AdamWState,
    *,
    lr,
    beta1: float = 0.9,
    beta2: float = 0.95,
    eps: float = 1e-8,
    weight_decay: float = 0.1,
    grad_clip: float = 0.0,
    layer_scan: bool = False,
):
    """One AdamW step, in place.  Returns (params, new state, metrics); the
    params and moment tensors returned are the ones passed in, updated.

    ``layer_scan`` is accepted for the reference's signature and has no
    effect: each layer's leaves are separate tensors already, so the fp32
    temporaries never span more than one layer's slice.
    """
    del layer_scan
    step = state.step + 1
    metrics = {}
    if grad_clip > 0:
        grads, gnorm = clip_by_global_norm(grads, grad_clip)
        metrics["grad_norm"] = gnorm
    stepf = step.float()
    one = torch.ones((), dtype=torch.float32, device=stepf.device)
    b1c = 1.0 - torch.pow(one * beta1, stepf)
    b2c = 1.0 - torch.pow(one * beta2, stepf)
    lr = torch.as_tensor(lr, dtype=torch.float32, device=stepf.device)

    for path, p, g, m, v in zip(
        tree_paths(params), tree_leaves(params), tree_leaves(grads), tree_leaves(state.m), tree_leaves(state.v)
    ):
        wd = weight_decay if stacked_rank(path, p) >= 2 else 0.0
        gf = g.float()
        mf = beta1 * m.float() + (1 - beta1) * gf
        vf = beta2 * v.float() + (1 - beta2) * gf * gf
        mhat = mf / b1c
        vhat = vf / b2c
        pf = p.float()
        new_p = pf - lr * (mhat / (torch.sqrt(vhat) + eps) + wd * pf)
        p.copy_(new_p)
        m.copy_(mf)
        v.copy_(vf)
    return params, AdamWState(step=step, m=state.m, v=state.v), metrics
