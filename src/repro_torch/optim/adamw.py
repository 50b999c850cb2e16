"""AdamW with a configurable moment dtype and global-norm clipping.

The JAX package's ``optim/adamw.py`` on the port's parameter trees (dicts,
with one dict per layer in a list under ``"blocks"``).  The update runs in
place: parameters and both moments are overwritten where they lie, so a
step needs no second copy of the model's 16 bytes per parameter.

Weight decay follows the reference's rule ``wd if p.ndim >= 2`` on the
*stacked* rank: the JAX tree stacks every block leaf over layers, so a
per-layer norm scale ``(D,)`` is ``(L, D)`` there and is decayed.  A leaf
under ``"blocks"`` therefore counts one extra dimension here.

The update is elementwise, so it runs over each leaf in slices along its
first dimension of at most ``CHUNK`` elements (or one row, where a row is
larger), and the clipping scale is applied slice by slice: the fp32
temporaries never exceed a slice (a qwen3-moe expert stack is 3.2 GB), and
no clipped copy of the gradients is made.  Each element goes through the
same operations as in one pass over the whole tree, so the result is the
same bit for bit; ``tests/test_torch_adamw.py`` holds it so.

Under a training mesh (sharded and FSDP training) each rank updates its
own shards: the update is elementwise, so only the clipping norm needs the
other ranks (``global_norm(specs=, mesh=)``).  The decay rank is the
leaf's rank, which sharding does not change.
"""

from __future__ import annotations

from typing import Any, NamedTuple

import torch

from repro_torch.parallel.collectives import all_reduce_over
from repro_torch.utils.tree import tree_leaves, tree_map, tree_paths

CHUNK = 1 << 26  # elements of a leaf updated at once: 256 MB of each fp32 temporary


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


def global_norm(tree, specs=None, mesh=None) -> torch.Tensor:
    """The L2 norm of every leaf of ``tree``.  Under a training ``mesh``
    the leaves are this rank's shards and ``specs`` their executed specs
    (``parallel.sharding``): each leaf's square sum is summed over exactly
    the mesh axes that shard it (one collective for each set of axes), so
    a replicated leaf counts once, not once a rank."""
    if mesh is None:
        leaves = [torch.sum(torch.square(x.float())) for x in tree_leaves(tree)]
        return torch.sqrt(torch.sum(torch.stack(leaves)))
    by_axes: dict = {}
    # paired by key: a bridged tree may order its dict keys otherwise
    for x, spec in tree_leaves(tree_map(lambda x, s: (x, s), tree, specs)):
        by_axes.setdefault(tuple(a for a in ("data", "model") if a in spec), []).append(torch.sum(torch.square(x.float())))
    sums = [all_reduce_over(torch.sum(torch.stack(v)), mesh, axes) for axes, v in by_axes.items()]
    return torch.sqrt(torch.sum(torch.stack(sums)))


def clip_scale(norm: torch.Tensor, max_norm: float) -> torch.Tensor:
    """The factor that brings a global norm down to ``max_norm`` (at most 1)."""
    # a true division: ``float / tensor`` would multiply by the reciprocal
    return torch.clamp(torch.div(torch.full_like(norm, max_norm), torch.clamp(norm, min=1e-12)), max=1.0)


def clipped(g: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """A gradient scaled by ``clip_scale``'s factor, in its own dtype."""
    return (g.float() * scale).to(g.dtype)


def row_slices(t: torch.Tensor):
    """Views of ``t`` along its first dimension, each at most ``CHUNK``
    elements or one row; a 0-d tensor is one slice."""
    t = t.reshape(1) if t.dim() == 0 else t
    rows = max(1, CHUNK // max(1, t[0].numel()))
    return [t[lo : lo + rows] for lo in range(0, t.shape[0], rows)]


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
    specs=None,
    mesh=None,
):
    """One AdamW step, in place.  Returns (params, new state, metrics); the
    params and moment tensors returned are the ones passed in, updated.
    ``specs`` and ``mesh``: a rank's shards under sharded training, for
    the clipping norm (``global_norm``).

    ``layer_scan`` is accepted for the reference's signature and has no
    effect: each layer's leaves are separate tensors already, so the fp32
    temporaries never span more than one layer's slice.
    """
    del layer_scan
    step = state.step + 1
    metrics = {}
    scale = None
    if grad_clip > 0:
        gnorm = global_norm(grads, specs, mesh)
        scale = clip_scale(gnorm, grad_clip)
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
        # slices are views, so the state is written in place, contiguous or not
        for ps, gs, ms, vs in zip(row_slices(p), row_slices(g), row_slices(m), row_slices(v)):
            if scale is not None:
                gs = clipped(gs, scale)
            gf = gs.float()
            mf = beta1 * ms.float() + (1 - beta1) * gf
            vf = beta2 * vs.float() + (1 - beta2) * gf * gf
            mhat = mf / b1c
            vhat = vf / b2c
            pf = ps.float()
            new_p = pf - lr * (mhat / (torch.sqrt(vhat) + eps) + wd * pf)
            ps.copy_(new_p)
            ms.copy_(mf)
            vs.copy_(vf)
    return params, AdamWState(step=step, m=state.m, v=state.v), metrics
