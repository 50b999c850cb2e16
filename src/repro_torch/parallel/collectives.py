"""Collectives: gradient compression, the collective cost model, and the
serving primitives on a mesh's model axis.

1. ``compress_gradients``: gradient compression with error feedback
   (int8 with a per-tensor scale, or bf16 truncation), the JAX package's
   ``parallel/collectives.py`` in torch.  The train step applies it to the
   gradients before the optimizer, with the residual in the train state
   (``train.step``).  ``_quantize_int8`` divides by the scale (true
   division) and rounds half to even, as ``jnp.round`` does.
2. ``CollectiveModel``: per-chip wire bytes of ring collectives over n
   participants and their time at a link rate, a copy of the JAX
   package's.
3. ``all_reduce`` / ``all_gather``: the sum and the gather that
   tensor-parallel serving runs on the mesh's ``"model"`` process group
   (``launch.mesh.make_serving_mesh``): one all-reduce after each
   row-parallel product (attention output, FFN down, the MoE combine) and
   the vocab-parallel embedding, one all-gather of the logits.  Each call
   adds one to ``COLLECTIVES[name]`` and its operand's bytes to
   ``COLLECTIVES[name + "_bytes"]``, where it calls the collective and
   nowhere else.  A failed collective raises.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.distributed as dist

from repro_torch.utils.tree import tree_leaves, tree_map

# ---------------------------------------------------------------------------
# gradient compression (with error feedback)
# ---------------------------------------------------------------------------

COMPRESSION_METHODS = ("none", "bf16", "int8")


def _quantize_int8(g: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    scale = torch.clamp(torch.max(torch.abs(g)), min=1e-12) / 127.0
    q = torch.clamp(torch.round(g / scale), -127, 127).to(torch.int8)
    return q, scale


def compress_gradients(grads, residual, method: str = "none"):
    """Returns (compressed-then-decompressed grads, new residual).

    ``residual`` is the error-feedback state: a tree like ``grads`` of
    fp32 tensors (``init_compression_state``)."""
    if method == "none":
        return grads, residual
    if method not in COMPRESSION_METHODS:
        raise ValueError(f"unknown grad_compression {method!r}")

    def one(g, r):
        gf = g.float() + r
        if method == "bf16":
            gq = gf.to(torch.bfloat16).float()
        else:
            q, scale = _quantize_int8(gf)
            gq = q.float() * scale
        return gq.to(g.dtype), gf - gq

    out = [one(g, r) for g, r in zip(tree_leaves(grads), tree_leaves(residual))]
    it_g, it_r = iter(o[0] for o in out), iter(o[1] for o in out)
    return tree_map(lambda _: next(it_g), grads), tree_map(lambda _: next(it_r), grads)


def init_compression_state(grads_like, method: str = "none"):
    """Zero fp32 residuals shaped like ``grads_like``, or None for ``"none"``."""
    if method == "none":
        return None
    return tree_map(lambda g: torch.zeros(g.shape, dtype=torch.float32, device=g.device), grads_like)


def compression_ratio(method: str) -> float:
    """Bytes-on-the-wire ratio vs fp32 (used by the DCN cost model)."""
    return {"none": 1.0, "bf16": 0.5, "int8": 0.25}[method]


# ---------------------------------------------------------------------------
# analytic collective cost model (ring algorithms)
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class CollectiveModel:
    """Per-chip wire-byte estimates for ring collectives over n participants."""

    link_bw: float = 50e9  # bytes/s per link (the JAX package's constant)

    def all_reduce(self, bytes_per_chip: float, n: int) -> float:
        # ring: 2(n-1)/n of the buffer crosses each chip's link
        return 2.0 * (n - 1) / max(n, 1) * bytes_per_chip

    def all_gather(self, result_bytes: float, n: int) -> float:
        return (n - 1) / max(n, 1) * result_bytes

    def reduce_scatter(self, input_bytes: float, n: int) -> float:
        return (n - 1) / max(n, 1) * input_bytes

    def all_to_all(self, bytes_per_chip: float, n: int) -> float:
        return (n - 1) / max(n, 1) * bytes_per_chip

    def time(self, wire_bytes: float) -> float:
        return wire_bytes / self.link_bw


# ---------------------------------------------------------------------------
# serving primitives on the model axis
# ---------------------------------------------------------------------------

# calls and operand bytes of each primitive (reset with ``reset_collectives``)
COLLECTIVES = {"all_reduce": 0, "all_reduce_bytes": 0, "all_gather": 0, "all_gather_bytes": 0}


def reset_collectives() -> None:
    for name in COLLECTIVES:
        COLLECTIVES[name] = 0


def model_group(mesh):
    """The process group of the mesh's ``"model"`` axis."""
    return mesh.get_group("model")


def all_reduce(x: torch.Tensor, mesh) -> torch.Tensor:
    """Sum ``x`` over the model axis, in place; returns ``x``."""
    if not x.is_contiguous():
        raise ValueError("all_reduce needs a contiguous tensor")
    dist.all_reduce(x, op=dist.ReduceOp.SUM, group=model_group(mesh))
    COLLECTIVES["all_reduce"] += 1
    COLLECTIVES["all_reduce_bytes"] += x.numel() * x.element_size()
    return x


def all_gather(x: torch.Tensor, mesh, dim: int = -1) -> torch.Tensor:
    """Every rank's ``x`` concatenated along ``dim`` in rank order."""
    group = model_group(mesh)
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, x, group=group)
    COLLECTIVES["all_gather"] += 1
    COLLECTIVES["all_gather_bytes"] += x.numel() * x.element_size()
    return torch.cat(parts, dim=dim)
