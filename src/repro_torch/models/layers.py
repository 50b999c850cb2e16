"""Shared model layers: norms, rotary embeddings, param-spec primitives.

Plain functions over tensors and nested dicts, mirroring the JAX package's
``models/layers.py``: ``ParamSpec`` trees describe shapes and init, and the
same tree serves ``init_params`` and the weight bridge.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch
import torch.nn.functional as F


class ParamSpec(NamedTuple):
    shape: tuple[int, ...]
    axes: tuple[str | None, ...]  # logical axis names, len == ndim
    init: str = "fan_in"  # "fan_in" | "normal" | "zeros" | "ones"
    scale: float = 1.0  # extra multiplier on the init stddev / value


# ---------------------------------------------------------------------------
# initialization
# ---------------------------------------------------------------------------


def materialize(spec: ParamSpec, generator: torch.Generator, device, dtype) -> torch.Tensor:
    """Create a concrete parameter for ``spec`` (the JAX package's init kinds
    and scales; the random bits differ from ``jax.random``)."""
    shape = spec.shape
    if spec.init == "zeros":
        return torch.zeros(shape, device=device, dtype=dtype)
    if spec.init == "ones":
        return torch.ones(shape, device=device, dtype=dtype)
    out = torch.empty(shape, device=device, dtype=torch.float32)
    if spec.init == "normal":
        torch.nn.init.normal_(out, 0.0, spec.scale * 0.02, generator=generator)
        return out.to(dtype)
    if spec.init == "fan_in":
        fan_in = shape[0] if len(shape) == 1 else math.prod(shape[:-1])
        std = spec.scale / math.sqrt(max(fan_in, 1))
        torch.nn.init.trunc_normal_(out, 0.0, 1.0, -3.0, 3.0, generator=generator)
        return out.mul_(std).to(dtype)
    raise ValueError(f"unknown init {spec.init!r}")


# ---------------------------------------------------------------------------
# norms
# ---------------------------------------------------------------------------


def norm_specs(cfg, d: int | None = None) -> dict:
    d = d or cfg.d_model
    if cfg.norm == "rmsnorm":
        return {"scale": ParamSpec((d,), ("embed",), "ones")}
    if cfg.norm == "layernorm":
        return {"scale": ParamSpec((d,), ("embed",), "ones"), "bias": ParamSpec((d,), ("embed",), "zeros")}
    if cfg.norm == "layernorm_np":  # OLMo: non-parametric LN
        return {}
    raise ValueError(f"unknown norm {cfg.norm!r}")


def apply_norm(cfg, p: dict, x: torch.Tensor) -> torch.Tensor:
    """Normalize in fp32, cast back to input dtype (standard LM practice)."""
    dtype = x.dtype
    xf = x.float()
    if cfg.norm == "rmsnorm":
        xf = xf * torch.rsqrt(torch.mean(xf * xf, dim=-1, keepdim=True) + cfg.norm_eps)
        xf = xf * p["scale"].float()
    else:  # layernorm / layernorm_np
        mu = torch.mean(xf, dim=-1, keepdim=True)
        # population variance, as jnp.var (torch.var defaults to unbiased)
        var = torch.var(xf, dim=-1, keepdim=True, unbiased=False)
        xf = (xf - mu) * torch.rsqrt(var + cfg.norm_eps)
        if p:  # parametric
            xf = xf * p["scale"].float() + p["bias"].float()
    return xf.to(dtype)


# ---------------------------------------------------------------------------
# rotary position embeddings
# ---------------------------------------------------------------------------


def rope_frequencies(head_dim: int, rotary_pct: float, theta: float, device=None) -> torch.Tensor:
    """Inverse frequencies for the rotated fraction of the head dim."""
    rot_dim = int(head_dim * rotary_pct) // 2 * 2
    return 1.0 / (theta ** (torch.arange(0, rot_dim, 2, dtype=torch.float32, device=device) / rot_dim))


def apply_rope(x: torch.Tensor, positions: torch.Tensor, *, rotary_pct: float = 1.0, theta: float = 10000.0) -> torch.Tensor:
    """Apply rotate-half RoPE. x: (..., seq, heads, head_dim); positions: (..., seq).
    Only the first ``int(hd * rotary_pct) // 2 * 2`` dims rotate."""
    head_dim = x.shape[-1]
    rot_dim = int(head_dim * rotary_pct) // 2 * 2
    inv_freq = rope_frequencies(head_dim, rotary_pct, theta, device=x.device)
    ang = positions.float()[..., None] * inv_freq  # (..., seq, rot_dim/2)
    sin = torch.sin(ang)[..., None, :]  # broadcast over heads
    cos = torch.cos(ang)[..., None, :]
    x_rot, x_pass = x[..., :rot_dim], x[..., rot_dim:]
    x1, x2 = x_rot[..., : rot_dim // 2], x_rot[..., rot_dim // 2 :]
    out1 = x1 * cos - x2 * sin
    out2 = x2 * cos + x1 * sin
    return torch.cat([out1.to(x.dtype), out2.to(x.dtype), x_pass], dim=-1)


# ---------------------------------------------------------------------------
# misc
# ---------------------------------------------------------------------------


def softcap(logits: torch.Tensor, cap: float) -> torch.Tensor:
    if cap <= 0:
        return logits
    return cap * torch.tanh(logits / cap)


def gelu_tanh(x: torch.Tensor) -> torch.Tensor:
    # jax.nn.gelu defaults to the tanh approximation
    return F.gelu(x, approximate="tanh")


ACTIVATIONS = {
    "gelu": gelu_tanh,
    "silu": F.silu,
    "relu2": lambda x: torch.square(F.relu(x)),
}
