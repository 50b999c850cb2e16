"""Feed-forward blocks: gated (SwiGLU/GeGLU) and plain (GELU/SiLU/ReLU^2)."""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models.layers import ACTIVATIONS, ParamSpec, gelu_tanh
from repro_torch.parallel.collectives import copy_to_model, sum_over_model


def is_gated(activation: str) -> bool:
    return activation in ("swiglu", "geglu")


def gate_fn(activation: str):
    if activation == "swiglu":
        return F.silu
    if activation == "geglu":
        return gelu_tanh
    return ACTIVATIONS[activation]


def ffn_specs(cfg, d_ff: int | None = None) -> dict:
    D = cfg.d_model
    F_ = d_ff or cfg.d_ff
    specs = {}
    if is_gated(cfg.activation):
        specs["w_gate"] = ParamSpec((D, F_), ("embed", "mlp"))
        specs["w_up"] = ParamSpec((D, F_), ("embed", "mlp"))
    else:
        specs["w_up"] = ParamSpec((D, F_), ("embed", "mlp"))
    specs["w_down"] = ParamSpec((F_, D), ("mlp", "embed"))
    if cfg.use_bias:
        specs["b_up"] = ParamSpec((F_,), ("mlp",), "zeros")
        specs["b_down"] = ParamSpec((D,), ("embed",), "zeros")
    return specs


def ffn(cfg, p: dict, x: torch.Tensor, *, fp8=None, mesh=None) -> torch.Tensor:
    """``fp8``: an FP8 layer handle (``repro_torch.fp8.policy.Fp8Layer``)
    routes the up/gate/down GEMMs through quantized matmuls (biases and the
    activation stay in the compute dtype).

    Under a tensor-parallel ``mesh`` whose ranks each hold a slice of the
    hidden dim (``w_down`` has fewer than ``cfg.d_ff`` rows): up, gate and
    ``b_up`` are column-parallel, the down product row-parallel, summed by
    one all-reduce, and ``b_down`` is added once, after the sum.  Under
    autograd (sharded training) x passes through ``copy_to_model`` and the
    sum is ``sum_over_model``'s (``parallel.collectives``)."""

    def mm(site, a, w):
        return fp8.matmul(site, a, w) if fp8 is not None else a @ w.to(a.dtype)

    split = mesh is not None and p["w_down"].shape[0] != cfg.d_ff
    if split:
        x = copy_to_model(x, mesh)
    act = gate_fn(cfg.activation)
    up = mm("ffn_up", x, p["w_up"])
    if cfg.use_bias:
        up = up + p["b_up"].to(x.dtype)
    if is_gated(cfg.activation):
        h = act(mm("ffn_gate", x, p["w_gate"])) * up
    else:
        h = act(up)
    out = mm("ffn_down", h, p["w_down"])
    if split:
        out = sum_over_model(out.contiguous(), mesh)
    if cfg.use_bias:
        out = out + p["b_down"].to(x.dtype)
    return out
