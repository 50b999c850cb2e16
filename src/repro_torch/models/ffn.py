"""Feed-forward blocks: gated (SwiGLU/GeGLU) and plain (GELU/SiLU/ReLU^2)."""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models.layers import ACTIVATIONS, ParamSpec, gelu_tanh


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


def ffn(cfg, p: dict, x: torch.Tensor) -> torch.Tensor:
    act = gate_fn(cfg.activation)
    up = x @ p["w_up"].to(x.dtype)
    if cfg.use_bias:
        up = up + p["b_up"].to(x.dtype)
    if is_gated(cfg.activation):
        h = act(x @ p["w_gate"].to(x.dtype)) * up
    else:
        h = act(up)
    out = h @ p["w_down"].to(x.dtype)
    if cfg.use_bias:
        out = out + p["b_down"].to(x.dtype)
    return out
