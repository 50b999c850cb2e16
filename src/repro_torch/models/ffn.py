"""Feed-forward blocks: gated (SwiGLU/GeGLU) and plain (GELU/SiLU/ReLU^2)."""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models.layers import ACTIVATIONS, ParamSpec, gelu_tanh
from repro_torch.parallel.collectives import copy_to_model, reduce_scatter_seq, scatter_seq, sum_over_model


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


def ffn(cfg, p: dict, x: torch.Tensor, *, fp8=None, mesh=None, sp=False) -> torch.Tensor:
    """``fp8``: an FP8 layer handle (``repro_torch.fp8.policy.Fp8Layer``)
    routes the up/gate/down GEMMs through quantized matmuls (biases and the
    activation stay in the compute dtype).

    Under a tensor-parallel ``mesh`` whose ranks each hold a slice of the
    hidden dim (``w_down`` has fewer than ``cfg.d_ff`` rows): up, gate and
    ``b_up`` are column-parallel, the down product row-parallel, summed by
    one all-reduce, and ``b_down`` is added once, after the sum.  Under
    autograd (sharded training) x passes through ``copy_to_model`` and the
    sum is ``sum_over_model``'s (``parallel.collectives``).

    ``sp`` (sequence parallelism): x is the block's ``SeqGather`` of this
    rank's seq slice and the output this rank's seq slice: where the
    hidden dim splits, the FFN reads the ``split()`` view and its down
    product is reduce-scattered; else it runs whole on every rank on the
    ``whole()`` view and ``scatter_seq`` cuts its output.  ``b_down``,
    added to the slice, takes ``copy_to_model``."""

    def mm(site, a, w):
        return fp8.matmul(site, a, w) if fp8 is not None else a @ w.to(a.dtype)

    split = mesh is not None and p["w_down"].shape[0] != cfg.d_ff
    if sp:
        x = x.split() if split else x.whole()
    elif split:
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
        out = reduce_scatter_seq(out, mesh) if sp else sum_over_model(out.contiguous(), mesh)
    elif sp:
        out = scatter_seq(out, mesh)
    if cfg.use_bias:
        out = out + (copy_to_model(p["b_down"], mesh) if sp else p["b_down"]).to(x.dtype)
    return out
