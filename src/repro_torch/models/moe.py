"""Mixture-of-Experts FFN: GShard routing with expert capacity.

The port of the JAX package's ``models/moe.py`` (qwen3-moe: 128 experts,
top 8; arctic: 128 experts, top 2, beside a dense residual FFN).  The same
semantics, step by step:

  1. router: logits (T, E), in fp32 when ``router_dtype == "float32"``,
     softmax, top-k, the k gates renormalized to sum 1;
  2. capacity: each expert takes ``C = max(4, ceil4(int(T k cf / E)))``
     tokens of a group; a token's pair with expert e takes the next slot of
     e's buffer in token order (the count of earlier tokens that chose e),
     and pairs past C are dropped;
  3. dispatch: each kept pair's token lands in its (expert, slot) row of an
     (E, C, D) buffer;
  4. expert FFN: batched products over the expert axis (``torch.bmm``;
     the JAX package leaves these products to XLA, outside any Pallas
     kernel);
  5. combine: each token sums its kept pairs' expert outputs, weighted by
     their gates.

Tokens route in groups of ``group_size`` when T is a larger multiple of
it, else as one group, and ``aux`` is the Switch load-balance loss
E * sum(fraction routed * mean probability), averaged over the groups and
scaled by ``aux_loss_weight``.

The JAX package dispatches with a one-hot (T, E, C) tensor and einsums.
The port dispatches by index: each (expert, slot) row holds at most one
token, so a scatter of token ids and a gather of their rows fill the same
buffer exactly, and the combine is a gather and a gate-weighted sum over
the k pairs (the same terms, summed in another order).  Dropped pairs
write one dump row, which is never read, and enter the sum at gate 0.
Nothing here reads a value on the host or makes a shape from the data, so
``serving/graphs.py`` can capture the serving steps that call it.

A token sends at most one pair to an expert, so its slot in e's buffer
depends only on the set of experts the earlier tokens chose, not on the
order ``topk`` lists them in.

Under a tensor-parallel ``mesh`` the experts shard over the model axis
(``parallel.sharding``: the ``"expert"`` axis claims it first).
Activations are replicated on a ``(1, tp)`` mesh, so every rank routes
every token with the whole (replicated) router and counts capacity
exactly as above; each rank then fills and runs the buffers of its own
``E / tp`` experts, combines the pairs those experts took, and one
all-reduce sums the ranks' combines, with the shared experts' partial
outputs when their hidden dim is sharded too.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.models.ffn import gate_fn, is_gated
from repro_torch.models.layers import ParamSpec
from repro_torch.parallel.collectives import all_reduce
from repro_torch.parallel.sharding import model_rank


def moe_specs(cfg) -> dict:
    m = cfg.moe
    D, E, F = cfg.d_model, m.num_experts, m.expert_d_ff
    specs = {"router": ParamSpec((D, E), ("embed", "expert_router"), "normal")}
    gated = is_gated(cfg.activation)
    if gated:
        specs["w_gate"] = ParamSpec((E, D, F), ("expert", "embed", "expert_mlp"))
    specs["w_up"] = ParamSpec((E, D, F), ("expert", "embed", "expert_mlp"))
    specs["w_down"] = ParamSpec((E, F, D), ("expert", "expert_mlp", "embed"))
    if m.num_shared_experts > 0:
        S = m.num_shared_experts * F
        if gated:
            specs["shared_w_gate"] = ParamSpec((D, S), ("embed", "mlp"))
        specs["shared_w_up"] = ParamSpec((D, S), ("embed", "mlp"))
        specs["shared_w_down"] = ParamSpec((S, D), ("mlp", "embed"))
    return specs


def capacity(m, tokens_per_group: int) -> int:
    """Slots per expert for a group of ``tokens_per_group`` tokens."""
    c = int(tokens_per_group * m.top_k * m.capacity_factor / m.num_experts)
    return max(4, (c + 3) // 4 * 4)  # round up to a multiple of 4, floor 4


def group_len(m, T: int) -> int:
    """Tokens per routed group: ``group_size`` when T is a larger multiple
    of it, else all T."""
    return m.group_size if (m.group_size and T > m.group_size and T % m.group_size == 0) else T


class Routing(NamedTuple):
    """The router's decision for (groups, T) tokens."""

    probs: torch.Tensor  # (G, T, E) router softmax
    experts: torch.Tensor  # (G, T, k) int64, the top-k experts
    gates: torch.Tensor  # (G, T, k) their renormalized gates
    slot: torch.Tensor  # (G, T, k) int64, each pair's slot in its expert's buffer
    keep: torch.Tensor  # (G, T, k) bool, the slot is below the capacity
    aux: torch.Tensor  # (G,) load-balance loss of each group, unscaled


def route(cfg, router_w: torch.Tensor, xg: torch.Tensor) -> Routing:
    """Route groups of tokens, ``xg`` (G, T, D)."""
    m = cfg.moe
    rdt = torch.float32 if m.router_dtype == "float32" else xg.dtype
    probs = torch.softmax(xg.to(rdt) @ router_w.to(rdt), dim=-1)
    top, experts = torch.topk(probs, m.top_k, dim=-1)
    gates = top / top.sum(dim=-1, keepdim=True)
    chosen = torch.zeros(probs.shape, dtype=torch.int32, device=probs.device).scatter_(-1, experts, 1)
    frac = chosen.to(probs.dtype).mean(dim=-2)  # (G, E) share of tokens routed to each expert
    aux = m.num_experts * (frac * probs.mean(dim=-2)).sum(dim=-1)
    before = torch.cumsum(chosen, dim=-2) - chosen  # earlier tokens of the group that chose each expert
    slot = torch.gather(before, -1, experts)
    return Routing(probs, experts, gates, slot, slot < capacity(m, xg.shape[1]), aux)


def _experts(cfg, p: dict, xe: torch.Tensor) -> torch.Tensor:
    """Every expert's FFN on its rows: (E, N, D) -> (E, N, D)."""
    act = gate_fn(cfg.activation)
    up = torch.bmm(xe, p["w_up"].to(xe.dtype))
    h = act(torch.bmm(xe, p["w_gate"].to(xe.dtype))) * up if is_gated(cfg.activation) else act(up)
    return torch.bmm(h, p["w_down"].to(xe.dtype))


def moe_ffn(cfg, p: dict, x: torch.Tensor, *, mesh=None) -> tuple[torch.Tensor, torch.Tensor]:
    """MoE FFN over (B, S, D).  Returns (out (B, S, D), aux loss).  Under
    a ``mesh`` whose ranks each hold a slice of the experts, this rank runs
    its experts and the combine is summed over the ranks (module
    docstring)."""
    m = cfg.moe
    B, S, D = x.shape
    T = B * S
    E, k = m.num_experts, m.top_k
    xt = x.reshape(T, D)
    G = group_len(m, T)
    ng = T // G
    C = capacity(m, G)
    r = route(cfg, p["router"], xt.reshape(ng, G, D))

    # each pair's row of the expert buffers, expert-major, then group, then slot
    dev = x.device
    group = torch.arange(ng, device=dev).view(ng, 1, 1)
    row = (r.experts * ng + group) * C + r.slot
    rows = E * ng * C
    # this rank's experts: all of them, or its slice under a mesh
    E_local = p["w_up"].shape[0]
    split = mesh is not None and E_local != E
    first = model_rank(mesh) * E_local * ng * C if split else 0
    local_rows = E_local * ng * C
    # dispatch: the token id of every row; the dropped pairs write a dump
    # row past the end, and empty rows read row T of xt's extension: zeros
    src = torch.full((rows + 1,), T, dtype=torch.int64, device=dev)
    src.scatter_(0, torch.where(r.keep, row, rows).reshape(T * k), torch.arange(T, device=dev).repeat_interleave(k))
    xe = torch.cat([xt, xt.new_zeros(1, D)])[src[first : first + local_rows]].view(E_local, ng * C, D)
    ye = _experts(cfg, p, xe).view(local_rows, D)
    # combine: a dropped pair (or, under a mesh, one another rank's expert
    # took) reads row 0 at gate 0
    taken = r.keep & (row >= first) & (row < first + local_rows) if split else r.keep
    picked = ye[torch.where(taken, row - first, 0).reshape(T * k)].view(T, k, D)
    gates = torch.where(taken, r.gates, 0.0).to(x.dtype)
    out = (gates.reshape(T, k, 1) * picked).sum(dim=1)
    partial = split  # whether ``out`` is this rank's share of a sum over ranks

    # always-on shared experts (DeepSeek-style)
    if m.num_shared_experts > 0:
        act = gate_fn(cfg.activation)
        up = xt @ p["shared_w_up"].to(xt.dtype)
        up = act(xt @ p["shared_w_gate"].to(xt.dtype)) * up if is_gated(cfg.activation) else act(up)
        shared = up @ p["shared_w_down"].to(xt.dtype)
        if mesh is not None and (p["shared_w_down"].shape[0] != m.num_shared_experts * m.expert_d_ff) != partial:
            # one part is a share of a sum, the other whole: sum the share first
            if partial:
                out, partial = all_reduce(out.contiguous(), mesh), False
            else:
                shared = all_reduce(shared.contiguous(), mesh)
        out = out + shared
    if partial:
        out = all_reduce(out.contiguous(), mesh)
    return out.reshape(B, S, D), r.aux.mean() * m.aux_loss_weight
