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
outputs when their hidden dim is sharded too.  Every rank issues the same
collectives in the same order, a rank whose experts took no pair too.

**Sharded training** (``models.forward(mesh=)``) runs the same layout
under autograd, with two traps:

1. *Every gradient that reaches a replicated tensor is either summed once
   over ``"model"`` or computed whole on every rank, never both.*  The
   router and the load-balance loss are computed whole on every rank; the
   dispatch gathers only this rank's experts' tokens and the combine only
   their pairs, so the gradient into the dispatch's input and into the
   gates is partial: ``copy_to_model`` sums it, on the tensor that feeds
   only the dispatch (not the token rows, which also feed the router) and
   on the gates before the other ranks' pairs are masked out.  The
   combine's sum is ``sum_over_model`` (the identity backward); serving,
   under ``torch.no_grad()``, keeps the in-place all-reduce.
2. *Capacity from the global token order.*  Each data rank holds
   contiguous rows of each microbatch (``train.step.local_rows``), so its
   tokens sit at ``[r T, (r + 1) T)`` of the microbatch's flattened order,
   and a routed group of ``group_size`` tokens may span data ranks
   (``route_spanning``).  The group length and ``C`` come from the global
   group; a token's slot counts the earlier tokens of the whole group (the
   lower data ranks' per-expert counts, ``exchange_counts``, plus this
   rank's exclusive count); ``frac`` and ``mean_prob`` are the group's
   global means, the latter through ``sum_over_data``, whose backward sums
   too (each rank's loss holds the whole group's aux, which depends on
   every rank's probabilities).  A rank fills only its own tokens' rows of
   the buffers of the groups it holds, and the experts act row by row, so
   its tokens' outputs are the reference's.

**Sequence parallelism** (``moe_ffn(sp=True)``): the layer takes the
block's ``SeqGather`` of its seq slices, so every rank routes the whole
sequence's tokens in the same order as above, and returns this rank's seq
slice.  The router and the load-balance loss are computed whole on every
rank, so they read the ``whole()`` view (this rank's slice of their
gradient); the dispatch of this rank's experts reads the ``split()`` view
(the reduce-scatter sums the ranks' shares) and the combine's sum is
``reduce_scatter_seq``.  A part that runs whole on every rank reads the
``whole()`` view and ``scatter_seq`` cuts its output.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.models.ffn import gate_fn, is_gated
from repro_torch.models.layers import ParamSpec
from repro_torch.parallel.collectives import (
    copy_to_model,
    exchange_counts,
    reduce_scatter_seq,
    scatter_seq,
    sum_over_data,
    sum_over_model,
)
from repro_torch.parallel.sharding import data_axis, model_rank


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


def _router(cfg, router_w: torch.Tensor, x: torch.Tensor):
    """(probs, experts, gates, chosen) of tokens ``x`` (..., D): the router
    softmax, the top-k experts, their renormalized gates and the (..., E)
    int32 mask of the chosen experts."""
    m = cfg.moe
    rdt = torch.float32 if m.router_dtype == "float32" else x.dtype
    probs = torch.softmax(x.to(rdt) @ router_w.to(rdt), dim=-1)
    top, experts = torch.topk(probs, m.top_k, dim=-1)
    gates = top / top.sum(dim=-1, keepdim=True)
    chosen = torch.zeros(probs.shape, dtype=torch.int32, device=probs.device).scatter_(-1, experts, 1)
    return probs, experts, gates, chosen


def route(cfg, router_w: torch.Tensor, xg: torch.Tensor) -> Routing:
    """Route groups of tokens, ``xg`` (G, T, D)."""
    m = cfg.moe
    probs, experts, gates, chosen = _router(cfg, router_w, xg)
    frac = chosen.to(probs.dtype).mean(dim=-2)  # (G, E) share of tokens routed to each expert
    aux = m.num_experts * (frac * probs.mean(dim=-2)).sum(dim=-1)
    before = torch.cumsum(chosen, dim=-2) - chosen  # earlier tokens of the group that chose each expert
    slot = torch.gather(before, -1, experts)
    return Routing(probs, experts, gates, slot, slot < capacity(m, xg.shape[1]), aux)


def lower_ranks(counts: torch.Tensor, rank: int) -> torch.Tensor:
    """The (groups, E) per-expert counts of the data ranks before ``rank``,
    from every rank's ``counts`` (ranks, groups, E): where this rank's
    tokens start counting each expert's slots in each group."""
    return counts[:rank].sum(dim=0)


def route_spanning(cfg, router_w: torch.Tensor, xt: torch.Tensor, mesh, G: int) -> tuple[Routing, torch.Tensor, int]:
    """Route this data rank's tokens ``xt`` (T, D), which sit at ``[r T, (r
    + 1) T)`` of the microbatch's global token order over the ``d`` data
    ranks of ``mesh``, in the global groups of ``G`` tokens (trap 2 of the
    module docstring).  Returns (routing, grp, nl): the routing of the
    tokens as one row (``probs`` (1, T, E), ``experts`` ... ``keep`` (1, T,
    k)) with ``aux`` (ng,), the load-balance loss of every global group,
    the same on every rank; ``grp`` (T,), each token's group among this
    rank's ``nl`` groups (the first of which holds its first token).  One
    ``exchange_counts`` and one ``sum_over_data`` over the data axis, on
    every rank whatever its tokens chose."""
    m = cfg.moe
    E, (d, r), T = m.num_experts, data_axis(mesh), xt.shape[0]
    ng, first = T * d // G, r * T
    g0 = first // G
    nl = (first + T - 1) // G - g0 + 1
    dev = xt.device
    grp = (first + torch.arange(T, device=dev)) // G - g0
    probs, experts, gates, chosen = _router(cfg, router_w, xt)
    counts = torch.zeros((ng, E), dtype=torch.int32, device=dev).index_add_(0, grp + g0, chosen)
    counts = exchange_counts(counts, mesh)  # (d, ng, E): every data rank's, exact
    # the probabilities' per-group sums as a product with the (T, nl) one-hot
    # of the tokens' groups among this rank's (one summation order on every
    # model rank), placed at the rows of those groups among all ng
    member = torch.zeros((T, nl), dtype=probs.dtype, device=dev).scatter_(1, grp[:, None], 1.0)
    frac = counts.sum(dim=0).to(probs.dtype) / G  # (ng, E) the group's share of tokens routed to each expert
    mean_prob = sum_over_data(F.pad(member.T @ probs, (0, 0, g0, ng - g0 - nl)), mesh) / G
    aux = E * (frac * mean_prob).sum(dim=-1)  # (ng,)
    # a token's slot: the lower ranks' tokens of its group, then this rank's earlier ones
    cum = torch.cumsum(chosen, dim=0) - chosen  # this rank's earlier tokens, over all its groups
    mine = counts[r, g0 : g0 + nl]  # (nl, E) this rank's counts of each of its groups
    earlier_groups = torch.cumsum(mine, dim=0) - mine  # this rank's tokens in its earlier groups
    before = lower_ranks(counts, r)[g0 + grp] + cum - earlier_groups[grp]
    slot = torch.gather(before, -1, experts)
    keep = slot < capacity(m, G)
    return Routing(probs[None], experts[None], gates[None], slot[None], keep[None], aux), grp, nl


def _experts(cfg, p: dict, xe: torch.Tensor) -> torch.Tensor:
    """Every expert's FFN on its rows: (E, N, D) -> (E, N, D)."""
    act = gate_fn(cfg.activation)
    up = torch.bmm(xe, p["w_up"].to(xe.dtype))
    h = act(torch.bmm(xe, p["w_gate"].to(xe.dtype))) * up if is_gated(cfg.activation) else act(up)
    return torch.bmm(h, p["w_down"].to(xe.dtype))


def moe_ffn(cfg, p: dict, x: torch.Tensor, *, mesh=None, sp=False) -> tuple[torch.Tensor, torch.Tensor]:
    """MoE FFN over (B, S, D).  Returns (out (B, S, D), aux loss).  Under
    a ``mesh`` whose ranks each hold a slice of the experts, this rank runs
    its experts and the combine is summed over the ranks; under a training
    mesh with more than one data rank, ``x`` is this rank's rows of the
    microbatch and the groups, capacity and aux are the global batch's
    (module docstring).  ``sp``: x is a ``SeqGather`` of this rank's seq
    slice and ``out`` this rank's seq slice, (B, S / tp, D)."""
    m = cfg.moe
    gathered = x if sp else None
    if sp:
        x = gathered.whole()  # the router's input, computed whole on every rank
    B, S, D = x.shape
    T = B * S
    E, k = m.num_experts, m.top_k
    xt = x.reshape(T, D)

    def part_input(split: bool) -> torch.Tensor:
        """The (T, D) tokens of a part whose ranks each hold a share
        (``split``) or that runs whole."""
        if sp:
            return (gathered.split() if split else gathered.whole()).reshape(T, D)
        return copy_to_model(xt, mesh) if split else xt

    dev = x.device
    d = data_axis(mesh)[0]
    G = group_len(m, T * d)
    C = capacity(m, G)
    if d == 1:
        ng = T // G
        r = route(cfg, p["router"], xt.reshape(ng, G, D))
        grp, nl = torch.arange(T, device=dev) // G, ng
    else:
        r, grp, nl = route_spanning(cfg, p["router"], xt, mesh, G)
    experts, slot, keep = (t.reshape(T, k) for t in (r.experts, r.slot, r.keep))

    # each pair's row of the expert buffers, expert-major, then (this
    # rank's) group, then slot
    row = (experts * nl + grp[:, None]) * C + slot
    rows = E * nl * C
    # this rank's experts: all of them, or its slice under a mesh
    E_local = p["w_up"].shape[0]
    split = mesh is not None and E_local != E
    first = model_rank(mesh) * E_local * nl * C if split else 0
    local_rows = E_local * nl * C
    # dispatch: the token id of every row; the dropped pairs write a dump
    # row past the end, and empty rows read row T of xt's extension: zeros.
    # Trap 1: only this rank's experts' rows are gathered, so the gradient
    # into the dispatch's input is partial (the router's input ``xt`` is not)
    src = torch.full((rows + 1,), T, dtype=torch.int64, device=dev)
    src.scatter_(0, torch.where(keep, row, rows).reshape(T * k), torch.arange(T, device=dev).repeat_interleave(k))
    xd = part_input(split)
    xe = torch.cat([xd, xd.new_zeros(1, D)])[src[first : first + local_rows]].view(E_local, nl * C, D)
    ye = _experts(cfg, p, xe).view(local_rows, D)
    # combine: a dropped pair (or, under a mesh, one another rank's expert
    # took) reads row 0 at gate 0.  Trap 1: the gates' gradient from the
    # combine is partial, summed before the mask
    taken = keep & (row >= first) & (row < first + local_rows) if split else keep
    picked = ye[torch.where(taken, row - first, 0).reshape(T * k)].view(T, k, D)
    gates = copy_to_model(r.gates.reshape(T, k), mesh) if split else r.gates.reshape(T, k)
    gates = torch.where(taken, gates, 0.0).to(x.dtype)
    out = (gates.reshape(T, k, 1) * picked).sum(dim=1)
    partial = split  # whether ``out`` is this rank's share of a sum over ranks

    shared, shared_split = None, False
    # always-on shared experts (DeepSeek-style)
    if m.num_shared_experts > 0:
        act = gate_fn(cfg.activation)
        shared_split = mesh is not None and p["shared_w_down"].shape[0] != m.num_shared_experts * m.expert_d_ff
        xs = part_input(shared_split)
        up = xs @ p["shared_w_up"].to(xs.dtype)
        up = act(xs @ p["shared_w_gate"].to(xs.dtype)) * up if is_gated(cfg.activation) else act(up)
        shared = up @ p["shared_w_down"].to(xs.dtype)
    aux = r.aux.mean() * m.aux_loss_weight
    if sp:
        shared = None if shared is None else shared.reshape(B, S, D)
        return _seq_combine(out.reshape(B, S, D), partial, shared, shared_split, mesh), aux
    if shared is not None:
        if shared_split != partial:
            # one part is a share of a sum, the other whole: sum the share first
            if partial:
                out, partial = sum_over_model(out.contiguous(), mesh), False
            else:
                shared = sum_over_model(shared.contiguous(), mesh)
        out = out + shared
    if partial:
        out = sum_over_model(out.contiguous(), mesh)
    return out.reshape(B, S, D), aux


def _seq_combine(out, partial: bool, shared, shared_partial: bool, mesh):
    """Under sequence parallelism: this rank's seq slice of ``out`` plus
    ``shared`` (either None), each (B, S, D) rows of the whole sequence: the
    parts that are shares of a sum over the model ranks summed and
    reduce-scattered, the whole ones cut by ``scatter_seq``."""
    parts = [(out, partial)] + ([(shared, shared_partial)] if shared is not None else [])
    shares = [t for t, is_share in parts if is_share]
    wholes = [t for t, is_share in parts if not is_share]
    got = []
    if shares:
        got.append(reduce_scatter_seq(shares[0] if len(shares) == 1 else shares[0] + shares[1], mesh))
    if wholes:
        got.append(scatter_seq(wholes[0] if len(wholes) == 1 else wholes[0] + wholes[1], mesh))
    return got[0] if len(got) == 1 else got[0] + got[1]
