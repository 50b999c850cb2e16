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
4. The training collectives of sharded and FSDP training
   (``train.step``), ``torch.autograd.Function``s where autograd must see
   them:

   * ``copy_to_model``: the identity forward, an all-reduce of the
     gradient over ``"model"`` backward; it goes before every
     column-parallel product (the replicated input's gradient is the sum
     of the ranks' partial ones), and on a replicated leaf used inside the
     head split (the q/k norm scales);
   * ``sum_over_model``: an all-reduce over ``"model"`` forward, the
     identity backward; after every row-parallel product and the
     vocab-parallel embedding.  Without autograd (serving, under
     ``torch.no_grad()``) it is the in-place ``all_reduce``;
   * ``gather_over_data``: FSDP's all-gather of one leaf along its
     data-sharded dim forward, a reduce-scatter (sum) of its gradient
     backward;
   * ``sum_over_data``: an all-reduce over ``"data"`` in both directions,
     for a quantity of the global batch that every data rank computes
     whole from every rank's part (the moe load-balance loss of a routed
     group whose tokens span data ranks: each rank's loss term depends on
     every rank's router probabilities, so the gradient of the sum is the
     sum of the ranks' gradients);
   * ``exchange_counts``: an all-gather over ``"data"`` of integer counts,
     outside autograd (the moe routing's per-expert counts, from which a
     rank places its tokens after the lower data ranks' in the global
     token order);
   * ``all_reduce_over``, ``all_reduce_max`` and ``max_over_model``,
     outside autograd: sums over ``"data"`` (the loss metrics, the
     gradients of leaves replicated over data) or over the axes a leaf is
     sharded on (the gradient norm), counted as ``all_reduce_sum``; maxima over the mesh's ranks (the fp8 amaxes, the
     int8 scales) and over ``"model"`` (the vocab-parallel cross-entropy's
     max).  A reduction over both axes runs one collective an axis, so it
     covers the mesh's ranks, not the whole world (an elastic mesh).

5. Sequence parallelism (``models.forward(sequence_parallel=True)``): the
   residual stream between the sublayers is this rank's contiguous slice
   ``(B, S / tp, ...)`` of the sequence (dim 1), the Megatron layout that
   GSPMD runs for the JAX package's ``"seq"`` rule.  Autograd-aware, each
   the identity where the model axis is 1:

   * ``SeqGather``: one all-gather of a sublayer input's slices, in two
     views: ``split()`` (its gradient the reduce-scatter, a sum, of the
     ranks' shares: a column-parallel product's input, where tensor
     parallelism has ``copy_to_model``; ``gather_seq`` makes one) and
     ``whole()`` (for a branch that every rank computes whole, as tensor
     parallelism does: this rank's slice of the whole gradient, no
     collective);
   * ``reduce_scatter_seq``: the ranks' partial outputs summed and this
     rank's slice kept forward (a row-parallel product's output, where
     tensor parallelism has ``sum_over_model``), the all-gather of the
     gradient backward;
   * ``scatter_seq``: this rank's slice of a tensor that every rank holds
     whole forward (a whole branch's output, the embedding of a replicated
     table), the all-gather of the gradient backward, so what made the
     tensor takes its whole gradient on every rank, as under tensor
     parallelism;
   * ``seq_slice`` (no collective): a plain slice, whose gradient is this
     rank's share;
   * ``copy_leaves_to_model``: ``copy_to_model`` on the replicated leaves
     that act on the slice (a norm's scale and bias, a bias added after a
     reduce-scatter, a gate), whose gradient on each rank is its
     positions' share.

   Each rank issues them in the same order, a remat recompute included.

   Each adds one to ``TRAIN_COLLECTIVES[name]`` and its operand's bytes to
   ``TRAIN_COLLECTIVES[name + "_bytes"]`` where it calls the collective:
   ``copy_to_model``, ``gather_over_data`` and ``sum_over_data`` in their
   backward too (as ``copy_to_model``, ``reduce_scatter_data`` and
   ``sum_over_data``).  The sequence collectives count by the collective
   they issue: ``gather_seq`` (an all-gather of slices: ``SeqGather``'s
   forward, the backward of ``reduce_scatter_seq`` and ``scatter_seq``;
   the bytes of the slice) and ``reduce_scatter_seq`` (``reduce_scatter_seq``'s
   forward, ``split()``'s backward; the bytes of the whole sequence).
   ``reset_collectives`` sets both tables to 0.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.distributed as dist

from repro_torch.utils.tree import tree_leaves, tree_map, tree_paths

# ---------------------------------------------------------------------------
# gradient compression (with error feedback)
# ---------------------------------------------------------------------------

COMPRESSION_METHODS = ("none", "bf16", "int8")


def _quantize_int8(g: torch.Tensor, amax: torch.Tensor | None = None) -> tuple[torch.Tensor, torch.Tensor]:
    """int8 codes of ``g`` and their per-tensor scale, ``max|g|`` / 127;
    ``amax`` is ``max|g|`` over the whole leaf where ``g`` is one shard."""
    amax = torch.max(torch.abs(g)) if amax is None else amax
    scale = torch.clamp(amax, min=1e-12) / 127.0
    q = torch.clamp(torch.round(g / scale), -127, 127).to(torch.int8)
    return q, scale


def compress_gradients(grads, residual, method: str = "none", mesh=None):
    """Returns (compressed-then-decompressed grads, new residual).

    ``residual`` is the error-feedback state: a tree like ``grads`` of
    fp32 tensors (``init_compression_state``).  int8's per-tensor scale
    is the JAX package's: ``max|g|`` over the whole leaf of the JAX tree,
    which stacks every layer's leaf (``blocks/<layer>/attn/wq`` of all
    layers is one leaf there), so the port takes the maximum over the
    layers' leaves of one name.  Under a training ``mesh`` the leaves are
    this rank's shards and the maximum is also taken over the mesh's ranks
    (one collective for every leaf; a replicated leaf's copies are equal).
    The residual stays sharded."""
    if method == "none":
        return grads, residual
    if method not in COMPRESSION_METHODS:
        raise ValueError(f"unknown grad_compression {method!r}")
    pairs = tree_leaves(tree_map(lambda g, r: (g, r), grads, residual))  # by key
    gfs = [g.float() + r for g, r in pairs]
    amaxes = [None] * len(gfs)
    if method == "int8":
        amaxes = _stacked_amaxes(grads, [torch.max(torch.abs(gf)) for gf in gfs], mesh)

    def one(g, gf, amax):
        if method == "bf16":
            gq = gf.to(torch.bfloat16).float()
        else:
            q, scale = _quantize_int8(gf, amax)
            gq = q.float() * scale
        return gq.to(g.dtype), gf - gq

    out = [one(g, gf, a) for (g, _), gf, a in zip(pairs, gfs, amaxes)]
    it_g, it_r = iter(o[0] for o in out), iter(o[1] for o in out)
    return tree_map(lambda _: next(it_g), grads), tree_map(lambda _: next(it_r), grads)


def _stacked_amaxes(tree, amaxes: list, mesh=None) -> list:
    """Each leaf's ``max|g|`` over its stacked leaf: the maximum of
    ``amaxes`` over the leaves whose paths differ only in list indices
    (the layers, and a vlm group's self layers), then over the mesh."""
    keys = [tuple(p for p in path if not isinstance(p, int)) for path in tree_paths(tree)]
    stacked = torch.stack(amaxes)
    out = stacked.clone()
    for key in dict.fromkeys(keys):
        idx = [i for i, k in enumerate(keys) if k == key]
        out[idx] = torch.max(stacked[idx])
    if mesh is not None:
        out = all_reduce_max(out, mesh)
    return list(out.unbind())


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
# the same for the training collectives (section 4 of the module docstring)
TRAIN_NAMES = ("copy_to_model", "sum_over_model", "gather_over_data", "reduce_scatter_data", "all_reduce_sum",
               "all_reduce_max", "max_over_model", "sum_over_data", "exchange_counts", "gather_seq",
               "reduce_scatter_seq")
TRAIN_COLLECTIVES = {f"{n}{s}": 0 for n in TRAIN_NAMES for s in ("", "_bytes")}


def reset_collectives() -> None:
    for table in (COLLECTIVES, TRAIN_COLLECTIVES):
        for name in table:
            table[name] = 0


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


# ---------------------------------------------------------------------------
# training collectives: the autograd-aware pair, FSDP's gather, reductions
# ---------------------------------------------------------------------------


def _count(name: str, x: torch.Tensor) -> None:
    TRAIN_COLLECTIVES[name] += 1
    TRAIN_COLLECTIVES[name + "_bytes"] += x.numel() * x.element_size()


def _size(mesh, axis: str) -> int:
    return 1 if mesh is None else mesh.size(mesh.mesh_dim_names.index(axis))


def _summed(x: torch.Tensor, group, name: str, op=dist.ReduceOp.SUM) -> torch.Tensor:
    """A new contiguous tensor holding ``x`` reduced over ``group``."""
    y = x.clone(memory_format=torch.contiguous_format)
    dist.all_reduce(y, op=op, group=group)
    _count(name, y)
    return y


class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _summed(g, ctx.group, "copy_to_model"), None


class _SumOverModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return _summed(x, group, "sum_over_model")

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherOverData(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim, n):
        ctx.group, ctx.dim, ctx.n = group, dim, n
        x = x.contiguous()
        parts = [torch.empty_like(x) for _ in range(n)]
        dist.all_gather(parts, x, group=group)
        _count("gather_over_data", x)
        return torch.cat(parts, dim=dim)

    @staticmethod
    def backward(ctx, g):
        # the ranks' gradients of the whole leaf, summed, and this rank's
        # slice of the sum: a reduce-scatter along dim 0 of the moved view
        rows = g.movedim(ctx.dim, 0).contiguous()
        out = torch.empty((rows.shape[0] // ctx.n,) + rows.shape[1:], dtype=g.dtype, device=g.device)
        dist.reduce_scatter_tensor(out, rows, group=ctx.group)
        _count("reduce_scatter_data", rows)
        return out.movedim(0, ctx.dim), None, None, None


class _SumOverData(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _summed(x, group, "sum_over_data")

    @staticmethod
    def backward(ctx, g):
        return _summed(g, ctx.group, "sum_over_data"), None


def copy_to_model(x: torch.Tensor, mesh) -> torch.Tensor:
    """``x`` as it is; autograd sums its gradient over the model axis.
    The identity where autograd does not record (serving) or the model
    axis is 1."""
    if _size(mesh, "model") == 1 or not (torch.is_grad_enabled() and x.requires_grad):
        return x
    return _CopyToModel.apply(x, model_group(mesh))


def sum_over_model(x: torch.Tensor, mesh) -> torch.Tensor:
    """``x`` summed over the model axis: out of place and the identity
    backward where autograd records, else the serving ``all_reduce`` in
    place (``x`` must then be contiguous)."""
    if torch.is_grad_enabled() and x.requires_grad:
        return _SumOverModel.apply(x, model_group(mesh))
    return all_reduce(x, mesh)


def gather_over_data(x: torch.Tensor, mesh, dim: int) -> torch.Tensor:
    """The whole leaf from every data rank's slice along ``dim`` (rank
    order); the backward reduce-scatters (sums) the gradient."""
    n = _size(mesh, "data")
    if n == 1:
        return x
    return _GatherOverData.apply(x, mesh.get_group("data"), dim, n)


def sum_over_data(x: torch.Tensor, mesh) -> torch.Tensor:
    """``x`` summed over the data axis, out of place; where autograd
    records, the backward sums the gradient over the data axis too (the
    loss of every data rank depends on every rank's ``x``).  ``x`` itself
    where the data axis is 1."""
    if _size(mesh, "data") == 1:
        return x
    if torch.is_grad_enabled() and x.requires_grad:
        return _SumOverData.apply(x, mesh.get_group("data"))
    return _summed(x, mesh.get_group("data"), "sum_over_data")


def exchange_counts(x: torch.Tensor, mesh) -> torch.Tensor:
    """Every data rank's integer ``x``, stacked in data-rank order on a new
    leading axis, outside autograd; ``x[None]`` where the data axis is 1."""
    n = _size(mesh, "data")
    if n == 1:
        return x[None]
    x = x.detach().contiguous()
    parts = [torch.empty_like(x) for _ in range(n)]
    dist.all_gather(parts, x, group=mesh.get_group("data"))
    _count("exchange_counts", x)
    return torch.stack(parts)


def _over(x: torch.Tensor, mesh, axes: tuple, name: str, op=dist.ReduceOp.SUM) -> torch.Tensor:
    """``x`` reduced over the mesh ``axes`` in turn, one collective an axis
    of more than one rank (a new tensor; ``x`` itself where there is none).
    Over both axes this is the reduction over the mesh's ranks, which need
    not be the whole world (an elastic or a tenant mesh)."""
    for axis in axes:
        if _size(mesh, axis) > 1:
            x = _summed(x, mesh.get_group(axis), name, op)
    return x


def all_reduce_max(x: torch.Tensor, mesh) -> torch.Tensor:
    """The elementwise maximum of ``x`` over every rank of the mesh."""
    return _over(x.detach(), mesh, ("data", "model"), "all_reduce_max", dist.ReduceOp.MAX)


def max_over_model(x: torch.Tensor, mesh) -> torch.Tensor:
    """The elementwise maximum of ``x`` over the model axis, outside
    autograd (detached)."""
    return _over(x.detach(), mesh, ("model",), "max_over_model", dist.ReduceOp.MAX)


def all_reduce_over(x: torch.Tensor, mesh, axes: tuple) -> torch.Tensor:
    """``x`` summed over the mesh ``axes`` (a subset of ``("data",
    "model")``), outside autograd: a new tensor, or ``x`` itself where no
    axis has more than one rank."""
    return _over(x, mesh, tuple(a for a in ("data", "model") if a in axes), "all_reduce_sum")


# ---------------------------------------------------------------------------
# sequence parallelism: the residual stream split over "model" along dim 1
# ---------------------------------------------------------------------------

SEQ_DIM = 1


def _all_gather_seq(x: torch.Tensor, group, n: int) -> torch.Tensor:
    """Every rank's ``x`` concatenated along the seq dim in rank order."""
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(n)]
    dist.all_gather(parts, x, group=group)
    _count("gather_seq", x)
    return torch.cat(parts, dim=SEQ_DIM)


def _reduce_scatter_seq(x: torch.Tensor, group, n: int) -> torch.Tensor:
    """The ranks' ``x`` summed, and this rank's slice along the seq dim of
    the sum."""
    rows = x.movedim(SEQ_DIM, 0).contiguous()
    if rows.shape[0] % n:
        raise ValueError(f"seq {rows.shape[0]} does not split over {n} ranks")
    out = torch.empty((rows.shape[0] // n,) + rows.shape[1:], dtype=x.dtype, device=x.device)
    dist.reduce_scatter_tensor(out, rows, group=group)
    _count("reduce_scatter_seq", rows)
    return out.movedim(0, SEQ_DIM)


def _own_slice(x: torch.Tensor, group, n: int) -> torch.Tensor:
    s = x.shape[SEQ_DIM] // n
    return x.narrow(SEQ_DIM, dist.get_rank(group) * s, s)


class _SplitEdge(torch.autograd.Function):
    """The gathered sequence ``full`` (gathered from ``x``) as a function
    of ``x`` whose gradient is each rank's share: reduce-scattered."""

    @staticmethod
    def forward(ctx, x, full, group, n):
        ctx.group, ctx.n = group, n
        return full.view_as(full)

    @staticmethod
    def backward(ctx, g):
        return _reduce_scatter_seq(g, ctx.group, ctx.n), None, None, None


class _WholeEdge(torch.autograd.Function):
    """The gathered sequence ``full`` as a function of ``x`` whose gradient
    every rank computes whole: this rank's slice of it."""

    @staticmethod
    def forward(ctx, x, full, group, n):
        ctx.group, ctx.n = group, n
        return full.view_as(full)

    @staticmethod
    def backward(ctx, g):
        return _own_slice(g, ctx.group, ctx.n).contiguous(), None, None, None


class _ReduceScatterSeq(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, n):
        ctx.group, ctx.n = group, n
        return _reduce_scatter_seq(x, group, n)

    @staticmethod
    def backward(ctx, g):
        return _all_gather_seq(g, ctx.group, ctx.n), None, None


class _ScatterSeq(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, n):
        ctx.group, ctx.n = group, n
        return _own_slice(x, group, n).contiguous()

    @staticmethod
    def backward(ctx, g):
        return _all_gather_seq(g, ctx.group, ctx.n), None, None


class SeqGather:
    """This rank's seq slice ``x`` (B, S / tp, ...) and the whole sequence,
    all-gathered once (on first use) for every sublayer that reads it, in
    two views that differ only in their backward (section 5 of the module
    docstring):

    * ``split()``: for a sublayer whose ranks each compute a share of the
      gradient (a column-parallel product): the reduce-scatter (sum) of
      the ranks' gradients;
    * ``whole()``: for a branch that every rank computes whole, its output
      cut by ``scatter_seq``: this rank's slice of the whole gradient, no
      collective.

    Each view is made once, so two sublayers that read one view (the
    parallel residual's attention and FFN) share its backward collective.
    Where the model axis is 1 both views are ``x``."""

    def __init__(self, x: torch.Tensor, mesh):
        self.x, self.mesh, self.n = x, mesh, _size(mesh, "model")
        self._full = None
        self._views = {}

    def _view(self, edge) -> torch.Tensor:
        if self.n == 1:
            return self.x
        if edge not in self._views:
            group = model_group(self.mesh)
            if self._full is None:
                self._full = _all_gather_seq(self.x.detach(), group, self.n)
            self._views[edge] = edge.apply(self.x, self._full, group, self.n)
        return self._views[edge]

    def split(self) -> torch.Tensor:
        return self._view(_SplitEdge)

    def whole(self) -> torch.Tensor:
        return self._view(_WholeEdge)


def _seq_apply(fn, x: torch.Tensor, mesh) -> torch.Tensor:
    n = _size(mesh, "model")
    return x if n == 1 else fn.apply(x, model_group(mesh), n)


def gather_seq(x: torch.Tensor, mesh) -> torch.Tensor:
    """The whole sequence from every model rank's slice ``x`` (B, S / tp,
    ...): an all-gather forward, a reduce-scatter (sum) of the gradient
    backward (``SeqGather(x, mesh).split()``)."""
    return SeqGather(x, mesh).split()


def reduce_scatter_seq(x: torch.Tensor, mesh) -> torch.Tensor:
    """This rank's slice of the model ranks' ``x`` (B, S, ...) summed: a
    reduce-scatter forward, an all-gather of the gradient backward."""
    return _seq_apply(_ReduceScatterSeq, x, mesh)


def scatter_seq(x: torch.Tensor, mesh) -> torch.Tensor:
    """This rank's slice of ``x`` (B, S, ...), which every model rank holds
    whole: no collective forward, an all-gather of the gradient backward,
    so what made ``x`` takes its whole gradient on every rank."""
    return _seq_apply(_ScatterSeq, x, mesh)


def seq_slice(x: torch.Tensor, mesh) -> torch.Tensor:
    """This rank's slice of ``x`` (B, S, ...) along the seq dim, a plain
    slice (autograd gives the rest of ``x`` a zero gradient)."""
    n = _size(mesh, "model")
    return x if n == 1 else _own_slice(x, model_group(mesh), n)


def copy_leaves_to_model(tree: dict, mesh, names=None) -> dict:
    """``tree`` (a dict of leaves) with each leaf of ``names`` (default:
    every one) through ``copy_to_model``: the replicated leaves whose
    gradient on each rank is that rank's share (a norm's scale acting on
    the seq slice)."""
    return {k: copy_to_model(v, mesh) if names is None or k in names else v for k, v in tree.items()}
