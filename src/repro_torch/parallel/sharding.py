"""Logical-axis sharding rule engine, and the layout tensor-parallel
serving runs.

A copy of the JAX package's ``parallel/sharding.py`` rule engine: every
parameter and cache tensor carries a tuple of *logical* axis names (the
``ParamSpec``s of ``models``), and a **greedy, divisibility-checked**
assignment maps them onto mesh axes:

* each logical axis has an ordered candidate list of mesh axes (or axis
  tuples, e.g. the combined FSDP axes ``("pod", "data")``);
* per tensor, candidates are claimed first-come-first-served, in the order
  of the rule table (dict order is the claim priority), so no mesh axis is
  used twice on one tensor;
* a candidate is skipped when the dim is not divisible by the mesh-axis
  size, which is how one table serves every architecture (hymba's 25 heads
  fall back while its FFN still shards).

A spec is a plain tuple, one entry a dim: a mesh-axis name, a tuple of
names, or ``None`` (replicated), where the JAX package has a
``PartitionSpec``.  ``axis_sizes`` reads a ``torch.distributed``
``DeviceMesh`` (``mesh_dim_names`` and ``shape``) or any object with a
``.shape`` dict, so the production 16x16 geometry is checked with no ranks
(``launch.mesh.make_production_mesh``).

**The executed layout.**  GSPMD runs any layout the table gives; the port
runs its collectives by hand (``parallel.collectives``), and so executes
the table's claims of ``"model"`` on five logical axes only
(``EXECUTED_AXES``): attention ``heads`` / ``kv_heads`` (column-parallel
Q/K/V over the local heads, a row-parallel output with one all-reduce),
FFN ``mlp`` (column-parallel up/gate, row-parallel down, one all-reduce),
the MoE ``expert`` axis (each rank runs its experts, one all-reduce of the
combine) and ``vocab`` (the embedding lookup summed by one all-reduce, the
logits gathered).  Attention runs in one of three layouts
(``attention_layout``), each rank's query heads a contiguous slice so
that they stay within GQA groups:

* ``"split"``: both head counts divide the model axis; ``wq`` / ``wo``
  split on ``heads`` and ``wk`` / ``wv`` on ``kv_heads``;
* ``"grouped"``: the query heads divide the axis and the axis divides the
  kv heads' count (qwen3-moe's 64 over 4 or llama-3.2-vision's 64 over 8
  at 16): ``wq`` / ``bq`` / ``wo`` split on ``heads``, and ``wk`` / ``wv``
  / ``bk`` / ``bv`` stay whole on every rank, which slices its group's kv
  head inside the forward (``models.attention``) through ``copy_to_model``,
  so the whole leaf's gradient sums every rank's share; its pools hold
  that one kv head;
* ``"whole"``: every rank holds every head, where the query heads do not
  divide the axis (arctic's 56 or hymba's 25 at 16: the table's
  ``head_dim`` fallback, which GSPMD alone runs) or neither kv count
  divides the other (24 over 6 at 4).

Every other claim stays replicated:

* ``embed``, the table's TP fallback (norm scales, biases added after a
  sum, hymba's projections when its 25 heads do not divide): a
  contraction over a sharded embed dim needs a further all-reduce;
* ``head_dim`` (q/k norm scales, and the fallback of indivisible heads);
* ``expert_router`` (sharding the router would need a gather of the router
  logits before the top-k);
* ``ssm_inner`` and the SSM's ``heads`` (hymba's SSM heads: ``in_proj``
  packs x and z side by side, and ``x_proj`` contracts over the inner dim);
* ``heads_x_dim`` (rwkv6's mixes and the audio frame projection);
* every claim inside rwkv6's time mix (``WHOLE_OVER_MODEL``), whose
  ``bonus`` alone is indexed by ``heads``: the time mix runs whole on
  every model rank, so none of its head-indexed leaves splits (a split
  ``bonus`` beside whole r / k / v would hand the WKV scan half the
  heads' bonus).  Its channel mix splits ``mlp`` as an FFN does.

**Training** (``train.step``, sharded and FSDP) executes the same model
claims and, where the table's ``ParallelConfig`` has ``fsdp``, every claim
of ``"data"`` on an ``"embed"`` dim (``FSDP_AXES``): a rank stores 1 / d of
such a leaf, of its AdamW moments and of its compression residual, and the
forward gathers it inside the layer that uses it
(``parallel.collectives.gather_over_data``): the moe router and experts
(the experts' ``"embed"`` dim; their hidden dim ``expert_mlp`` stays whole,
since ``"expert"`` claims ``"model"`` first and the table gives
``expert_mlp`` no data axis under ``fsdp``), hymba's branch scales, the
audio frame projection and positions.  Every other leaf is replicated over
``"data"``: the token table and the head (their embed dim is ``embed_v``),
the q/k norm scales, hymba's SSM heads (``REPLICATED_SUBTREES``).  FSDP
takes the embed dims of rwkv6's time mix like any other's.

**Sequence parallelism** (``ParallelConfig.sequence_parallel``, training
and the sharded evals): the act rule of ``"seq"`` claims ``"model"`` after
the TP dims have claimed it, so inside attention and the FFN the heads
and ``mlp`` split, and between them the residual stream ``(batch, seq,
embed)`` splits on seq.  ``seq_split`` is the one decision: the executed
spec of that stream under ``act_rules``, which honours divisibility as
``spec_for`` does, so a sequence the model axis does not divide runs
unsplit, as plain tensor parallelism.

``executed_specs`` gives that layout beside the table's, and
``shard_params`` cuts each rank's slice of a full parameter tree by it.
``state_shardings`` is the layout of a whole train state (the moments and
the residual inherit the parameters' specs; the step and the fp8 state are
replicated), ``shard_state`` cuts a rank's slices out of a full state and
``unshard_state`` gathers them back, bit for bit.
The paged K/V pools shard on ``kv_heads`` only (``paged_cache_axes``): every
rank holds its head slice of every physical block (``local_kv_heads``: its
group's one head under ``"grouped"``), so block ids, tables, the
allocator and the prefix index are the same on every rank.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.distributed as dist

from repro_torch.config import MeshConfig, ParallelConfig
from repro_torch.utils.tree import tree_leaves, tree_map, tree_paths

Candidate = tuple[str, ...]  # one candidate = tuple of mesh axes used together
MODEL = "model"
DATA = "data"

# the logical axes whose claim of the model axis the port executes
EXECUTED_AXES = ("heads", "kv_heads", "mlp", "vocab", "expert")
# parameter subtrees whose claims all stay replicated (hymba's SSM heads)
REPLICATED_SUBTREES = ("ssm",)
# parameter subtrees that run whole on every model rank, but whose embed dims
# FSDP still takes (rwkv6's time mix)
WHOLE_OVER_MODEL = ("time_mix",)
# the logical axes whose claim of the data axis the port executes (FSDP)
FSDP_AXES = ("embed",)


def axis_sizes(mesh) -> dict:
    """{mesh axis name: size} of a ``DeviceMesh`` or of a stub whose
    ``.shape`` is that dict."""
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:
        return dict(zip(names, tuple(mesh.shape)))
    return dict(mesh.shape)


def _axis_size(mesh, cand: Candidate) -> int:
    sizes = axis_sizes(mesh)
    n = 1
    for a in cand:
        n *= sizes[a]
    return n


def model_axis_size(mesh) -> int:
    """Size of the tensor-parallel ("model") axis; 1 when there is no mesh."""
    if mesh is None:
        return 1
    return int(axis_sizes(mesh).get(MODEL, 1))


def attention_layout(mesh, num_q_heads: int, num_kv_heads: int) -> tuple[str, int]:
    """(layout, kv heads a rank holds) of attention over ``mesh``'s model
    axis of ``tp`` ranks (module docstring):

    * ``"split"``: both head counts divide the axis (or ``tp`` is 1): each
      rank holds ``Hq / tp`` query heads and their ``KV / tp`` kv heads;
    * ``"grouped"``: the query heads divide the axis and the axis divides
      the kv heads' count: rank r holds query heads ``[r Hq / tp, (r + 1)
      Hq / tp)``, all of one GQA group, and attends over that group's one
      kv head, ``r // (tp / KV)`` (``kv_group``);
    * ``"whole"``: every rank holds every head (the query heads do not
      divide the axis, or neither kv count divides the other)."""
    tp = model_axis_size(mesh)
    if tp <= 1 or (num_q_heads % tp == 0 and num_kv_heads % tp == 0):
        return "split", num_kv_heads // max(tp, 1)
    if num_q_heads % tp == 0 and tp % num_kv_heads == 0:
        return "grouped", 1
    return "whole", num_kv_heads


def local_kv_heads(cfg, mesh) -> int:
    """The kv heads of one rank's pools under ``mesh``."""
    if not cfg.has_attention:
        return cfg.num_kv_heads
    return attention_layout(mesh, cfg.num_heads, cfg.num_kv_heads)[1]


def kv_group(cfg, mesh) -> int:
    """The kv head this rank attends over under the ``"grouped"`` layout."""
    return model_rank(mesh) // (model_axis_size(mesh) // cfg.num_kv_heads)


def kv_seq_shards(cfg, mesh, window: int) -> int:
    """Over how many model ranks a dense ring of ``window`` slots splits
    its slots: the model axis where the cfg attends, its kv heads do not
    divide the axis and the axis divides the ring, as the JAX package's
    cache rules then claim ``kv_seq`` (whatever the query heads do); else
    1.  A split ring holds every kv head on every rank."""
    tp = model_axis_size(mesh)
    if tp > 1 and cfg.has_attention and cfg.num_kv_heads % tp != 0 and window % tp == 0:
        return tp
    return 1


def paged_cache_axes(cfg, *, quantized: bool | str = False) -> dict:
    """Logical axes of the port's stacked paged cache, as the JAX package's
    ``paged_cache_axes``: the pools (and their scale leaves) shard along
    ``kv_heads``; the block table (one for every layer here, one per layer
    there) and the hybrid family's recurrent states are replicated."""
    from repro_torch.models.cache import supports_paged

    if not supports_paged(cfg):
        raise ValueError(f"no paged cache for family {cfg.family!r} ({cfg.name})")
    pool = ("layers", None, None, "kv_heads", None)
    ax = {"k": pool, "v": pool, "tbl": (None, None)}
    if quantized:
        ax["k_scale"] = pool
        ax["v_scale"] = pool
    if cfg.family == "hybrid":
        ax["conv"] = ("layers", None, None, None)
        ax["ssm"] = ("layers", None, None, None, None)
    return ax


@dataclass(frozen=True)
class ShardingRules:
    mesh_cfg: MeshConfig
    parallel: ParallelConfig

    # ------------------------------------------------------------------
    def _data_axes(self) -> Candidate:
        return tuple(self.mesh_cfg.data_axes)

    def param_rules(self) -> dict[str, tuple[Candidate, ...]]:
        fsdp: tuple[Candidate, ...] = ((self._data_axes(),) if self.parallel.fsdp else ())
        tp: tuple[Candidate, ...] = (((MODEL,),) if self.parallel.tensor_parallel else ())
        # dict order = priority, as in the JAX package: the expert dim claims
        # "model" first, then vocab tables, heads and the FFN hidden dim;
        # "embed" takes the FSDP axes, with "model" as its fallback
        return {
            "expert": tp,
            "vocab": tp,
            "heads": tp,
            "kv_heads": tp,
            "mlp": tp,
            # the expert FFN hidden dim falls back to the data axes in decode
            # (fsdp off), as in the JAX package
            "expert_mlp": tp + (() if self.parallel.fsdp else (self._data_axes(),)),
            "heads_x_dim": tp,
            "ssm_inner": tp,
            "embed": fsdp + tp,
            "embed_v": (),  # embed dim of vocab tables: never sharded
            "expert_router": tp,
            "head_dim": tp,
            "layers": (),
            "layers_inner": (),
        }

    def act_rules(self) -> dict[str, tuple[Candidate, ...]]:
        batch: tuple[Candidate, ...] = (self._data_axes(),)
        tp: tuple[Candidate, ...] = (((MODEL,),) if self.parallel.tensor_parallel else ())
        seq: tuple[Candidate, ...] = (((MODEL,),) if self.parallel.sequence_parallel else ())
        return {
            "batch": batch,
            "kv_batch": batch,
            "heads": tp,
            "kv_heads": tp,
            "mlp": tp,
            "expert_mlp": tp,
            "expert": tp,
            "vocab": tp,
            "ssm_inner": tp,
            "heads_x_dim": tp,
            "seq": seq,
            "kv_seq": (),  # claimed through the fallback of the cache rules
            "embed": (),
            "layers": (),
            "layers_inner": (),
        }

    def cache_rules(self) -> dict[str, tuple[Candidate, ...]]:
        """K/V caches: heads first, then the sequence (split-KV) fallback
        when the head count does not divide; ``kv_seq`` goes last, so
        ``kv_heads`` claims the model axis first."""
        rules = dict(self.act_rules())
        rules.pop("kv_seq", None)
        rules["kv_seq"] = ((MODEL,),)
        return rules

    # ------------------------------------------------------------------
    def spec_for(self, axes: tuple, dims: tuple, mesh, rules: dict) -> tuple:
        """Greedy one-tensor assignment honouring divisibility; priority is
        the logical axis's position in the rule table."""
        used: set[str] = set()
        assign: list = [None] * len(axes)
        rule_order = {name: i for i, name in enumerate(rules)}
        order = sorted(
            range(len(axes)),
            key=lambda i: (len(rules.get(axes[i], ())) == 0, rule_order.get(axes[i], len(rule_order))),
        )
        for i in order:
            ax = axes[i]
            if ax is None:
                continue
            for cand in rules.get(ax, ()):
                if any(a in used for a in cand):
                    continue
                if dims[i] % _axis_size(mesh, cand) != 0:
                    continue
                assign[i] = cand if len(cand) > 1 else cand[0]
                used.update(cand)
                break
        return tuple(assign)

    def tree_specs(self, axes_tree, shape_tree, mesh, rules: dict):
        """Spec tree for a (logical-axes tree, tree of leaves with ``.shape``)."""

        def one(axes, leaf):
            dims = tuple(leaf.shape)
            if len(axes) != len(dims):
                raise ValueError(f"axes {axes} vs shape {dims}")
            return self.spec_for(axes, dims, mesh, rules)

        return tree_map(one, axes_tree, shape_tree)  # an axes tuple is a leaf

    # ------------------------------------------------------------------
    def param_shardings(self, model_cfg, mesh):
        """The table's spec of every parameter of ``model_cfg`` (the
        port's per-layer tree: a block's spec is the JAX package's stacked
        spec without its leading ``"layers"`` entry)."""
        from repro_torch.models import param_specs

        specs = param_specs(model_cfg)
        return tree_map(lambda s: self.spec_for(s.axes, s.shape, mesh, self.param_rules()), specs)

    def paged_cache_shardings(self, model_cfg, mesh, cache: dict) -> dict:
        """The spec of every leaf of a paged cache: pools on the kv-head
        axis (replicated when the head count does not divide), the table
        and the hybrid recurrent states replicated."""
        axes = paged_cache_axes(model_cfg, quantized="k_scale" in cache)
        return self.tree_specs(axes, {k: cache[k] for k in axes}, mesh, self.cache_rules())

    def logits_sharding(self, model_cfg, mesh, ndim: int = 2) -> tuple:
        """Vocab-sharded logits (other dims replicated); replicated when the
        padded vocab does not divide the model axis."""
        return self.spec_for(
            (None,) * (ndim - 1) + ("vocab",), (1,) * (ndim - 1) + (model_cfg.padded_vocab,), mesh, self.act_rules()
        )



def seq_split(mesh, shape: tuple, sequence_parallel: bool) -> bool:
    """Whether the residual stream of the global ``shape`` (batch, seq,
    embed) splits its seq dim over ``mesh``'s model axis: the executed
    spec of ``("batch", "seq", "embed")`` under the act rules of a table
    with ``sequence_parallel`` (module docstring).  False without a mesh
    or on a model axis of 1."""
    if mesh is None or model_axis_size(mesh) == 1 or not sequence_parallel:
        return False
    rules = training_rules(ParallelConfig(sequence_parallel=True))
    return rules.spec_for(("batch", "seq", "embed"), tuple(shape), mesh, rules.act_rules())[1] == MODEL


def make_rules(mesh_cfg: MeshConfig, parallel: ParallelConfig | None = None) -> ShardingRules:
    return ShardingRules(mesh_cfg, parallel or ParallelConfig())


def serving_rules(parallel: ParallelConfig | None = None) -> ShardingRules:
    """The serving engine's table: tensor parallelism, no FSDP (decode wants
    its weights stationary), as the JAX engine's default."""
    return make_rules(MeshConfig(), parallel or ParallelConfig(fsdp=False, tensor_parallel=True))


# ---------------------------------------------------------------------------
# the executed layout
# ---------------------------------------------------------------------------


def _executed(cfg, mesh, path: tuple, axes: tuple, spec: tuple) -> tuple:
    layout = attention_layout(mesh, cfg.num_heads, cfg.num_kv_heads)[0]
    replicated_here = any(p in REPLICATED_SUBTREES for p in path)
    whole_here = replicated_here or any(p in WHOLE_OVER_MODEL for p in path)
    out = []
    for ax, entry in zip(axes, spec):
        names = () if entry is None else (entry if isinstance(entry, tuple) else (entry,))
        if MODEL not in names:
            # FSDP: the data claim of an embed dim (the serving table has none)
            out.append(DATA if names == (DATA,) and ax in FSDP_AXES and not replicated_here else None)
        elif (whole_here or ax not in EXECUTED_AXES or (ax == "heads" and layout == "whole")
              or (ax == "kv_heads" and layout != "split")):
            out.append(None)
        else:
            out.append(MODEL)
    return tuple(out)


def executed_specs(cfg, mesh, rules: ShardingRules | None = None) -> dict:
    """``{"table": specs, "executed": specs}``: the rule table's spec of
    every parameter and the layout the port runs (module docstring), as
    trees shaped like the parameters.  An executed entry is ``"model"``,
    ``"data"`` (FSDP, under a table with ``fsdp``) or ``None``.  The
    default table is the serving one (``serving_rules``)."""
    from repro_torch.models import param_specs

    rules = rules or serving_rules()
    pspecs = param_specs(cfg)
    table = rules.param_shardings(cfg, mesh)
    paths = tree_paths(pspecs)
    axes = [s.axes for s in tree_leaves(pspecs)]
    done = iter(_executed(cfg, mesh, p, a, t) for p, a, t in zip(paths, axes, tree_leaves(table)))
    return {"table": table, "executed": tree_map(lambda _: next(done), pspecs)}


def replicated_claims(cfg, mesh, rules: ShardingRules | None = None) -> dict:
    """``{path: (table spec, executed spec)}`` of every parameter whose
    table spec claims the model axis where the port keeps it replicated."""
    specs = executed_specs(cfg, mesh, rules)
    paths = tree_paths(specs["table"])
    out = {}
    for path, t, e in zip(paths, tree_leaves(specs["table"]), tree_leaves(specs["executed"])):
        claims = [MODEL in ((x,) if isinstance(x, str) else (x or ())) for x in t]
        if claims != [x == MODEL for x in e]:
            out["/".join(map(str, path))] = (t, e)
    return out


def model_rank(mesh) -> int:
    """This process's coordinate on the model axis (0 without a mesh)."""
    if mesh is None or model_axis_size(mesh) == 1:
        return 0
    return mesh.get_local_rank(MODEL)


def data_axis(mesh) -> tuple[int, int]:
    """(ranks on the data axis, this process's coordinate there): (1, 0)
    without a mesh or on a serving mesh."""
    n = int(axis_sizes(mesh).get(DATA, 1)) if mesh is not None else 1
    return (n, mesh.get_local_rank(DATA)) if n > 1 else (1, 0)


def _coords(mesh, spec: tuple) -> list:
    """(dim, ranks, this rank) of every dim of ``spec`` sharded over an
    axis of more than one rank."""
    sizes = axis_sizes(mesh)
    return [(dim, sizes[e], mesh.get_local_rank(e)) for dim, e in enumerate(spec)
            if e in (DATA, MODEL) and sizes.get(e, 1) > 1]


def local_shape(shape: tuple, spec: tuple, mesh) -> tuple:
    """A leaf's shape on one rank under its executed ``spec``."""
    shape = list(shape)
    for dim, n, _ in _coords(mesh, spec):
        shape[dim] //= n
    return tuple(shape)


def shard_tensor(t: torch.Tensor, spec: tuple, mesh) -> torch.Tensor:
    """This rank's slice of a full tensor under an executed spec, as a new
    contiguous tensor (so the full one can be freed)."""
    for dim, n, rank in _coords(mesh, spec):
        if t.shape[dim] % n:
            raise ValueError(f"dim {dim} of shape {tuple(t.shape)} does not divide over {n} ranks")
        t = t.narrow(dim, rank * (t.shape[dim] // n), t.shape[dim] // n)
    return t.clone(memory_format=torch.contiguous_format)


def shard_params(cfg, params, specs, mesh) -> dict:
    """Cut this rank's local slice out of the full parameter tree
    ``params`` by the executed ``specs`` (``executed_specs(cfg,
    mesh)["executed"]``).  A replicated leaf comes back as it is, and so
    does a leaf that already holds this rank's slice (its sharded dims
    1 / n of ``cfg``'s); any other shape raises."""
    from repro_torch.models import param_specs

    def one(t, spec, ps):
        full = tuple(ps.shape)
        local = local_shape(full, spec, mesh)
        if tuple(t.shape) == local:
            return t
        if tuple(t.shape) != full:
            raise ValueError(f"parameter of shape {tuple(t.shape)}: neither the full {full} nor the local {local}")
        return shard_tensor(t, spec, mesh)

    return tree_map(one, params, specs, param_specs(cfg))


# ---------------------------------------------------------------------------
# train states over a (data, model) mesh
# ---------------------------------------------------------------------------


def training_rules(parallel: ParallelConfig) -> ShardingRules:
    """The training table of a run's ``ParallelConfig`` on a ``("data",
    "model")`` mesh (one pod: the data axes are ``("data",)``)."""
    return make_rules(MeshConfig(), parallel)


def state_shardings(cfg, run_cfg, rules: ShardingRules, mesh):
    """The executed spec of every leaf of a train state of ``run_cfg``,
    shaped like one (a ``TrainState`` whose leaves are specs): params by
    the executed layout, ``m``, ``v`` and the residual inheriting their
    specs, the step and every fp8 leaf replicated (``()``), as the JAX
    package's ``state_shardings``."""
    from repro_torch.fp8 import Fp8State, scale_keys
    from repro_torch.optim import AdamWState
    from repro_torch.train.step import TrainState, _fp8_enabled

    specs = executed_specs(cfg, mesh, rules)["executed"]
    fp8 = None
    if _fp8_enabled(cfg, run_cfg.precision):
        keys = scale_keys(cfg)
        fp8 = Fp8State(amax_history={k: () for k in keys}, scale={k: () for k in keys}, step=())
    residual = specs if run_cfg.parallel.grad_compression != "none" else None
    return TrainState(params=specs, opt=AdamWState(step=(), m=specs, v=specs), compress_residual=residual, fp8=fp8)


def _state_map(fn, state, specs):
    """``fn(leaf, spec)`` over the params, moments and residual of a train
    state; the step and the fp8 state are replicated and cloned."""
    fp8 = state.fp8
    if fp8 is not None:
        fp8 = type(fp8)(amax_history=tree_map(torch.clone, fp8.amax_history), scale=tree_map(torch.clone, fp8.scale),
                        step=fp8.step.clone())
    each = lambda tree, sp: None if tree is None else tree_map(fn, tree, sp)  # noqa: E731
    return state._replace(
        params=each(state.params, specs.params),
        opt=state.opt._replace(step=state.opt.step.clone(), m=each(state.opt.m, specs.opt.m),
                               v=each(state.opt.v, specs.opt.v)),
        compress_residual=each(state.compress_residual, specs.compress_residual),
        fp8=fp8,
    )


def shard_state(state, specs, mesh):
    """This rank's train state: the slices of the full ``state`` by
    ``specs`` (``state_shardings``), each a new contiguous tensor."""
    return _state_map(lambda t, spec: shard_tensor(t, spec, mesh), state, specs)


def unshard_tensor(t: torch.Tensor, spec: tuple, mesh) -> torch.Tensor:
    """The full tensor from every rank's slice under ``spec``: one
    all-gather over each sharded axis, in rank order (data motion only);
    a new contiguous tensor either way."""
    coords = _coords(mesh, spec)
    if not coords:
        return t.clone(memory_format=torch.contiguous_format)
    for dim, n, _ in coords:
        group = mesh.get_group(spec[dim])
        t = t.contiguous()
        parts = [torch.empty_like(t) for _ in range(n)]
        dist.all_gather(parts, t, group=group)
        t = torch.cat(parts, dim=dim)  # new and contiguous
    return t


def unshard_state(state, specs, mesh):
    """The full train state on every rank of ``mesh`` from each rank's
    ``state`` (``shard_state``'s inverse, bit for bit)."""
    return _state_map(lambda t, spec: unshard_tensor(t, spec, mesh), state, specs)


def replicated_leaves(specs, mesh) -> list[str]:
    """The paths of the leaves that every rank of ``mesh`` holds whole
    under ``specs`` (a params-shaped tree of executed specs): no dim
    sharded over an axis of more than one rank."""
    return ["/".join(map(str, p)) for p, s in zip(tree_paths(specs), tree_leaves(specs)) if not _coords(mesh, s)]
