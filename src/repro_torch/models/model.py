"""The model: embedding -> layer loop -> head.

Entry points, counterparts of the JAX package's ``models/model.py``:

* ``forward``      — training forward over whole sequences: (logits, aux),
  or (logits, aux, amaxes) with an FP8 context; every family: dense, moe
  (whose aux is the load-balance loss), ssm (RWKV6), hybrid (hymba), audio
  (hubert, over frame embeddings) and vlm (llama-3.2-vision)
* ``prefill``      — a whole (right-padded) prompt: (logits at each
  sequence's last real token, the raw cache stacked over layers: K/V, and
  the recurrent states of the hybrid and ssm families), which
  ``serving.kvcache`` turns into a dense slot cache or grafts into paged
  blocks
* ``prefill_step`` — one prompt chunk against the paged cache: (logits at
  the chunk's last token, cache)
* ``verify_step``  — C candidate tokens against the paged cache: (logits at
  every lane, cache), the speculative-decoding verify pass
* ``decode_step``  — one token per batch slot against the paged cache or
  the dense slot cache: (logits, cache)
* ``unified_step`` — one fused pass over a mixed (rows, width) batch of
  decode rows and prefill chunks: (all-lane logits, cache)

The serving steps serve the dense, moe, hybrid, ssm and vlm families
(``SERVED_FAMILIES``): each layer is a dense block, an MoE block
(``models.moe``, the routed experts in place of the FFN), a hybrid block
(attention and SSM heads side by side, ``models.ssm``) or an RWKV6 block;
the vlm family runs layer groups of ``cross_attn_every - 1`` dense blocks
and a cross block that attends the image tokens (``batch["vision_tokens"]``,
(B, N, D)).  The hybrid, ssm and vlm families have ``prefill`` and
``decode_step`` only, on the dense slot cache or (hybrid) blocking
admission into the paged one: the chunked steps refuse them, as in the
JAX package.  The paged steps do no host work
(no ``.item()``, no host-to-device copy, no shape that depends on the
data), so ``serving/graphs.py`` can capture them in CUDA graphs.

Tensor-parallel serving: every serving entry point takes ``mesh``, the
``(data=1, model=tp)`` mesh of ``launch.mesh.make_serving_mesh``, with
this rank's slice of the parameters (``parallel.sharding.shard_params``)
and of the K/V pools.  Activations are replicated on every rank.  The
blocks sum their row-parallel products over the model axis; the
embedding is vocab-parallel (each rank looks up the tokens in its vocab
range, zeros elsewhere, and one all-reduce sums them: exact) and so are
the logits (each rank's vocab slice, masked by global column, then one
all-gather to the full padded vocab).  Attention runs in the layout
``parallel.sharding.attention_layout`` picks: a rank's query heads with
their kv heads, or with its GQA group's one kv head where the model axis
divides the kv heads' count (``models.attention``), or every head on every
rank where the query heads do not divide the axis.

Sharded and FSDP training: ``forward(mesh=)`` takes the ``(data, model)``
mesh of ``launch.mesh.make_local_mesh`` and this rank's slices of the
parameters (``parallel.sharding.shard_state``), for every family of
``FORWARD_FAMILIES`` (the moe layers' expert and
data-spanning routing: ``models.moe``; the audio family's frame
projection and positions gathered before the embedding; the ssm
family's time mix whole on every model rank, its channel mix split as an
FFN: ``models.rwkv``; each vlm self and cross layer gathered by its own
spec of the group, ``specs["blocks"][g]["self"][i]`` and
``["cross"]``).  The
model slices run as in serving, under autograd (``copy_to_model`` before
each column-parallel product, ``sum_over_model`` after each row-parallel
one, both in ``parallel.collectives``); each leaf sharded over ``"data"``
(FSDP) is gathered inside the block that uses it (``fsdp_gather``), after
its cast to the compute dtype, so bf16 crosses the wire and no gathered
copy of the whole tree exists; under ``remat="full"`` the gather is
recomputed in the backward, as ZeRO-3 does.  The logits stay local: the
train step's cross-entropy is vocab-parallel.

Sequence parallelism (``forward(sequence_parallel=True)`` with a mesh
whose model axis divides the sequence: ``parallel.sharding.seq_split``):
the residual stream between the blocks is each model rank's contiguous
slice of the sequence, ``(B, S / tp, D)``, as the JAX package's rule
engine lays out ``("batch", "seq", "embed")``.  The vocab-parallel
embedding's sum becomes ``reduce_scatter_seq``, a replicated table's
lookup (the audio frames' projection and positions, learned positions)
is cut by ``scatter_seq``; each block gathers its sublayers' inputs and
reduce-scatters their outputs (``models.blocks``); the head normalises the
slice, gathers the sequence (the JAX package's ``"seq_unsharded"`` before
the head) and projects it vocab-parallel, so the cross-entropy sees whole
rows (a replicated head projects the ``whole()`` view).  RoPE takes the
whole sequence's positions after the gathers.

The layer loop is a Python loop over per-layer parameter dicts.  The cache
is updated in place and returned for symmetry with the JAX functions, which
return a new one.
"""

from __future__ import annotations

import math
from functools import partial

import torch
from torch.utils.checkpoint import checkpoint, create_selective_checkpoint_contexts

from repro_torch.models.attention import ATTN_IMPLS, SELF_ATTN_IMPLS
from repro_torch.models.blocks import (
    cross_block,
    cross_block_decode,
    cross_block_prefill,
    dense_block,
    dense_block_chunk,
    dense_block_decode,
    dense_block_prefill,
    hybrid_block,
    hybrid_block_decode,
    hybrid_block_prefill,
    moe_block,
    moe_block_chunk,
    moe_block_decode,
    moe_block_prefill,
    rwkv_block,
    rwkv_block_decode,
    rwkv_block_prefill,
)
from repro_torch.models.cache import SERVED_FAMILIES, layer_cache
from repro_torch.models.layers import apply_norm
from repro_torch.models.rwkv import check_wkv_impl
from repro_torch.models.initializers import param_specs
from repro_torch.parallel.collectives import (
    SeqGather,
    all_gather,
    copy_to_model,
    gather_over_data,
    gather_seq,
    reduce_scatter_seq,
    scatter_seq,
    sum_over_model,
)
from repro_torch.parallel.sharding import FSDP_AXES, data_axis, model_axis_size, model_rank, seq_split


def _check_impl(cfg, attn_impl: str) -> None:
    if attn_impl not in ATTN_IMPLS:
        raise ValueError(f"attn_impl={attn_impl!r} (choose from {ATTN_IMPLS})")
    _check_served(cfg)


def _check_served(cfg) -> None:
    if cfg.family not in SERVED_FAMILIES:
        raise NotImplementedError(f"family {cfg.family!r} ({cfg.name}) is not ported yet")


def _serving_block(cfg, dense, moe):
    """The family's block function of one chunked serving step."""
    return dense if cfg.family == "dense" else moe


# the blocks of the whole-prompt prefill and of the decode step, by family
PREFILL_BLOCKS = {"dense": dense_block_prefill, "moe": moe_block_prefill, "hybrid": hybrid_block_prefill}
DECODE_BLOCKS = {"dense": dense_block_decode, "moe": moe_block_decode, "hybrid": hybrid_block_decode}
# the state leaves a decode step returns in the dtype it computes them in
STEP_DTYPE_LEAVES = ("conv", "tm_x", "cm_x")


def embed_input(cfg, params, tokens: torch.Tensor, positions: torch.Tensor, mesh=None, sp=False) -> torch.Tensor:
    """(B, S) tokens at (B, S) positions -> (B, S, D) embeddings.  For the
    audio family ``tokens`` holds the frames, (B, S, D): ``frames @
    frame_proj`` plus the learned ``pos[:S]``, whatever ``positions`` says,
    as in the JAX package.  Under a ``mesh`` whose ranks each hold a vocab
    slice of the table, the lookup is vocab-parallel (module docstring).
    ``sp``: this rank's seq slice, (B, S / tp, D): the vocab-parallel sum
    reduce-scattered, a replicated table's rows cut by ``scatter_seq``."""
    e = params["embed"]
    if cfg.family == "audio":
        x = tokens @ e["frame_proj"].to(tokens.dtype)
        x = x + e["pos"][: x.shape[1]].to(x.dtype)
        return scatter_seq(x, mesh) if sp else x
    tok = e["tok"]
    if mesh is not None and tok.shape[0] != cfg.padded_vocab:
        local = tokens.long() - model_rank(mesh) * tok.shape[0]
        mine = (local >= 0) & (local < tok.shape[0])
        x = tok[local.clamp(0, tok.shape[0] - 1)]
        x = torch.where(mine[..., None], x, torch.zeros((), dtype=x.dtype, device=x.device))
        x = reduce_scatter_seq(x, mesh) if sp else sum_over_model(x, mesh)
    else:
        x = tok[tokens.long()]
        if sp:
            x = scatter_seq(x, mesh)
    if cfg.learned_pos_embedding:
        pos = e["pos"][positions.long()]
        x = x + (scatter_seq(pos, mesh) if sp else pos).to(x.dtype)
    if cfg.scale_embedding:
        # the scale rounded to x's dtype on the host: a Python float, so no
        # host-to-device copy (which a CUDA graph capture refuses)
        x = x * float(torch.tensor(math.sqrt(cfg.d_model), dtype=x.dtype))
    return x


def lm_logits(cfg, params, x: torch.Tensor, mesh=None, *, gather: bool = True, sp: bool = False) -> torch.Tensor:
    """Final norm + output projection (tied or untied; padded-vocab mask).
    Under a ``mesh`` whose ranks each hold a vocab slice of the projection
    (``lm_head`` or the tied table), each rank computes its slice of the
    logits, masks it by global column, and one all-gather joins them;
    ``gather=False`` (training) returns the rank's slice.  ``sp``: x is
    this rank's seq slice; the norm runs on it (its scale and bias through
    ``copy_to_model``), then the whole sequence is gathered, so the logits
    cover every position (a replicated head, computed whole on every rank,
    reads the gather's ``whole()`` view)."""
    x = apply_norm(cfg, params["final_norm"], x, seq_mesh=mesh if sp else None)
    if mesh is not None:
        head = params["lm_head"].shape[-1] if "lm_head" in params else params["embed"]["tok"].shape[0]
        if sp:
            x = gather_seq(x, mesh) if head != cfg.padded_vocab else SeqGather(x, mesh).whole()
        elif head != cfg.padded_vocab:
            x = copy_to_model(x, mesh)
    if "lm_head" in params:
        logits = x @ params["lm_head"].to(x.dtype)
    else:
        logits = x @ params["embed"]["tok"].to(x.dtype).T
    logits = logits.float()
    split = mesh is not None and logits.shape[-1] != cfg.padded_vocab
    if cfg.padded_vocab != cfg.vocab_size:
        # mask the alignment-padding columns (never predicted); out of place,
        # so the product's gradient is kept.  The columns are global ones: a
        # rank's slice starts at rank * its width
        first = model_rank(mesh) * logits.shape[-1] if split else 0
        col = first + torch.arange(logits.shape[-1], device=logits.device)
        logits = logits.masked_fill(col >= cfg.vocab_size, -1e9)
    if split and gather:
        logits = all_gather(logits, mesh, dim=-1)
    return logits


# activation-checkpoint policies of the JAX package's layer scan: keep every
# activation ("none"), recompute a whole block in the backward ("full"), or
# recompute it but keep the outputs of its matrix products ("dots": mm,
# addmm and bmm; "dots_no_batch": only the products with no batch dimension,
# mm and addmm), as ``checkpoint_dots`` and
# ``checkpoint_dots_with_no_batch_dims`` keep the outputs of ``dot_general``.
# K4's output is written by a ctypes launch that the dispatcher does not
# see, so the policies cannot keep it: it is recomputed, as the JAX
# package's Pallas FP8 GEMM, whose output is no ``dot_general``, is under
# its policies.
REMAT_POLICIES = ("none", "full", "dots", "dots_no_batch")
_aten = torch.ops.aten
SAVED_PRODUCTS = {
    "dots": [_aten.mm.default, _aten.addmm.default, _aten.bmm.default],
    "dots_no_batch": [_aten.mm.default, _aten.addmm.default],
}

FORWARD_FAMILIES = ("dense", "moe", "ssm", "hybrid", "audio", "vlm")
# leaves their block uses in the compute dtype (cast before FSDP gathers
# them), and the projections, which an fp8 site quantizes from the master
PROJECTIONS = ("wq", "wk", "wv", "wo", "w_up", "w_gate", "w_down")
# (rwkv6's projections: its mixes' w_r / w_k / w_v / w_g / w_o)
COMPUTE_DTYPE_LEAVES = PROJECTIONS + ("bq", "bk", "bv", "bo", "b_up", "b_down", "w_r", "w_k", "w_v", "w_g", "w_o")
# the training block of each family that runs one per layer (vlm: layer
# groups of dense and cross blocks); the moe block also returns its
# load-balance loss
TRAIN_BLOCKS = {"dense": dense_block, "audio": dense_block, "moe": moe_block, "hybrid": hybrid_block, "ssm": rwkv_block}


def _stack_caches(caches: list) -> dict:
    """Per-layer cache dicts (nested alike) -> one dict, each leaf stacked
    on a new leading axis, as the JAX layer scan stacks its outputs."""
    return {
        name: _stack_caches([c[name] for c in caches]) if isinstance(v, dict) else torch.stack([c[name] for c in caches])
        for name, v in caches[0].items()
    }


def fsdp_gather(tree: dict, specs: dict, mesh, compute_dtype=None, fp8: bool = False) -> dict:
    """``tree`` (a layer's parameters, or any subtree) with each leaf that
    FSDP shards (an ``"embed"`` dim smaller than its ``ParamSpec``'s)
    gathered over the data axis.  A leaf its block uses in the compute
    dtype (``COMPUTE_DTYPE_LEAVES``) is cast first, but for the projections
    of an fp8 layer, which quantize the fp32 master (a moe layer's experts
    too, which cast after the gather); the norm scales, the router and
    hymba's branch scales stay in the parameters' dtype, as their blocks
    read them.  The gather's backward reduce-scatters the gradient
    (``gather_over_data``)."""

    def one(name, t, spec):
        if isinstance(t, dict):
            return {k: one(k, v, spec[k]) for k, v in t.items()}
        dims = [i for i, (a, n) in enumerate(zip(spec.axes, spec.shape)) if a in FSDP_AXES and t.shape[i] != n]
        if not dims:
            return t
        if compute_dtype is not None and name in COMPUTE_DTYPE_LEAVES and not (fp8 and name in PROJECTIONS):
            t = t.to(compute_dtype)
        for i in dims:
            t = gather_over_data(t, mesh, i)
        return t

    return {k: one(k, v, specs[k]) for k, v in tree.items()}


def forward(
    cfg, params, batch, *, q_chunk=0, remat="none", attn_impl="torch", wkv_impl="chunked", compute_dtype=None, fp8=None,
    mesh=None, sequence_parallel=False,
):
    """Training forward.  Returns (logits, aux_loss), or (logits, aux_loss,
    amaxes) when an ``fp8`` context (``repro_torch.fp8.Fp8Ctx``) is passed:
    amaxes maps each scale key to the (num_layers,) amaxes observed.
    aux_loss is the moe layers' load-balance losses summed and divided by
    ``cfg.num_layers``, as in the JAX package, and 0 for the other
    families.  The ssm and vlm families take no fp8 context (ValueError, as
    in the JAX package).

    batch: ``tokens`` (B, S) int and optional ``positions`` (B, S); the
    audio family reads ``frames`` (B, S, D) in place of ``tokens``; the vlm
    family also reads ``vision_tokens`` (B, N, D), cast to
    ``compute_dtype`` with the activations.
    ``compute_dtype`` casts the activation stream, not the master weights:
    each weight use casts its own tensor (FP8 sites quantize the fp32
    master weight directly).  ``remat`` (``REMAT_POLICIES``): ``"full"``
    recomputes each block (each self and each cross layer of a vlm group)
    in the backward (``torch.utils.checkpoint``, non-reentrant); ``"dots"``
    and ``"dots_no_batch"`` recompute it but keep its products' outputs
    (``SAVED_PRODUCTS``).  ``attn_impl`` (every self-attention layer; the
    vlm cross layers attend in tensor ops): ``"torch"`` (differentiable) or
    ``"flash"`` (K3, forward only).  ``wkv_impl`` (ssm): ``"chunked"``
    (differentiable) or ``"kernel"`` (K5, forward only, from a zero state;
    the forward drops the final state), or a scan called in K5's place
    (``models.rwkv.check_wkv_impl``).  ``mesh``: sharded training's
    ``(data, model)`` mesh, with this rank's parameter slices and batch
    rows (module docstring); the logits are then this rank's vocab slice.
    ``sequence_parallel`` (``ParallelConfig.sequence_parallel``): under a
    ``mesh``, the residual stream splits over seq where
    ``parallel.sharding.seq_split`` says so (module docstring); the
    logits still cover the whole sequence.
    """
    if cfg.family not in FORWARD_FAMILIES:
        raise NotImplementedError(f"family {cfg.family!r} ({cfg.name}) is not ported yet")
    if fp8 is not None and cfg.family in ("ssm", "vlm"):
        # the reference's ssm family has no quantizable projections and its
        # vlm family scans layer groups (its amax drain is not wired there)
        raise ValueError(f"fp8 training is not supported for family={cfg.family}")
    if attn_impl not in SELF_ATTN_IMPLS:
        raise ValueError(f"attn_impl={attn_impl!r} (choose from {SELF_ATTN_IMPLS})")
    check_wkv_impl(wkv_impl)
    if remat not in REMAT_POLICIES:
        raise ValueError(f"remat={remat!r} (choose from {REMAT_POLICIES})")
    inputs = batch["frames"] if cfg.family == "audio" else batch["tokens"]
    positions = batch.get("positions")
    if positions is None:
        positions = torch.arange(inputs.shape[1], device=inputs.device).expand(inputs.shape[:2])
    specs = param_specs(cfg) if mesh is not None else None
    embed_params = params
    if mesh is not None and cfg.family == "audio":
        # FSDP shards the frame projection's and the positions' embed dim:
        # gathered here, the positions cut to the S they add first
        e = params["embed"]
        embed_params = dict(params, embed=fsdp_gather({"frame_proj": e["frame_proj"], "pos": e["pos"][: inputs.shape[1]]},
                                                      specs["embed"], mesh))
    sp = seq_split(mesh, (inputs.shape[0] * data_axis(mesh)[0], inputs.shape[1], cfg.d_model), sequence_parallel)
    x = embed_input(cfg, embed_params, inputs, positions, mesh, sp)
    if compute_dtype is not None:
        x = x.to(compute_dtype)
    vision = batch.get("vision_tokens")
    if vision is not None and compute_dtype is not None:
        vision = vision.to(compute_dtype)

    def run(block, x):
        if remat == "none" or not torch.is_grad_enabled():
            return block(x)
        if remat == "full":
            return checkpoint(block, x, use_reentrant=False)
        context = partial(create_selective_checkpoint_contexts, SAVED_PRODUCTS[remat])
        return checkpoint(block, x, use_reentrant=False, context_fn=context)

    def train_block(block, p, spec, handle=None, **kw):
        """``block(cfg, p, x, **kw)`` as a function of x; under a mesh the
        FSDP gather of ``p`` by its executed ``spec`` runs inside it, so
        remat recomputes it."""
        if mesh is None:
            return partial(block, cfg, p, **kw)
        gathered = partial(fsdp_gather, p, spec, mesh, compute_dtype, handle is not None)
        return lambda x: block(cfg, gathered(), x, mesh=mesh, sp=sp, **kw)

    layer_block = TRAIN_BLOCKS.get(cfg.family, dense_block)  # vlm: its self layers
    obs = []
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for layer, p_layer in enumerate(params["blocks"]):
        spec = specs["blocks"][layer] if mesh is not None else None
        if cfg.family == "vlm":  # a layer group: its self layers, then its cross layer
            for i, p_self in enumerate(p_layer["self"]):
                x = run(train_block(dense_block, p_self, spec and spec["self"][i], positions=positions,
                                    q_chunk=q_chunk, attn_impl=attn_impl), x)
            x = run(train_block(cross_block, p_layer["cross"], spec and spec["cross"], vision_tokens=vision), x)
            continue
        if cfg.family == "ssm":
            x = run(train_block(layer_block, p_layer, spec, wkv_impl=wkv_impl), x)
            continue
        handle = fp8.bind_layer_scales(layer) if fp8 is not None else None
        block = train_block(layer_block, p_layer, spec, handle, positions=positions, q_chunk=q_chunk,
                            attn_impl=attn_impl, fp8=handle)
        if cfg.family == "moe":
            x, a = run(block, x)
            aux = aux + a
        else:
            x = run(block, x)
        if fp8 is not None:
            obs.append(fp8.drain())
    if mesh is None:
        logits = lm_logits(cfg, params, x)
    else:
        head = dict(params, final_norm=fsdp_gather(params["final_norm"], specs["final_norm"], mesh))
        logits = lm_logits(cfg, head, x, mesh, gather=False, sp=sp)
    aux = aux / cfg.num_layers
    if fp8 is None:
        return logits, aux
    amaxes = {k: torch.stack([o[k] for o in obs]) for k in fp8.keys}
    return logits, aux, amaxes


@torch.no_grad()
def prefill(cfg, params, batch, *, q_chunk=0, mesh=None, kv_seq_split=False):
    """Inference prefill of whole prompts.  Returns (logits (B, V), raw
    cache).

    batch: ``tokens`` (B, S) int and optional ``last_index`` (B,) int, each
    sequence's last *real* token: the logits are taken there instead of at
    S - 1, which makes right-padded, length-bucketed prefill exact (causal
    attention: pad positions never reach earlier K/V or those logits; the
    recurrent families' states absorb every position, so the engine
    prefills them at the exact length).  The raw cache holds each layer's
    cache stacked over layers, as the JAX package's layer scan stacks
    them: the full-length K/V ``{"k", "v": (L, B, S, KV, hd)}``, beside
    ``"conv"`` ``(L, B, K-1, d_inner)`` and ``"ssm"`` ``(L, B, H, P, N)``
    for the hybrid family; ``{"tm_x", "cm_x": (L, B, D), "state": (L, B,
    H, n, n)}`` for the ssm family, whose WKV scan is the chunked one (K5
    computes no final state); for the vlm family, which reads
    ``batch["vision_tokens"]`` (B, N, D) as they are, stacked over layer
    groups: ``{"self": {"k", "v": (G, g, B, S, KV, hd)}, "cross": {"ck",
    "cv": (G, B, N, KV, hd)}}``.  ``serving.kvcache`` turns it into the slot
    cache ``decode_step`` reads.  A Python layer loop, in tensor ops (the
    JAX package's prefill reaches no Pallas kernel either).  For the moe
    family the pad positions are routed with the prompt's tokens, so they
    compete for expert capacity, as in the JAX package.  Under a serving
    ``mesh`` the K/V hold the rank's kv heads; with ``kv_seq_split`` every
    kv head's, cut to this rank's share of the sequence, split over the
    model axis of ``mesh`` (as ``decode_step``'s split ring).
    """
    _check_served(cfg)
    tokens = batch["tokens"]
    positions = torch.arange(tokens.shape[1], device=tokens.device).expand(tokens.shape)
    x = embed_input(cfg, params, tokens, positions, mesh)
    layers = []
    for p_layer in params["blocks"]:
        if cfg.family == "ssm":
            x, c = rwkv_block_prefill(cfg, p_layer, x, mesh=mesh)
        elif cfg.family == "vlm":  # a layer group: its self layers, then its cross layer
            selfs = []
            for p_self in p_layer["self"]:
                x, sc = dense_block_prefill(cfg, p_self, x, positions=positions, q_chunk=q_chunk, mesh=mesh,
                                            whole_kv=kv_seq_split)
                selfs.append(sc)
            x, cc = cross_block_prefill(cfg, p_layer["cross"], x, batch["vision_tokens"], mesh=mesh)
            c = {"self": _stack_caches(selfs), "cross": cc}
        else:
            x, c = PREFILL_BLOCKS[cfg.family](cfg, p_layer, x, positions=positions, q_chunk=q_chunk, mesh=mesh,
                                              whole_kv=kv_seq_split)
        layers.append(_own_kv_seq(c, mesh) if kv_seq_split else c)
    last_index = batch.get("last_index")
    if last_index is None:
        x_last = x[:, -1]
    else:
        x_last = x[torch.arange(x.shape[0], device=x.device), last_index.long()]
    return lm_logits(cfg, params, x_last, mesh), _stack_caches(layers)


def _own_kv_seq(c: dict, mesh) -> dict:
    """A layer's prefill cache with its ``"k"`` / ``"v"`` leaves (a vlm
    group's self layers' too) cut to this rank's contiguous share of the
    sequence (dim -3), copied so the whole sequence's K/V can go."""
    n, r = model_axis_size(mesh), model_rank(mesh)

    def own(t):
        share = t.shape[-3] // n
        return t.narrow(-3, r * share, share).clone()

    if "self" in c:
        return {**c, "self": {k: own(t) if k in ("k", "v") else t for k, t in c["self"].items()}}
    return {k: own(t) if k in ("k", "v") else t for k, t in c.items()}


# chunked prefill needs a paged cache and per-chunk state that the written
# K/V captures; recurrent states absorb the whole prompt in one pass
CHUNKED_PREFILL_FAMILIES = ("dense", "moe")


def supports_chunked_prefill(cfg) -> bool:
    """Whether prompts of ``cfg``'s family can stream in chunks through
    ``prefill_step`` (and so be prefix-cached and preempted), as in the JAX
    package; other families keep the blocking whole-prompt prefill."""
    return cfg.family in CHUNKED_PREFILL_FAMILIES


def _chunk_stack(cfg, params, cache, tokens, start, tbl_row, *, attn_impl="kernel", widths=None, mesh=None):
    """Embed C tokens at ``start + [0, C)``, scatter their K/V into the paged
    cache through ``tbl_row`` and attend causally over the paged history.
    ``widths`` ((B,) int32, optional): per-row valid-lane counts; lanes at
    or past ``widths[b]`` scatter to the null block; an MoE layer routes
    them with the valid lanes, as in the JAX package.  Returns x (B, C, D).
    The recurrent families (hybrid, ssm) raise ``ValueError``, as in the
    JAX package: their states cannot resume mid-prompt."""
    if not supports_chunked_prefill(cfg):
        raise ValueError(f"no chunked prefill for family {cfg.family!r} ({cfg.name})")
    block = _serving_block(cfg, dense_block_chunk, moe_block_chunk)
    C = tokens.shape[1]
    positions = start[:, None].long() + torch.arange(C, device=tokens.device)[None, :]
    x = embed_input(cfg, params, tokens, positions, mesh)
    for layer, p_layer in enumerate(params["blocks"]):
        x = block(
            cfg, p_layer, x, layer_cache(cache, layer), tbl_row, start, attn_impl=attn_impl, widths=widths, mesh=mesh
        )
    return x


@torch.no_grad()
def prefill_step(cfg, params, cache, tokens, start, tbl_row, *, attn_impl="kernel", mesh=None):
    """Process one prompt chunk against a paged cache.

    tokens:  (B, C) int32, C consecutive prompt tokens
    start:   (B,) int32 absolute position of the chunk's first token
    tbl_row: (B, nb) int32, the request's block table (the engine's
             ``cache["tbl"]`` rows stay null until the prompt completes, so
             interleaved decode steps can't touch a half-prefilled request).

    Writes the chunk's K/V into the request's blocks, attends causally over
    the paged history [0, start + C) and returns (logits (B, V) at the
    chunk's last token, cache).  Chaining chunks reproduces a whole-prompt
    prefill exactly for the dense family; for moe, only where expert
    capacity does not bind, since each call routes its own tokens (the
    JAX package's caveat: chunked, exact-length and bucketed prefill drop
    different pairs when it binds).
    """
    _check_impl(cfg, attn_impl)
    x = _chunk_stack(cfg, params, cache, tokens, start, tbl_row, attn_impl=attn_impl, mesh=mesh)
    return lm_logits(cfg, params, x[:, -1], mesh), cache


@torch.no_grad()
def verify_step(cfg, params, cache, tokens, start, tbl_row, *, attn_impl="kernel", mesh=None):
    """Score C candidate tokens against a paged cache in one pass.

    The chunk machinery of ``prefill_step`` (scatter, then K2 over the
    paged history), with the logits of EVERY lane, (B, C, V): fed
    ``[last_committed, d_1, ..., d_k]``, lane i holds the target's
    distribution after the i-th fed token, so ``sampler.spec_accept`` can
    judge the whole draft window from one call.  The fed tokens' K/V is
    written to the cache; the caller zeroes what the accept pass does not
    commit (``serving.kvcache.truncate_block_rows``).
    """
    _check_impl(cfg, attn_impl)
    x = _chunk_stack(cfg, params, cache, tokens, start, tbl_row, attn_impl=attn_impl, mesh=mesh)
    return lm_logits(cfg, params, x, mesh), cache


@torch.no_grad()
def unified_step(cfg, params, cache, tokens, start, widths, tbl_rows, *, attn_impl="kernel", mesh=None):
    """One fused pass over a mixed row batch (the one-dispatch step).

    tokens:   (R, W) int32, each row feeds up to W consecutive tokens
    start:    (R,) int32 absolute position of each row's first token
    widths:   (R,) int32 valid lanes per row: a decode row feeds 1, a
              prefill-chunk row its chunk length, a pad row 0; lanes past
              the width scatter to the null block and their logits are
              garbage the caller discards
    tbl_rows: (R, nb) int32 per-row block tables (a mid-prefill row's
              table is its private block list; decode rows pass the
              published engine row; pad rows are all null)

    Rows are independent batch entries through the chunk machinery of
    ``prefill_step``.  Every layer scatters all rows' K/V before it
    attends, so several chunk rows of one request may ride in the same
    call: a later chunk reads the earlier chunk's K/V of the same layer, as
    sequential chunking would.  Returns (logits (R, W, V), cache): the
    logits of every lane, so the caller can sample in the same graph.
    """
    _check_impl(cfg, attn_impl)
    x = _chunk_stack(cfg, params, cache, tokens, start, tbl_rows, attn_impl=attn_impl, widths=widths, mesh=mesh)
    return lm_logits(cfg, params, x, mesh), cache


@torch.no_grad()
def decode_step(cfg, params, cache, token, pos, *, attn_impl="kernel", mesh=None, kv_seq_split=False):
    """One decode step.  token: (B, 1) int32; pos: (B,) int32 absolute
    position of this token.  Returns (logits (B, V), cache).

    The cache is the paged layout (``init_paged_cache``; attention through
    ``attn_impl``) or the dense slot cache (``init_cache``; attention in
    tensor ops whatever ``attn_impl`` says), selected by its keys.  A vlm
    group's self layers decode on its ring; its cross layer reads the
    group's cached image K/V and leaves it as it is.  Every
    row is computed, idle slots included: an MoE layer routes them all.
    The ssm family ignores ``pos`` (the recurrence has no positions).
    ``kv_seq_split``: under a ``mesh`` whose kv heads do not divide the
    model axis, each rank's dense ring holds every kv head's share of the
    slots
    (``attention.decode_attention(seq_split=True)``; the dry run's serving
    layout, ``parallel.sharding.kv_seq_shards``).

    The recurrent states are updated in place.  The ``conv``, ``tm_x`` and
    ``cm_x`` leaves come back in the dtype the step computes them in (the
    activations', the params' here): a cache made in bf16 under fp32
    weights holds them in bf16 until the first step, then in fp32, as the
    new cache leaves of the JAX package's layer scan do.  The step then
    replaces those leaves of ``cache`` with new tensors."""
    _check_impl(cfg, attn_impl)
    x = embed_input(cfg, params, token, pos[:, None], mesh)
    for name in STEP_DTYPE_LEAVES:
        if name in cache and cache[name].dtype != x.dtype:
            cache[name] = cache[name].to(x.dtype)
    for layer, p_layer in enumerate(params["blocks"]):
        if cfg.family == "vlm":
            for i, p_self in enumerate(p_layer["self"]):
                x = dense_block_decode(cfg, p_self, x, {n: t[layer, i] for n, t in cache["self"].items()}, pos,
                                       mesh=mesh, kv_seq_split=kv_seq_split)
            x = cross_block_decode(cfg, p_layer["cross"], x, {n: t[layer] for n, t in cache["cross"].items()}, mesh=mesh)
            continue
        c = layer_cache(cache, layer)
        if cfg.family == "ssm":
            x, new = rwkv_block_decode(cfg, p_layer, x, c, pos, mesh=mesh)
            for name, t in new.items():
                c[name].copy_(t)
        else:
            x = DECODE_BLOCKS[cfg.family](cfg, p_layer, x, c, pos, attn_impl=attn_impl, mesh=mesh,
                                          kv_seq_split=kv_seq_split)
    return lm_logits(cfg, params, x[:, 0], mesh), cache
