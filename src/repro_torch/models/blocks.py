"""Blocks per family: one layer's specs, its full-sequence forward
(training, eval) and its serving steps.

* dense (olmo, mistral-nemo, gemma): the forward, the whole-prompt
  prefill that returns the layer's K/V (the dense slot cache's
  admission), the chunked-prefill step against a paged cache and the
  decode step against either cache layout;
* moe (qwen3-moe, arctic): the forward, which also returns the layer's
  load-balance loss, and the same serving steps with the routed experts
  (``models.moe``) in place of the FFN, and arctic's dense residual FFN
  beside them;
* ssm (RWKV6): the forward, and the prefill and decode steps that carry
  the recurrent state (``tm_x``, ``cm_x``, ``state``);
* hybrid (hymba): attention heads and SSM heads (``models.ssm``) side by
  side on one normed input, each output RMS-normed and scaled before they
  are averaged: the forward, the prefill that returns the layer's K/V and
  its conv and SSM states, and the decode step against either cache
  layout, whose recurrent states stay slot-dense beside the K/V;
* audio (hubert): the dense blocks over frame embeddings;
* vlm (llama-3.2-vision): dense blocks for the self layers, and the cross
  layer, which attends the image tokens (``cross_attention``) and gates
  its attention and FFN into the residual through ``tanh`` of zero-init
  scalars: its forward, the prefill that returns the projected image K/V
  (``ck`` / ``cv``, fixed for the rest of the request) and the decode step
  that reads them back.

Decode attention picks the cache layout by the cache's keys, as the JAX
package's ``_decode_attn``: ``"tbl"`` is the paged layout (through
``attn_impl``, K1 under ``"kernel"``), else the dense ring cache.

Sequence parallelism (the training blocks' ``sp=True``, with a mesh): x
and the block's output are this rank's seq slice ``(B, S / tp, D)``.
Each sublayer's norm runs on the slice (its scale and bias through
``copy_to_model``), then a ``SeqGather`` hands the sublayer the whole
sequence, which returns its slice (``reduce_scatter_seq`` after a
row-parallel product).  The parallel-residual form gathers ``h`` once for
both sublayers, and hymba gathers it once for its attention and SSM heads.
A branch that runs whole on every rank (hymba's SSM heads, and its
attention where the heads do not divide; rwkv6's time mix) reads the
gather's ``whole()`` view and ``scatter_seq`` cuts its output, so its
leaves take their whole gradients on every rank, as under tensor
parallelism; the leaves that act on the slice (hymba's ``beta_*``, the
vlm gates) take ``copy_to_model``.
"""

from __future__ import annotations

import torch

from repro_torch.models import rwkv as rwkv_mod
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.attention import (
    _gated_cross,
    _proj,
    _qkv,
    _rms_head,
    attention_specs,
    cross_attention,
    decode_attention,
    paged_chunk_attention,
    paged_decode_attention,
    prefill_attention,
    self_attention,
)
from repro_torch.models.ffn import ffn, ffn_specs
from repro_torch.models.layers import ParamSpec, apply_norm, norm_specs
from repro_torch.models.moe import moe_ffn, moe_specs
from repro_torch.parallel.collectives import SeqGather, copy_to_model, scatter_seq


def _decode_attn(cfg, p_attn, h, cache, pos, attn_impl, mesh=None, kv_seq_split=False):
    """One decode token's attention against either cache layout (the keys
    select it: ``"tbl"`` paged, else the dense ring, whose slots
    ``kv_seq_split`` splits over the model axis), written in place."""
    if "tbl" in cache:
        return paged_decode_attention(cfg, p_attn, h, cache, pos, impl=attn_impl, mesh=mesh)
    return decode_attention(cfg, p_attn, h, cache, pos, mesh=mesh, seq_split=kv_seq_split)


def dense_block_specs(cfg) -> dict:
    return {
        "norm1": norm_specs(cfg),
        "attn": attention_specs(cfg),
        "norm2": norm_specs(cfg),
        "mlp": ffn_specs(cfg),
    }


def _normed(cfg, p_norm, x, mesh=None, sp=False):
    """A sublayer's input: ``apply_norm`` of x; under ``sp`` normed on this
    rank's slice, then a ``SeqGather`` of it (module docstring)."""
    if not sp:
        return apply_norm(cfg, p_norm, x)
    return SeqGather(apply_norm(cfg, p_norm, x, seq_mesh=mesh), mesh)


def _residual(cfg, p, x, h, a, fp8=None, mesh=None, sp=False):
    if cfg.parallel_residual:
        # GPT-NeoX / StableLM parallel form: one LN, attn + FFN both from it
        return x + a + ffn(cfg, p["mlp"], h, fp8=fp8, mesh=mesh, sp=sp)
    x = x + a
    return x + ffn(cfg, p["mlp"], _normed(cfg, p["norm2"], x, mesh, sp), fp8=fp8, mesh=mesh, sp=sp)


def dense_block(cfg, p, x, *, positions=None, q_chunk=0, attn_impl="torch", fp8=None, mesh=None, sp=False):
    """Full-sequence forward of one layer (training): x (B, S, D) -> (B, S, D).
    ``fp8``: this layer's FP8 handle, or None.  ``mesh``: sharded
    training's (``p`` then holds this rank's model slices, its FSDP leaves
    already gathered by ``models.forward``); ``sp``: sequence parallelism,
    x and the output this rank's seq slice (module docstring), the
    ``positions`` the whole sequence's."""
    h = _normed(cfg, p["norm1"], x, mesh, sp)
    a = self_attention(cfg, p["attn"], h, positions=positions, q_chunk=q_chunk, impl=attn_impl, fp8=fp8, mesh=mesh,
                       sp=sp)
    return _residual(cfg, p, x, h, a, fp8=fp8, mesh=mesh, sp=sp)


def dense_block_prefill(cfg, p, x, *, positions=None, q_chunk=0, mesh=None, whole_kv=False):
    """Full-sequence forward of one layer that also returns its K/V:
    (x (B, S, D), {"k", "v": (B, S, KV, hd)}).  ``mesh``, here and in every
    serving block: the tensor-parallel serving mesh, over which the
    row-parallel products sum (``attention``, ``ffn``, ``moe``); the K/V
    hold the rank's kv heads, or with ``whole_kv`` every kv head
    (``attention.prefill_attention``)."""
    h = apply_norm(cfg, p["norm1"], x)
    a, k, v = prefill_attention(cfg, p["attn"], h, positions=positions, q_chunk=q_chunk, mesh=mesh,
                                whole_kv=whole_kv)
    return _residual(cfg, p, x, h, a, mesh=mesh), {"k": k, "v": v}


def dense_block_chunk(cfg, p, x, cache, tbl_row, start, *, attn_impl="kernel", widths=None, mesh=None):
    """Chunked-prefill step: a C-token chunk written and attended through
    the request's own paged block table.  ``widths`` (fused mixed batches):
    per-row valid-lane counts; pad lanes scatter to the null block and
    their outputs are discarded upstream."""
    h = apply_norm(cfg, p["norm1"], x)
    a = paged_chunk_attention(cfg, p["attn"], h, cache, tbl_row, start, impl=attn_impl, widths=widths, mesh=mesh)
    return _residual(cfg, p, x, h, a, mesh=mesh)


def dense_block_decode(cfg, p, x, cache, pos, *, attn_impl="kernel", mesh=None, kv_seq_split=False):
    """One decode token against either cache layout: the cache's keys select
    it (``"tbl"``: paged, through ``attn_impl``; else the dense ring cache,
    always in tensor ops), as the JAX package's ``_decode_attn``."""
    h = apply_norm(cfg, p["norm1"], x)
    a = _decode_attn(cfg, p["attn"], h, cache, pos, attn_impl, mesh, kv_seq_split)
    return _residual(cfg, p, x, h, a, mesh=mesh)


# ---------------------------------------------------------------------------
# MoE (arctic: + a dense residual FFN; qwen3: plain top-8)
# ---------------------------------------------------------------------------


def moe_block_specs(cfg) -> dict:
    specs = {
        "norm1": norm_specs(cfg),
        "attn": attention_specs(cfg),
        "norm2": norm_specs(cfg),
        "moe": moe_specs(cfg),
    }
    if cfg.moe.dense_residual:
        specs["dense_mlp"] = ffn_specs(cfg, cfg.d_ff)
        specs["norm_dense"] = norm_specs(cfg)
    return specs


def _moe_residual(cfg, p, x, a, fp8=None, mesh=None, sp=False):
    """The routed experts over ``norm2`` of the attention's residual, and
    arctic's dense FFN over ``norm_dense`` of it beside them: (x, the
    layer's load-balance loss), which serving drops, as in the JAX package.
    ``fp8`` quantizes the dense FFN; the routed experts stay ``torch.bmm``
    in the compute dtype, as in the JAX package."""
    x = x + a
    mo, aux = moe_ffn(cfg, p["moe"], _normed(cfg, p["norm2"], x, mesh, sp), mesh=mesh, sp=sp)
    if cfg.moe.dense_residual:
        mo = mo + ffn(cfg, p["dense_mlp"], _normed(cfg, p["norm_dense"], x, mesh, sp), fp8=fp8, mesh=mesh, sp=sp)
    return x + mo, aux


def moe_block(cfg, p, x, *, positions=None, q_chunk=0, attn_impl="torch", fp8=None, mesh=None, sp=False):
    """Full-sequence forward of one layer (training): (x (B, S, D), aux).
    ``fp8`` quantizes the attention projections and arctic's dense FFN.
    ``mesh`` and ``sp``: sharded training's, as ``dense_block``'s (the
    experts split over the model axis, the routing groups over the data
    axis: ``models.moe``)."""
    h = _normed(cfg, p["norm1"], x, mesh, sp)
    a = self_attention(cfg, p["attn"], h, positions=positions, q_chunk=q_chunk, impl=attn_impl, fp8=fp8, mesh=mesh,
                       sp=sp)
    return _moe_residual(cfg, p, x, a, fp8=fp8, mesh=mesh, sp=sp)


def moe_block_prefill(cfg, p, x, *, positions=None, q_chunk=0, mesh=None, whole_kv=False):
    """As ``dense_block_prefill``.  The pad positions of a bucketed prompt
    are routed with its tokens and compete for expert capacity, as in the
    JAX package."""
    h = apply_norm(cfg, p["norm1"], x)
    a, k, v = prefill_attention(cfg, p["attn"], h, positions=positions, q_chunk=q_chunk, mesh=mesh,
                                whole_kv=whole_kv)
    return _moe_residual(cfg, p, x, a, mesh=mesh)[0], {"k": k, "v": v}


def moe_block_chunk(cfg, p, x, cache, tbl_row, start, *, attn_impl="kernel", widths=None, mesh=None):
    """As ``dense_block_chunk``.  A chunk routes exactly its own tokens; a
    fused mixed batch (``widths``) also routes its pad lanes, which compete
    for expert capacity, as in the JAX package."""
    h = apply_norm(cfg, p["norm1"], x)
    a = paged_chunk_attention(cfg, p["attn"], h, cache, tbl_row, start, impl=attn_impl, widths=widths, mesh=mesh)
    return _moe_residual(cfg, p, x, a, mesh=mesh)[0]


def moe_block_decode(cfg, p, x, cache, pos, *, attn_impl="kernel", mesh=None, kv_seq_split=False):
    """As ``dense_block_decode``: every batch row is routed, idle slots
    included."""
    h = apply_norm(cfg, p["norm1"], x)
    a = _decode_attn(cfg, p["attn"], h, cache, pos, attn_impl, mesh, kv_seq_split)
    return _moe_residual(cfg, p, x, a, mesh=mesh)[0]


# ---------------------------------------------------------------------------
# RWKV6 (attention-free)
# ---------------------------------------------------------------------------


def rwkv_block_specs(cfg) -> dict:
    return {
        "norm1": norm_specs(cfg),
        "time_mix": rwkv_mod.time_mix_specs(cfg),
        "norm2": norm_specs(cfg),
        "channel_mix": rwkv_mod.channel_mix_specs(cfg),
    }


def rwkv_block(cfg, p, x, *, wkv_impl="chunked", mesh=None, sp=False):
    """Full-sequence forward of one layer from a zero state; the final
    state is dropped, so ``wkv_impl="kernel"`` (K5) may compute the scan.
    ``mesh``: sharded training's, as ``dense_block``'s.  The time mix runs
    whole on every rank (``parallel.sharding.WHOLE_OVER_MODEL``) and the
    channel mix splits its hidden dim (``models.rwkv.channel_mix``): only
    the channel mix's ``xk`` takes ``copy_to_model``, since the time mix's
    and the norms' gradients are whole already (trap 1 of ``models.moe``).
    Under ``sp`` the time mix runs whole on the gathered sequence and
    ``scatter_seq`` cuts its output; the channel mix gathers before its
    token shift, so the shift crosses the slices' edges."""
    h = _normed(cfg, p["norm1"], x, mesh, sp)
    out, _state = rwkv_mod.time_mix(cfg, p["time_mix"], h.whole() if sp else h, wkv_impl=wkv_impl)
    x = x + (scatter_seq(out, mesh) if sp else out)
    out, _cmx = rwkv_mod.channel_mix(cfg, p["channel_mix"], _normed(cfg, p["norm2"], x, mesh, sp), mesh=mesh, sp=sp)
    return x + out


def rwkv_block_prefill(cfg, p, x, *, mesh=None):
    """Forward that also returns the layer's decode cache: the last token of
    each mix and the WKV state (the chunked scan: K5 computes no state).
    ``mesh``, here and in ``rwkv_block_decode``: the tensor-parallel serving
    mesh, over which the channel mix splits its hidden dim (the time mix
    runs whole on every rank)."""
    h = apply_norm(cfg, p["norm1"], x)
    out, (tm_x, state) = rwkv_mod.time_mix(cfg, p["time_mix"], h)
    x = x + out
    h2 = apply_norm(cfg, p["norm2"], x)
    out, cm_x = rwkv_mod.channel_mix(cfg, p["channel_mix"], h2, mesh=mesh)
    x = x + out
    return x, {"tm_x": tm_x, "cm_x": cm_x, "state": state}


def rwkv_block_decode(cfg, p, x, cache, pos, *, mesh=None):
    """One token per sequence against the layer's cache; ``pos`` is unused
    (the recurrence has no positions), as in the JAX package."""
    h = apply_norm(cfg, p["norm1"], x)
    out, (tm_x, state) = rwkv_mod.time_mix_step(cfg, p["time_mix"], h, cache["tm_x"], cache["state"])
    x = x + out
    h2 = apply_norm(cfg, p["norm2"], x)
    out, cm_x = rwkv_mod.channel_mix(cfg, p["channel_mix"], h2, prev_x=cache["cm_x"], mesh=mesh)
    x = x + out
    return x, {"tm_x": tm_x, "cm_x": cm_x, "state": state}


# ---------------------------------------------------------------------------
# Hymba hybrid: parallel attention + SSM heads
# ---------------------------------------------------------------------------


def hybrid_block_specs(cfg) -> dict:
    D = cfg.d_model
    return {
        "norm1": norm_specs(cfg),
        "attn": attention_specs(cfg),
        "ssm": ssm_mod.ssm_specs(cfg),
        "beta_attn": ParamSpec((D,), ("embed",), "ones"),
        "beta_ssm": ParamSpec((D,), ("embed",), "ones"),
        "norm2": norm_specs(cfg),
        "mlp": ffn_specs(cfg),
    }


def _rmsn(x, eps=1e-5):
    """Parameter-free RMS norm in fp32, cast back to x's dtype."""
    xf = x.float()
    return (xf * torch.rsqrt(torch.mean(xf * xf, dim=-1, keepdim=True) + eps)).to(x.dtype)


def _hybrid_combine(p, a, m, dtype, seq_mesh=None):
    """The mean of the normed attention and SSM outputs, each scaled;
    ``seq_mesh``: a and m are this rank's seq slices, so the scales take
    ``copy_to_model``."""
    b_attn, b_ssm = p["beta_attn"], p["beta_ssm"]
    if seq_mesh is not None:
        b_attn, b_ssm = copy_to_model(b_attn, seq_mesh), copy_to_model(b_ssm, seq_mesh)
    return 0.5 * (b_attn.to(dtype) * _rmsn(a) + b_ssm.to(dtype) * _rmsn(m))


def _hybrid_ffn(cfg, p, x, fp8=None, mesh=None, sp=False):
    return x + ffn(cfg, p["mlp"], _normed(cfg, p["norm2"], x, mesh, sp), fp8=fp8, mesh=mesh, sp=sp)


def hybrid_block(cfg, p, x, *, positions=None, q_chunk=0, attn_impl="torch", fp8=None, mesh=None, sp=False):
    """Full-sequence forward of one layer from zero states (training): x
    (B, S, D) -> (B, S, D).  ``fp8`` quantizes the attention projections and
    the MLP; the SSM heads stay in the compute dtype, as in the JAX
    package.  ``mesh``: sharded training's, as ``dense_block``'s.  The SSM
    heads stay whole on every rank (``parallel.sharding``'s
    ``REPLICATED_SUBTREES``), and so does the attention where its heads do
    not divide the model axis (hymba's 25 over 5): only the FFN's input
    then takes ``copy_to_model`` (inside ``ffn``), since the replicated
    branches' gradients are whole already (trap 1 of ``models.moe``).
    Under ``sp`` both branches read the one gathered ``h``: the SSM heads
    its ``whole()`` view, their output cut by ``scatter_seq`` (module
    docstring)."""
    h = _normed(cfg, p["norm1"], x, mesh, sp)
    a = self_attention(cfg, p["attn"], h, positions=positions, q_chunk=q_chunk, impl=attn_impl, fp8=fp8, mesh=mesh,
                       sp=sp)
    m, _states = ssm_mod.ssm_mix(cfg, p["ssm"], h.whole() if sp else h)
    x = x + _hybrid_combine(p, a, scatter_seq(m, mesh) if sp else m, x.dtype, mesh if sp else None)
    return _hybrid_ffn(cfg, p, x, fp8=fp8, mesh=mesh, sp=sp)


def hybrid_block_prefill(cfg, p, x, *, positions=None, q_chunk=0, mesh=None, whole_kv=False):
    """Full-sequence forward of one layer from zero states that also returns
    its decode cache: (x (B, S, D), {"k", "v": (B, S, KV, hd), "conv": (B,
    K-1, d_inner) in x's dtype, "ssm": (B, H, P, N) fp32})."""
    h = apply_norm(cfg, p["norm1"], x)
    a, k, v = prefill_attention(cfg, p["attn"], h, positions=positions, q_chunk=q_chunk, mesh=mesh,
                                whole_kv=whole_kv)
    m, (conv_state, ssm_state) = ssm_mod.ssm_mix(cfg, p["ssm"], h)
    x = x + _hybrid_combine(p, a, m, x.dtype)
    return _hybrid_ffn(cfg, p, x, mesh=mesh), {"k": k, "v": v, "conv": conv_state, "ssm": ssm_state}


def hybrid_block_decode(cfg, p, x, cache, pos, *, attn_impl="kernel", mesh=None, kv_seq_split=False):
    """One decode token against the layer's cache: the attention against
    either layout (``_decode_attn``), the SSM step from the slot-dense
    ``conv`` / ``ssm`` states, which are updated in place, cast to their
    leaves' dtypes."""
    h = apply_norm(cfg, p["norm1"], x)
    a = _decode_attn(cfg, p["attn"], h, cache, pos, attn_impl, mesh, kv_seq_split)
    m, (conv_state, ssm_state) = ssm_mod.ssm_step(cfg, p["ssm"], h, cache["conv"], cache["ssm"])
    cache["conv"].copy_(conv_state)
    cache["ssm"].copy_(ssm_state)
    x = x + _hybrid_combine(p, a, m, x.dtype)
    return _hybrid_ffn(cfg, p, x, mesh=mesh)


# ---------------------------------------------------------------------------
# VLM cross-attention layer (llama-3.2-vision)
# ---------------------------------------------------------------------------


def cross_block_specs(cfg) -> dict:
    return {
        "norm1": norm_specs(cfg),
        "attn": attention_specs(cfg, cross=True),
        "norm2": norm_specs(cfg),
        "mlp": ffn_specs(cfg),
        "gate_mlp": ParamSpec((1,), (None,), "zeros"),
    }


def _cross_ffn(cfg, p, x, mesh=None, sp=False):
    """The FFN over ``norm2``, entering the residual through ``tanh(gate_mlp)``."""
    gate = copy_to_model(p["gate_mlp"], mesh) if sp else p["gate_mlp"]
    return x + torch.tanh(gate.to(x.dtype)) * ffn(cfg, p["mlp"], _normed(cfg, p["norm2"], x, mesh, sp), mesh=mesh,
                                                  sp=sp)


def cross_block(cfg, p, x, vision_tokens, *, mesh=None, sp=False):
    """Full-sequence forward of one cross layer: x (B, S, D) attends the
    vision tokens (B, N, D).  Returns (B, S, D).  ``mesh``: sharded
    training's, as ``dense_block``'s: the cross attention's heads and the
    FFN's hidden dim split over the model axis, the gates stay whole.
    ``sp``: x is this rank's seq slice; the vision tokens stay whole."""
    h = _normed(cfg, p["norm1"], x, mesh, sp)
    x = x + cross_attention(cfg, p["attn"], h, vision_tokens, mesh=mesh, sp=sp)
    return _cross_ffn(cfg, p, x, mesh=mesh, sp=sp)


def cross_block_prefill(cfg, p, x, vision_tokens, *, mesh=None):
    """As ``cross_block``, also returning the projected image K/V for the
    decode steps: (x, {"ck", "cv": (B, N, KV, hd)}), in the dtype the
    projection computes them in."""
    h = apply_norm(cfg, p["norm1"], x)
    q, ck, cv = _qkv(cfg, p["attn"], h, kv_x=vision_tokens, mesh=mesh)
    x = x + _gated_cross(cfg, p["attn"], h, q, ck, cv, mesh=mesh)
    return _cross_ffn(cfg, p, x, mesh=mesh), {"ck": ck, "cv": cv}


def cross_block_decode(cfg, p, x, cache, *, mesh=None):
    """One decode token against the cached image K/V (``cache["ck"]`` /
    ``["cv"]``, (B, N, KV, hd)), which it leaves as they are.  Only q is
    projected, with ``q_norm`` where the config has it and without the
    q bias, as in the JAX package's ``cross_block_decode``."""
    h = apply_norm(cfg, p["norm1"], x)
    pa = p["attn"]
    q = _proj(h, pa["wq"])
    if cfg.qk_norm:
        q = _rms_head(q, pa["q_norm"], cfg.norm_eps)
    x = x + _gated_cross(cfg, pa, h, q, cache["ck"], cache["cv"], mesh=mesh)
    return _cross_ffn(cfg, p, x, mesh=mesh)
