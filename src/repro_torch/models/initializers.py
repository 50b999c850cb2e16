"""Whole-model ParamSpec assembly and initialization (dense, moe, ssm, hybrid, audio and vlm families).

The parameter tree keeps the JAX package's names and per-layer layout
(``wq (D,H,hd)``, ``wk/wv (D,KV,hd)``, ``wo (H,hd,D)``, ``w_up/w_gate
(D,F)``, ``w_down (F,D)``, ``embed.tok (V,D)``, ``lm_head (D,V)``; the moe
blocks' ``moe`` tree, ``router (D,E)``, ``w_gate/w_up (E,D,F)``, ``w_down
(E,F,D)``, beside arctic's ``dense_mlp`` and ``norm_dense``; the rwkv
blocks' ``time_mix``/``channel_mix`` trees, ``maa_w2 (5,r,D)``; the
hybrid blocks' ``attn``, ``ssm`` (``in_proj (D,2di)``, ``conv_w (K,di)``,
``a_log (H,N)``, ...), ``mlp``, ``beta_attn``/``beta_ssm (D,)`` and two
norms; the vlm
cross blocks' ``attn`` with its ``gate (1,)`` beside ``gate_mlp (1,)``); the JAX
package stacks the layers on a leading axis for its layer scan, the port
keeps a list of per-layer dicts under ``"blocks"``.  The vlm family scans
layer groups in the JAX package, ``blocks["self"]`` leaves ``(G, g, ...)``
and ``blocks["cross"]`` leaves ``(G, ...)``; the port keeps one entry per
group, ``{"self": [g dense block dicts], "cross": cross block dict}``.
The audio family (hubert) runs dense blocks over frame embeddings: its
``embed`` holds ``frame_proj (D,D)`` and learned ``pos (max_position,D)``
and no token table, and its head is always untied, as in the JAX package.
"""

from __future__ import annotations

import torch

from repro_torch.device import resolve_device
from repro_torch.models.blocks import (
    cross_block_specs,
    dense_block_specs,
    hybrid_block_specs,
    moe_block_specs,
    rwkv_block_specs,
)
from repro_torch.models.cache import num_scan_groups
from repro_torch.models.layers import ParamSpec, materialize, norm_specs
from repro_torch.utils.tree import tree_map


def vlm_group_specs(cfg) -> dict:
    """One vlm layer group: ``cross_attn_every - 1`` self layers, then a
    cross layer."""
    return {
        "self": [dense_block_specs(cfg) for _ in range(cfg.vision.cross_attn_every - 1)],
        "cross": cross_block_specs(cfg),
    }


# one entry of ``"blocks"`` by family: a layer, or a vlm layer group
BLOCK_SPECS = {
    "dense": dense_block_specs,
    "moe": moe_block_specs,
    "ssm": rwkv_block_specs,
    "hybrid": hybrid_block_specs,
    "audio": dense_block_specs,
    "vlm": vlm_group_specs,
}


def param_specs(cfg) -> dict:
    if cfg.family not in BLOCK_SPECS:
        raise NotImplementedError(f"family {cfg.family!r} ({cfg.name}) is not ported yet")
    D, V = cfg.d_model, cfg.padded_vocab
    if cfg.family == "audio":  # frame embeddings in, no token table
        specs: dict = {"embed": {"frame_proj": ParamSpec((D, D), ("embed", "heads_x_dim")),
                                 "pos": ParamSpec((cfg.max_position, D), (None, "embed"), "normal")}}
    else:
        specs = {"embed": {"tok": ParamSpec((V, D), ("vocab", "embed_v"), "normal")}}
        if cfg.learned_pos_embedding:
            specs["embed"]["pos"] = ParamSpec((cfg.max_position, D), (None, "embed_v"), "normal")
    specs["blocks"] = [BLOCK_SPECS[cfg.family](cfg) for _ in range(num_scan_groups(cfg))]
    specs["final_norm"] = norm_specs(cfg)
    if not cfg.tie_embeddings or cfg.family == "audio":
        specs["lm_head"] = ParamSpec((D, V), ("embed_v", "vocab"))
    return specs


def init_params(cfg, generator: torch.Generator | int = 0, device="cuda", dtype=torch.float32, *, shardings=None,
                mesh=None) -> dict:
    """Random parameters with the JAX package's init kinds and scales (normal
    x0.02 for embeddings, truncated-normal fan-in for projections).  An int
    ``generator`` seeds a new ``torch.Generator`` on ``device``.  With
    ``shardings`` (the executed specs of ``parallel.sharding``) and a
    training ``mesh``: this rank's slices of the same parameters, each leaf
    drawn whole from the generator in turn and cut at once, so no more than
    one whole leaf is ever held."""
    device = resolve_device(device)
    if isinstance(generator, int):
        generator = torch.Generator(device=device).manual_seed(generator)
    specs = param_specs(cfg)
    if mesh is None:
        return tree_map(lambda s: materialize(s, generator, device, dtype), specs)
    from repro_torch.parallel.sharding import shard_tensor

    return tree_map(lambda s, spec: shard_tensor(materialize(s, generator, device, dtype), spec, mesh), specs,
                    shardings)
