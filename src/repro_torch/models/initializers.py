"""Whole-model ParamSpec assembly and initialization (dense family).

The parameter tree keeps the JAX package's names and per-layer layout
(``wq (D,H,hd)``, ``wk/wv (D,KV,hd)``, ``wo (H,hd,D)``, ``w_up/w_gate
(D,F)``, ``w_down (F,D)``, ``embed.tok (V,D)``, ``lm_head (D,V)``); the JAX
package stacks the layers on a leading axis for its layer scan, the port
keeps a list of per-layer dicts under ``"blocks"``.
"""

from __future__ import annotations

import torch

from repro_torch.device import resolve_device
from repro_torch.models.blocks import dense_block_specs
from repro_torch.models.layers import ParamSpec, materialize, norm_specs


def param_specs(cfg) -> dict:
    if cfg.family != "dense":
        raise NotImplementedError(f"family {cfg.family!r} ({cfg.name}) is not ported yet")
    D, V = cfg.d_model, cfg.padded_vocab
    specs: dict = {"embed": {"tok": ParamSpec((V, D), ("vocab", "embed_v"), "normal")}}
    if cfg.learned_pos_embedding:
        specs["embed"]["pos"] = ParamSpec((cfg.max_position, D), (None, "embed_v"), "normal")
    specs["blocks"] = [dense_block_specs(cfg) for _ in range(cfg.num_layers)]
    specs["final_norm"] = norm_specs(cfg)
    if not cfg.tie_embeddings:
        specs["lm_head"] = ParamSpec((D, V), ("embed_v", "vocab"))
    return specs


def tree_map(fn, tree):
    """Map ``fn`` over the leaves of a tree of dicts and lists."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [tree_map(fn, v) for v in tree]
    return fn(tree)


def tree_leaves(tree) -> list:
    if isinstance(tree, dict):
        return [leaf for v in tree.values() for leaf in tree_leaves(v)]
    if isinstance(tree, list):
        return [leaf for v in tree for leaf in tree_leaves(v)]
    return [tree]


def init_params(cfg, generator: torch.Generator | int = 0, device="cuda", dtype=torch.float32) -> dict:
    """Random parameters with the JAX package's init kinds and scales (normal
    x0.02 for embeddings, truncated-normal fan-in for projections).  An int
    ``generator`` seeds a new ``torch.Generator`` on ``device``."""
    device = resolve_device(device)
    if isinstance(generator, int):
        generator = torch.Generator(device=device).manual_seed(generator)
    specs = param_specs(cfg)
    return tree_map(lambda s: materialize(s, generator, device, dtype), specs)
