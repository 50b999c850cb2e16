"""Weight bridge: the JAX package's parameter tree (and train state) -> the
port's, and a JAX paged cache -> the port's.

The JAX tree stacks every block leaf over layers, ``(L, ...)``; the port
keeps one dict per layer.  Leaf names and layouts are the same, so the
bridge is a plain copy, nested subtrees included (the moe blocks' ``moe``,
the rwkv blocks' ``time_mix`` / ``channel_mix``, the hybrid blocks'
``attn``, ``ssm``, ``mlp``, ``beta_attn`` / ``beta_ssm`` and two norms).
The vlm family's JAX tree stacks layer groups, ``blocks["self"]`` leaves
``(G, g, ...)`` and ``blocks["cross"]`` leaves ``(G, ...)``; the port's
``blocks`` hold one ``{"self": [g layer dicts], "cross": dict}`` a group.
A train state can also arrive as one rank's slices of a sharded state.
Arrays arrive as numpy (the caller converts with
``np.asarray``, e.g. ``jax.tree.map(np.asarray, state)``); bf16, which
numpy lacks, goes through fp32.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.fp8.quantize import Fp8State
from repro_torch.models.cache import num_scan_groups
from repro_torch.optim.adamw import AdamWState
from repro_torch.train.step import TrainState


def _tensor(a, device, dtype) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype not in (np.float32, np.float64, np.float16):
        a = a.astype(np.float32)  # bf16 (ml_dtypes) and friends
    return torch.tensor(a, device=device, dtype=dtype)  # copies: JAX's arrays are read-only


def _unstack(tree, layer: int):
    if isinstance(tree, dict):
        return {k: _unstack(v, layer) for k, v in tree.items()}
    return np.asarray(tree)[layer]


def _convert(tree, device, dtype):
    if isinstance(tree, dict):
        return {k: _convert(v, device, dtype) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_convert(v, device, dtype) for v in tree]
    return _tensor(tree, device, dtype)


def params_from_jax(cfg, np_tree: dict, device="cuda", dtype=torch.float32) -> dict:
    """Port parameters holding the same values as the JAX tree ``np_tree``."""
    device = resolve_device(device)
    out = {k: _convert(v, device, dtype) for k, v in np_tree.items() if k != "blocks"}
    groups = [_unstack(np_tree["blocks"], l) for l in range(num_scan_groups(cfg))]
    if cfg.family == "vlm":
        g = cfg.vision.cross_attn_every - 1
        groups = [{"self": [_unstack(grp["self"], i) for i in range(g)], "cross": grp["cross"]} for grp in groups]
    out["blocks"] = [_convert(grp, device, dtype) for grp in groups]
    return out


def train_state_from_jax(
    cfg, np_state, device="cuda", param_dtype=torch.float32, opt_dtype=torch.float32, *, specs=None, mesh=None
) -> TrainState:
    """A port ``TrainState`` holding the values of the JAX ``TrainState``
    ``np_state`` (numpy leaves): parameters, the AdamW ``step``/``m``/``v``
    (unstacked like the parameters) and the ``Fp8State`` (``amax_history``,
    ``scale``, ``step``), so both packages can continue from one state,
    mid-training included.  With ``specs``
    (``parallel.sharding.state_shardings``) and a training ``mesh``: this
    rank's slices of it (``parallel.sharding.shard_state``)."""
    if (specs is None) != (mesh is None):
        raise ValueError("a sharded state takes both specs and a mesh")
    if mesh is not None:
        from repro_torch.parallel.sharding import shard_state

        return shard_state(train_state_from_jax(cfg, np_state, device, param_dtype, opt_dtype), specs, mesh)
    device = resolve_device(device)
    opt = np_state.opt
    fp8 = None
    if np_state.fp8 is not None:
        f = np_state.fp8
        fp8 = Fp8State(
            amax_history={k: _tensor(v, device, torch.float32) for k, v in f.amax_history.items()},
            scale={k: _tensor(v, device, torch.float32) for k, v in f.scale.items()},
            step=torch.tensor(int(f.step), dtype=torch.int32, device=device),
        )
    return TrainState(
        params=params_from_jax(cfg, np_state.params, device, param_dtype),
        opt=AdamWState(
            step=torch.tensor(int(opt.step), dtype=torch.int32, device=device),
            m=params_from_jax(cfg, opt.m, device, opt_dtype),
            v=params_from_jax(cfg, opt.v, device, opt_dtype),
        ),
        compress_residual=(
            None if np_state.compress_residual is None
            else params_from_jax(cfg, np_state.compress_residual, device, torch.float32)
        ),
        fp8=fp8,
    )


def paged_cache_from_jax(np_cache: dict, device="cuda") -> dict:
    """A port paged cache holding the JAX cache ``np_cache`` (numpy leaves):
    the pools in their own dtype (int8 as int8, ml_dtypes' bf16 and e4m3 by
    their bits), the fp32 scale leaves of quantized pools, the hybrid
    family's slot-dense ``conv`` (the cache dtype, or the compute dtype once
    a decode step ran) and ``ssm`` (fp32) states, ``(L, max_batch, ...)``
    as they are, and one block table, the first layer's (the port keeps one
    for every layer; the JAX package stacks a copy per layer)."""
    device = resolve_device(device)
    by_bits = {"bfloat16": (np.uint16, torch.bfloat16), "float8_e4m3fn": (np.uint8, torch.float8_e4m3fn)}
    out = {}
    for name, a in np_cache.items():
        a = np.asarray(a)
        if name == "tbl":
            out[name] = torch.tensor(a[0], dtype=torch.int32, device=device)
        elif a.dtype.name in by_bits:
            bits, dtype = by_bits[a.dtype.name]
            out[name] = torch.from_numpy(np.array(a).view(bits)).view(dtype).to(device)  # a writable copy
        else:
            out[name] = torch.tensor(a, device=device)
    return out
