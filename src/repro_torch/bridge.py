"""Weight bridge: the JAX package's parameter tree -> the port's.

The JAX tree stacks every block leaf over layers, ``(L, ...)``; the port
keeps one dict per layer.  Leaf names and layouts are the same, so the
bridge is a plain copy.  Arrays arrive as numpy (the caller converts with
``np.asarray``); bf16, which numpy lacks, goes through fp32.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.device import resolve_device


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
    return _tensor(tree, device, dtype)


def params_from_jax(cfg, np_tree: dict, device="cuda", dtype=torch.float32) -> dict:
    """Port parameters holding the same values as the JAX tree ``np_tree``."""
    device = resolve_device(device)
    out = {k: _convert(v, device, dtype) for k, v in np_tree.items() if k != "blocks"}
    out["blocks"] = [_convert(_unstack(np_tree["blocks"], l), device, dtype) for l in range(cfg.num_layers)]
    return out
