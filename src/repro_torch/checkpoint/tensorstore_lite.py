"""Sharded on-disk checkpoint format, the JAX package's, for torch trees.

Layout (one directory per step), byte for byte the JAX package's
``checkpoint/tensorstore_lite.py``, so either package restores what the
other saved:

    <dir>/step_000042/
        manifest.json       # leaf shapes and dtypes, step metadata
        <leaf-path>.npy     # one array file per leaf ("/" -> "__")

A leaf's path names dict keys, list indices and NamedTuple fields
(``utils.tree.flatten_with_paths``); ``None`` holds no leaf.  bf16 and fp8
leaves, which ``np.save`` cannot hold, are stored as their raw bits
(``u2`` / ``u1``) under the dtype names the JAX package writes
(``bfloat16``, ``float8_e4m3fn``, ``float8_e5m2``).  The port reads those
bits back through ``Tensor.view`` and needs no ``ml_dtypes``.

Writes are atomic per step: the leaves go into a ``.tmp_ckpt_`` directory
that is renamed into place on commit, so a failure mid-write never
corrupts the restore point.
"""

from __future__ import annotations

import json
import os
import shutil
import tempfile
from pathlib import Path
from typing import Any

import numpy as np
import torch

from repro_torch.utils.tree import flatten_with_paths, tree_map_with_path, tree_size_bytes

_SEP = "__"

# dtypes np.save holds as they are: the JAX package's own list
_NUMPY = {
    torch.float64: "float64", torch.float32: "float32", torch.float16: "float16", torch.int64: "int64",
    torch.int32: "int32", torch.int16: "int16", torch.int8: "int8", torch.uint8: "uint8", torch.bool: "bool",
}
# dtypes stored as raw bits: the name the JAX package writes, the unsigned
# integer of the same width
_RAW = {
    torch.bfloat16: ("bfloat16", torch.uint16),
    torch.float8_e4m3fn: ("float8_e4m3fn", torch.uint8),
    torch.float8_e5m2: ("float8_e5m2", torch.uint8),
}
_BY_NAME = {name: dtype for dtype, name in _NUMPY.items()} | {v[0]: k for k, v in _RAW.items()}


def _fname(path: str) -> str:
    return path.replace("/", _SEP) + ".npy"


def _to_numpy(t: torch.Tensor) -> tuple[np.ndarray, str]:
    """The array ``np.save`` writes for ``t`` and the dtype name of the
    manifest.  ``.cpu()`` copies a card tensor; a CPU tensor is read where
    it lies, so the caller must not change it before the save returns."""
    t = t.detach().cpu()
    if t.dtype in _RAW:
        name, bits = _RAW[t.dtype]
        return t.view(bits).numpy(), name
    if t.dtype not in _NUMPY:
        raise TypeError(f"no checkpoint format for {t.dtype}")
    return t.numpy(), _NUMPY[t.dtype]


def _from_numpy(arr: np.ndarray, name: str) -> torch.Tensor:
    if name not in _BY_NAME:
        raise TypeError(f"checkpoint dtype {name!r} has no torch counterpart")
    dtype = _BY_NAME[name]
    if dtype in _RAW:
        return torch.from_numpy(arr).view(dtype)  # the raw bits, read as u2 / u1
    return torch.from_numpy(arr.astype(name, copy=False))


def save_pytree(tree: Any, directory: str | os.PathLike, *, step: int, extra: dict | None = None) -> Path:
    """Atomic checkpoint write. Returns the committed directory."""
    directory = Path(directory)
    directory.mkdir(parents=True, exist_ok=True)
    final = directory / f"step_{step:08d}"
    tmp = Path(tempfile.mkdtemp(dir=directory, prefix=".tmp_ckpt_"))
    manifest = {"step": step, "leaves": {}, "extra": extra or {}}
    try:
        for path, leaf in flatten_with_paths(tree):
            arr, name = _to_numpy(leaf)
            np.save(tmp / _fname(path), arr)
            manifest["leaves"][path] = {"shape": list(leaf.shape), "dtype": name}
        (tmp / "manifest.json").write_text(json.dumps(manifest, indent=1))
        if final.exists():
            shutil.rmtree(final)
        tmp.rename(final)  # atomic commit
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise
    return final


def checkpoint_bytes(tree: Any) -> int:
    return tree_size_bytes(tree)


def available_steps(directory: str | os.PathLike) -> list[int]:
    directory = Path(directory)
    if not directory.exists():
        return []
    steps = []
    for p in directory.iterdir():
        if p.is_dir() and p.name.startswith("step_") and (p / "manifest.json").exists():
            steps.append(int(p.name.split("_")[1]))
    return sorted(steps)


def restore_pytree(like: Any, directory: str | os.PathLike, *, step: int | None = None) -> tuple[Any, dict]:
    """Restore into the structure of ``like``: each leaf's shape is checked
    against ``like``'s, cast to its dtype and put on its device, as a new
    tensor (``like``'s own are left as they are, so two restores never
    share a tensor).

    Returns (tree, manifest_extra)."""
    directory = Path(directory)
    steps = available_steps(directory)
    if not steps:
        raise FileNotFoundError(f"no checkpoints under {directory}")
    step = steps[-1] if step is None else step
    src = directory / f"step_{step:08d}"
    manifest = json.loads((src / "manifest.json").read_text())
    # every leaf is read and checked before the first one goes to the device
    loaded = {}
    for path, leaf in flatten_with_paths(like):
        meta = manifest["leaves"].get(path)
        if meta is None:
            raise KeyError(f"checkpoint {src} missing leaf {path!r}")
        arr = _from_numpy(np.load(src / _fname(path)), meta["dtype"])
        if tuple(arr.shape) != tuple(leaf.shape):
            raise ValueError(f"{path}: checkpoint shape {tuple(arr.shape)} != expected {tuple(leaf.shape)}")
        loaded[path] = arr

    tree = tree_map_with_path(lambda path, leaf: loaded[path].to(device=leaf.device, dtype=leaf.dtype, copy=True),
                              like)
    return tree, manifest.get("extra", {})


def delete_step(directory: str | os.PathLike, step: int) -> None:
    shutil.rmtree(Path(directory) / f"step_{step:08d}", ignore_errors=True)
