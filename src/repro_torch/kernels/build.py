"""Build and load the port's CUDA sources: one function for every kernel.

Each source in ``csrc/`` has a plain C interface.  ``build`` compiles it
with ``nvcc`` for ``sm_90a`` into a shared library under ``build/`` at the
repository root, named by the source's stem and a hash of its content and
of every header in ``csrc/`` (``*.cuh``), so an edited source or header
builds anew and an unchanged one is built once.  ``load``
builds if needed and opens the library with ``ctypes``; the caller declares
the argument types.  Nothing here runs when a module is imported.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build"
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]

_loaded: dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(f"nvcc not found (looked in {cand} and on PATH)")
    return found


def library_path(source: str | Path) -> Path:
    """The shared library's path, keyed by a hash of the source and of every
    ``csrc/*.cuh``.  Raises FileNotFoundError if the source includes
    (``#include "..."``) a header that is not in ``csrc/``."""
    source = CSRC / source
    text = source.read_bytes()
    for name in re.findall(rb'^\s*#\s*include\s+"([^"]+)"', text, flags=re.M):
        if not (CSRC / name.decode()).is_file():
            raise FileNotFoundError(f"{source.name} includes {name.decode()!r}, which is not in {CSRC}")
    h = hashlib.sha256(text)
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.name.encode() + b"\0" + header.read_bytes())
    return BUILD_DIR / f"lib{source.stem}_{h.hexdigest()[:12]}.so"


def build(source: str | Path, verbose: bool = False) -> tuple[Path, str]:
    """Compile ``csrc/<source>`` unless this content is already built.
    Returns (library path, the compiler's messages; ``verbose`` adds ptxas's
    register and shared-memory report)."""
    out = library_path(source)
    if out.exists():
        return out, ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [_nvcc(), *ARCH_FLAGS, "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC"]
    if verbose:
        cmd += ["-Xptxas", "-v"]
    cmd += ["-o", tmp, str(CSRC / source)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed on {source} ({proc.returncode}):\n{proc.stderr}")
    os.replace(tmp, out)  # atomic: a concurrent build never sees half a file
    return out, proc.stdout + proc.stderr


def load(source: str | Path, declare) -> ctypes.CDLL:
    """The loaded library of ``csrc/<source>``, built at first use.
    ``declare(lib)`` sets its functions' ``argtypes`` and ``restype`` once."""
    key = str(source)
    with _lock:
        lib = _loaded.get(key)
        if lib is None:
            path, _ = build(source)
            lib = ctypes.CDLL(str(path))
            declare(lib)
            _loaded[key] = lib
        return lib
