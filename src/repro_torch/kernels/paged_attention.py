"""Paged attention on the card: wrappers of the two hand-written CUDA kernels.

``csrc/paged_attention.cu`` holds K1 (decode, one query token per sequence)
and K2 (chunked prefill, C query tokens per sequence), the Hopper
counterparts of the JAX package's Pallas ``paged_attention_bhd`` and
``paged_prefill_attention_bhd``.  The source is compiled with ``nvcc`` for
``sm_90a`` at first use into ``build/`` at the repository root and loaded
with ``ctypes`` (a plain C interface: no PyTorch headers, a build of
seconds).

Each wrapper checks device, dtype, shape and contiguity, allocates the
output with ``torch.empty``, launches on the current stream and raises if
the launch failed.  ``LAUNCHES`` counts the launches of each kernel; a
wrapper adds one where it launches, nowhere else.  For tensors on the CPU a
wrapper calls the kernel's plain version (``paged_attention_ref``); for
CUDA tensors it launches the kernel or raises, and never falls back.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path

import torch

from repro_torch.kernels.paged_attention_ref import (
    paged_attention_plain,
    paged_prefill_attention_plain,
)

SOURCE = Path(__file__).resolve().parent / "csrc" / "paged_attention.cu"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build"
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]

# launches of each kernel by its wrapper (reset with ``reset_launches``)
LAUNCHES = {"paged_decode": 0, "paged_prefill": 0}

PREFILL_ROW_TILE = 16  # K2 query rows per thread block
MAX_SMEM = 232_448  # bytes of shared memory one H100 thread block may use

_lib = None
_lib_lock = threading.Lock()


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(f"nvcc not found (looked in {cand} and on PATH)")
    return found


def library_path() -> Path:
    """The shared library's path, keyed by the source's content hash."""
    digest = hashlib.sha256(SOURCE.read_bytes()).hexdigest()[:12]
    return BUILD_DIR / f"libpaged_attention_{digest}.so"


def build(verbose: bool = False) -> tuple[Path, str]:
    """Compile the kernels unless this source is already built.  Returns
    (library path, the compiler's messages; ``verbose`` adds ptxas's
    register and shared-memory report)."""
    out = library_path()
    if out.exists():
        return out, ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [_nvcc(), *ARCH_FLAGS, "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC"]
    if verbose:
        cmd += ["-Xptxas", "-v"]
    cmd += ["-o", tmp, str(SOURCE)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{proc.stderr}")
    os.replace(tmp, out)  # atomic: concurrent builders never see half a file
    return out, proc.stdout + proc.stderr


def _library():
    global _lib
    with _lib_lock:
        if _lib is None:
            path, _ = build()
            lib = ctypes.CDLL(str(path))
            p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
            lib.paged_decode_attention.argtypes = [p] * 6 + [i] * 7 + [f, i, i, i, p]
            lib.paged_decode_attention.restype = i
            lib.paged_prefill_attention.argtypes = [p] * 6 + [i] * 9 + [f, i, i, i, p]
            lib.paged_prefill_attention.restype = i
            lib.paged_attention_smem_bytes.argtypes = [i, i, i]
            lib.paged_attention_smem_bytes.restype = ctypes.c_size_t
            _lib = lib
        return _lib


def _check(q, k_pool, v_pool, block_tables, lens, q_dims: int) -> None:
    dev = q.device
    for name, t in (("k_pool", k_pool), ("v_pool", v_pool), ("block_tables", block_tables), ("lens", lens)):
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, q on {dev}")
    for name, t in (("q", q), ("k_pool", k_pool), ("v_pool", v_pool), ("block_tables", block_tables), ("lens", lens)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"q dtype {q.dtype}: need float32 or bfloat16")
    if k_pool.dtype not in (torch.float32, torch.bfloat16) or v_pool.dtype != k_pool.dtype:
        raise TypeError(f"pools {k_pool.dtype}/{v_pool.dtype}: need matching float32 or bfloat16")
    if block_tables.dtype != torch.int32 or lens.dtype != torch.int32:
        raise TypeError("block_tables and lengths must be int32")
    if q.dim() != q_dims or k_pool.dim() != 4 or k_pool.shape != v_pool.shape:
        raise ValueError(f"shapes q {tuple(q.shape)}, pools {tuple(k_pool.shape)}/{tuple(v_pool.shape)}")
    B, H, hd = q.shape[0], q.shape[-2], q.shape[-1]
    N, bs, KV, pool_hd = k_pool.shape
    if pool_hd != hd or H % KV != 0:
        raise ValueError(f"q heads/head_dim ({H}, {hd}) do not fit pools (KV={KV}, hd={pool_hd})")
    if hd % 16 != 0 or not 16 <= hd <= 256:
        raise ValueError(f"head_dim {hd}: need a multiple of 16 in [16, 256]")
    if bs not in (16, 32):
        raise ValueError(f"block_size {bs}: need 16 or 32")
    if block_tables.dim() != 2 or block_tables.shape[0] != B or lens.shape != (B,):
        raise ValueError(f"tables {tuple(block_tables.shape)} / lengths {tuple(lens.shape)} for batch {B}")


def _smem_ok(lib, rows: int, bs: int, hd: int) -> None:
    need = lib.paged_attention_smem_bytes(rows, bs, hd)
    if need > MAX_SMEM:
        raise ValueError(f"{rows} query rows at hd={hd} need {need} B of shared memory (max {MAX_SMEM})")


def paged_attention(
    q: torch.Tensor,  # (B, H, hd) current-token queries
    k_pool: torch.Tensor,  # (N, bs, KV, hd)
    v_pool: torch.Tensor,
    block_tables: torch.Tensor,  # (B, nb) int32
    seq_lens: torch.Tensor,  # (B,) int32, >= 1
    *,
    softcap: float = 0.0,
    window: int = 0,
) -> torch.Tensor:
    """K1, decode.  Returns (B, H, hd) in q's dtype."""
    if q.device.type == "cpu":
        return paged_attention_plain(q, k_pool, v_pool, block_tables, seq_lens, softcap=softcap, window=window)
    if q.device.type != "cuda":
        raise ValueError(f"paged_attention runs on cuda or cpu, not {q.device}")
    _check(q, k_pool, v_pool, block_tables, seq_lens, 3)
    B, H, hd = q.shape
    N, bs, KV, _ = k_pool.shape
    lib = _library()
    _smem_ok(lib, H // KV, bs, hd)
    out = torch.empty_like(q)
    rc = lib.paged_decode_attention(
        q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(), block_tables.data_ptr(),
        seq_lens.data_ptr(), out.data_ptr(), B, H, KV, hd, N, bs, block_tables.shape[1],
        float(softcap), int(window), int(q.dtype == torch.bfloat16),
        int(k_pool.dtype == torch.bfloat16), torch.cuda.current_stream(q.device).cuda_stream,
    )
    if rc != 0:
        raise RuntimeError(f"paged_decode_attention launch failed: CUDA error {rc}")
    LAUNCHES["paged_decode"] += 1
    return out


def paged_prefill_attention(
    q: torch.Tensor,  # (B, C, H, hd) chunk queries
    k_pool: torch.Tensor,  # (N, bs, KV, hd), chunk K/V already written
    v_pool: torch.Tensor,
    block_tables: torch.Tensor,  # (B, nb) int32
    start: torch.Tensor,  # (B,) int32 absolute position of the chunk's first token
    *,
    softcap: float = 0.0,
    window: int = 0,
) -> torch.Tensor:
    """K2, chunked prefill.  Returns (B, C, H, hd) in q's dtype."""
    if q.device.type == "cpu":
        return paged_prefill_attention_plain(q, k_pool, v_pool, block_tables, start, softcap=softcap, window=window)
    if q.device.type != "cuda":
        raise ValueError(f"paged_prefill_attention runs on cuda or cpu, not {q.device}")
    _check(q, k_pool, v_pool, block_tables, start, 4)
    B, C, H, hd = q.shape
    N, bs, KV, _ = k_pool.shape
    lib = _library()
    row_tile = min(PREFILL_ROW_TILE, C * (H // KV))
    _smem_ok(lib, row_tile, bs, hd)
    out = torch.empty_like(q)
    rc = lib.paged_prefill_attention(
        q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(), block_tables.data_ptr(),
        start.data_ptr(), out.data_ptr(), B, C, H, KV, hd, N, bs, block_tables.shape[1],
        row_tile, float(softcap), int(window), int(q.dtype == torch.bfloat16),
        int(k_pool.dtype == torch.bfloat16), torch.cuda.current_stream(q.device).cuda_stream,
    )
    if rc != 0:
        raise RuntimeError(f"paged_prefill_attention launch failed: CUDA error {rc}")
    LAUNCHES["paged_prefill"] += 1
    return out
