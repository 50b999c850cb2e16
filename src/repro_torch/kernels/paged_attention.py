"""Paged attention on the card: wrappers of the hand-written CUDA kernels.

``csrc/paged_attention.cu`` holds K1 (decode, one query token per sequence)
and K2 (chunked prefill, C query tokens per sequence), the Hopper
counterparts of the JAX package's Pallas ``paged_attention_bhd`` and
``paged_prefill_attention_bhd``.  The source is compiled with ``nvcc`` for
``sm_90a`` at first use into ``build/`` at the repository root and loaded
with ``ctypes`` through ``kernels.build`` (a plain C interface: no PyTorch
headers, a build of seconds).

K2 picks its kernel by the pools' dtype alone (``ROUTES``): bf16 pools,
what serving uses, run on the tensor cores (TMA through the block table,
``wgmma``; fp32 queries split exactly into two bf16 terms, P into two, each
64-key tile's P V added to O in fp32; where a tile is heavy, hd > 128 or a
softcap, a row tile's keys shared by a cluster of up to 4 blocks); fp32
pools run the first, CUDA-core kernel (v1).  This
is a dispatch, not a fallback: a kernel that fails to build or launch
raises.  ``paged_prefill_attention_cuda_cores`` runs v1 on either pool
dtype; no model path calls it: it is the yardstick the tensor-core kernel
is timed against.

K1 runs one kernel on every dtype (``DECODE_ROUTE``, fp32 on the CUDA
cores): each (sequence, kv head)'s live positions split over a
thread-block cluster of up to 8 blocks, picked from the table width and
the window on the host, and over 4 warps in each block, each warp with
its share's K/V loads in flight together; the cluster's first block
combines the shares through distributed shared memory.  ``paged_attention_cuda_cores`` runs K1's v1,
the yardstick; no model path calls it.

The entry points' CUDA branch reads the layout of each launch from the
autotuner's table (``kernels.autotune.get_config``, on the host at each
call, so a captured CUDA graph bakes it in): ``decode_kernel`` runs decode
through K1 (``"paged"``) or through K2 at C = 1 with ``start = seq_lens -
1`` (``"prefill1"``, the JAX package's form, ``paged_attention_ops.py``),
``decode_split`` and ``prefill_split`` force K1's and K2's cluster sizes.
The ``"default"`` entry (``"paged"``, 0, 0) is the library's own pick, and
shapes without a committed entry keep it.  The CPU branch never reads the
table.

Each wrapper checks device, dtype, shape and contiguity, allocates the
output with ``torch.empty``, launches on the current stream and raises if
the launch failed.  ``LAUNCHES`` counts the launches of each kernel:
``paged_decode`` K1, ``paged_prefill`` either route of K2, and
``paged_decode_cuda_cores`` / ``paged_prefill_cuda_cores`` the
yardsticks'; a wrapper adds one where it launches, nowhere else.  For
tensors on the CPU a wrapper calls the kernel's plain version
(``paged_attention_ref``); for CUDA tensors it launches the kernel or
raises, and never falls back.

Dtype contract, as the JAX package's ``kernels/paged_attention_ops.py``:
the pool dtype selects the path and the two never mix.  Quantized pools
(int8 / e4m3 rows with fp32 per-(token, head) scales, ``serving.kvquant``)
have no kernel, in the JAX package as here: ``paged_attention_quantized``
and ``paged_prefill_attention_quantized`` run the dequantizing plain
versions on every device, and K1/K2's entry points raise on a quantized
pool rather than read its codes as values.

Tensor-parallel serving (``InferenceEngine(mesh=)``) launches K1/K2 on each
rank's local heads, in the layout ``parallel.sharding.attention_layout``
picks from the head counts and the model axis of ``tp`` ranks:

* ``"split"`` (both head counts divide the axis): each rank's q holds its
  contiguous ``H / tp`` query heads and its pools their ``KV / tp`` kv
  heads, so the GQA groups stay whole;
* ``"grouped"`` (``H`` divides the axis, the axis divides ``KV``): each
  rank's q holds ``H / tp`` query heads, all of one GQA group, and its
  pools that group's one kv head, so K1/K2 run GQA at ``H / tp`` query
  heads over one kv head;
* ``"whole"`` (otherwise): every rank runs them on all the heads.

The kernels take either slice as they take any head count.  The
autotuner's key is read from the tensors a call gets, so it sees the
local head counts.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import autotune, build
from repro_torch.kernels.paged_attention_ref import (
    paged_attention_plain,
    paged_prefill_attention_plain,
)

SOURCE = "paged_attention.cu"  # under kernels/csrc

# launches of each kernel by its wrapper (reset with ``reset_launches``)
LAUNCHES = {"paged_decode": 0, "paged_decode_cuda_cores": 0, "paged_prefill": 0, "paged_prefill_cuda_cores": 0}

# the kernel K2 runs for each pool dtype, and K1's
ROUTES = {torch.bfloat16: "tensor_cores_bf16", torch.float32: "cuda_cores_fp32"}
DECODE_ROUTE = "cuda_cores_fp32"
QUANTIZED_POOLS = (torch.int8, torch.float8_e4m3fn)  # storage dtypes of ``serving.kvquant``

PREFILL_ROW_TILE = 16  # v1's K2 query rows per thread block
MAX_DECODE_SPLIT = 8  # blocks of K1's cluster
MAX_SMEM = 232_448  # bytes of shared memory one H100 thread block may use


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _declare(lib) -> None:
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.paged_decode_attention.argtypes = [p] * 6 + [i] * 7 + [f, i, i, i, p]
    lib.paged_decode_attention.restype = i
    lib.paged_decode_attention_split.argtypes = [p] * 6 + [i] * 7 + [f, i, i, i, i, p]
    lib.paged_decode_attention_split.restype = i
    lib.paged_decode_split.argtypes = [i] * 6
    lib.paged_decode_split.restype = i
    lib.paged_prefill_attention.argtypes = [p] * 6 + [i] * 9 + [f, i, i, i, p]
    lib.paged_prefill_attention.restype = i
    lib.paged_attention_smem_bytes.argtypes = [i, i, i]
    lib.paged_attention_smem_bytes.restype = ctypes.c_size_t
    lib.paged_prefill_attention_tc.argtypes = [p] * 6 + [i] * 8 + [f, i, i, i, p]
    lib.paged_prefill_attention_tc.restype = i
    lib.paged_prefill_tc_split.argtypes = [i] * 8 + [f, i]
    lib.paged_prefill_tc_split.restype = i


def _library():
    return build.load(SOURCE, _declare)


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


def _decode_split(q: torch.Tensor, k_pool: torch.Tensor, block_tables: torch.Tensor, *, window: int = 0) -> int:
    """The cluster size K1 picks on these shapes (from the table width, the
    window and the grid, never the lengths).  For checks and timing only."""
    B, H, _ = q.shape
    _, bs, KV, _ = k_pool.shape
    return _library().paged_decode_split(B, H, KV, block_tables.shape[1], bs, int(window))


def _decode_launch(q, k_pool, v_pool, block_tables, seq_lens, *, softcap: float = 0.0, window: int = 0,
                   cuda_cores: bool = False, split: int = 0) -> torch.Tensor:
    """Launch K1 on CUDA tensors: the split kernel, or v1 with
    ``cuda_cores``.  ``split``: the cluster of 1 to 8 blocks that share each
    (sequence, kv head)'s walk, 0 to let the kernel pick; the entry point
    passes the tuned table's ``decode_split`` (0 by default), checks and
    timing force the others."""
    _check(q, k_pool, v_pool, block_tables, seq_lens, 3)
    B, H, hd = q.shape
    N, bs, KV, _ = k_pool.shape
    lib = _library()
    args = (
        q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(), block_tables.data_ptr(), seq_lens.data_ptr(),
    )
    dims = (B, H, KV, hd, N, bs, block_tables.shape[1], float(softcap), int(window), int(q.dtype == torch.bfloat16),
            int(k_pool.dtype == torch.bfloat16))
    stream = torch.cuda.current_stream(q.device).cuda_stream
    out = torch.empty_like(q)
    if cuda_cores:
        _smem_ok(lib, H // KV, bs, hd)
        rc = lib.paged_decode_attention(*args, out.data_ptr(), *dims, stream)
    else:
        if not 0 <= split <= MAX_DECODE_SPLIT:
            raise ValueError(f"split {split}: need 0 (chosen by the table width) or 1 to {MAX_DECODE_SPLIT}")
        rc = lib.paged_decode_attention_split(*args, out.data_ptr(), *dims, int(split), stream)
    if rc != 0:
        raise RuntimeError(f"paged_decode_attention launch failed: CUDA error {rc}")
    LAUNCHES["paged_decode_cuda_cores" if cuda_cores else "paged_decode"] += 1
    return out


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
    """K1, decode (or K2 at C = 1 where the tuned table says
    ``"prefill1"``).  Returns (B, H, hd) in q's dtype."""
    if k_pool.dtype in QUANTIZED_POOLS:
        raise ValueError("quantized pools need scales: use paged_attention_quantized")
    if q.device.type == "cpu":
        return paged_attention_plain(q, k_pool, v_pool, block_tables, seq_lens, softcap=softcap, window=window)
    if q.device.type != "cuda":
        raise ValueError(f"paged_attention runs on cuda or cpu, not {q.device}")
    return launch_decode(q, k_pool, v_pool, block_tables, seq_lens, softcap=softcap, window=window,
                         tuned=tuned_config(q, k_pool, block_tables))


def tuned_config(q: torch.Tensor, k_pool: torch.Tensor, block_tables: torch.Tensor) -> dict:
    """The autotuner's config for these shapes (``autotune.get_config``:
    head dim, block size, table width, pool dtype, query heads per kv
    head); the defaults where the shapes are malformed, which the launch's
    checks then refuse."""
    if k_pool.dim() != 4 or block_tables.dim() != 2 or q.dim() < 3 or k_pool.shape[2] == 0:
        return autotune.get_config(0, 0, 0, k_pool.dtype, 0)
    return autotune.get_config(k_pool.shape[3], k_pool.shape[1], block_tables.shape[1], k_pool.dtype,
                               q.shape[-2] // k_pool.shape[2])


def launch_decode(q, k_pool, v_pool, block_tables, seq_lens, *, softcap: float = 0.0, window: int = 0,
                  tuned: dict) -> torch.Tensor:
    """Decode on CUDA tensors as the config ``tuned`` lays it out: K1 at
    its ``decode_split``, or K2 at C = 1 from ``seq_lens - 1`` at its
    ``prefill_split`` (``"prefill1"``: the causal and window masks of a
    one-token chunk at the last position are the decode masks)."""
    if tuned["decode_kernel"] == "prefill1":
        out = _prefill_launch(q[:, None], k_pool, v_pool, block_tables, seq_lens - 1, softcap=softcap,
                              window=window, split=tuned["prefill_split"])
        return out[:, 0]
    return _decode_launch(q, k_pool, v_pool, block_tables, seq_lens, softcap=softcap, window=window,
                          split=tuned["decode_split"])


def paged_attention_cuda_cores(
    q: torch.Tensor,  # (B, H, hd), on the card
    k_pool: torch.Tensor,  # (N, bs, KV, hd)
    v_pool: torch.Tensor,
    block_tables: torch.Tensor,
    seq_lens: torch.Tensor,
    *,
    softcap: float = 0.0,
    window: int = 0,
) -> torch.Tensor:
    """K1's first kernel (v1): the yardstick of the split kernel.  No model
    path calls it."""
    if q.device.type != "cuda":
        raise ValueError(f"paged_attention_cuda_cores runs on cuda, not {q.device}")
    return _decode_launch(q, k_pool, v_pool, block_tables, seq_lens, softcap=softcap, window=window, cuda_cores=True)


def prefill_route(q_dtype: torch.dtype, pool_dtype: torch.dtype) -> str:
    """The kernel K2 runs for these dtypes: ``ROUTES`` by the pools' dtype,
    for fp32 and bf16 queries alike."""
    if q_dtype not in (torch.float32, torch.bfloat16) or pool_dtype not in ROUTES:
        raise TypeError(f"q {q_dtype}, pools {pool_dtype}: need float32 or bfloat16")
    return ROUTES[pool_dtype]


def _prefill_split(q: torch.Tensor, k_pool: torch.Tensor, block_tables: torch.Tensor, *, softcap: float = 0.0,
                   window: int = 0) -> int:
    """The blocks (cluster size) that the tensor-core route picks to share
    each 64-row tile's keys on these shapes.  For checks and timing only."""
    B, C, H, hd = q.shape
    N, bs, KV, _ = k_pool.shape
    return _library().paged_prefill_tc_split(B, C, H, KV, hd, block_tables.shape[1], bs, int(window), float(softcap),
                                             int(q.dtype == torch.bfloat16))


def _prefill_launch(q, k_pool, v_pool, block_tables, start, *, softcap: float = 0.0, window: int = 0,
                    cuda_cores: bool = False, split: int = 0) -> torch.Tensor:
    """Launch K2 on CUDA tensors: the route of the pools' dtype
    (``ROUTES``), or v1 with ``cuda_cores``.  ``split`` (tensor-core route
    only): the cluster of 1 to 4 blocks that share each 64-row tile's keys,
    0 to let the kernel pick; the entry points pass the tuned table's
    ``prefill_split`` (0 by default), checks and timing force the others."""
    _check(q, k_pool, v_pool, block_tables, start, 4)
    B, C, H, hd = q.shape
    N, bs, KV, _ = k_pool.shape
    lib = _library()
    q_bf16 = int(q.dtype == torch.bfloat16)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    out = torch.empty_like(q)
    if not cuda_cores and prefill_route(q.dtype, k_pool.dtype) == "tensor_cores_bf16":
        if not 0 <= split <= 4:
            raise ValueError(f"split {split}: need 0 (chosen by the grid), 1, 2, 3 or 4")
        for name, t in (("q", q), ("k_pool", k_pool), ("v_pool", v_pool)):
            if t.data_ptr() % 16:
                raise ValueError(f"{name} must start on a 16-byte boundary")
        rc = lib.paged_prefill_attention_tc(
            q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(), block_tables.data_ptr(), start.data_ptr(),
            out.data_ptr(), B, C, H, KV, hd, N, bs, block_tables.shape[1], float(softcap), int(window), q_bf16,
            int(split), stream,
        )
    else:
        row_tile = min(PREFILL_ROW_TILE, C * (H // KV))
        _smem_ok(lib, row_tile, bs, hd)
        rc = lib.paged_prefill_attention(
            q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(), block_tables.data_ptr(),
            start.data_ptr(), out.data_ptr(), B, C, H, KV, hd, N, bs, block_tables.shape[1],
            row_tile, float(softcap), int(window), q_bf16, int(k_pool.dtype == torch.bfloat16), stream,
        )
    if rc != 0:
        why = "a TMA tensor map was refused" if rc == -1 else f"CUDA error {rc}"
        raise RuntimeError(f"paged_prefill_attention launch failed: {why}")
    LAUNCHES["paged_prefill_cuda_cores" if cuda_cores else "paged_prefill"] += 1
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
    if k_pool.dtype in QUANTIZED_POOLS:
        raise ValueError("quantized pools need scales: use paged_prefill_attention_quantized")
    if q.device.type == "cpu":
        return paged_prefill_attention_plain(q, k_pool, v_pool, block_tables, start, softcap=softcap, window=window)
    if q.device.type != "cuda":
        raise ValueError(f"paged_prefill_attention runs on cuda or cpu, not {q.device}")
    return launch_prefill(q, k_pool, v_pool, block_tables, start, softcap=softcap, window=window,
                          tuned=tuned_config(q, k_pool, block_tables))


def launch_prefill(q, k_pool, v_pool, block_tables, start, *, softcap: float = 0.0, window: int = 0,
                   tuned: dict) -> torch.Tensor:
    """K2 on CUDA tensors at the config's ``prefill_split`` (the
    tensor-core route; v1 on fp32 pools has no split)."""
    return _prefill_launch(q, k_pool, v_pool, block_tables, start, softcap=softcap, window=window,
                           split=tuned["prefill_split"])


def paged_prefill_attention_cuda_cores(
    q: torch.Tensor,  # (B, C, H, hd), on the card
    k_pool: torch.Tensor,  # (N, bs, KV, hd)
    v_pool: torch.Tensor,
    block_tables: torch.Tensor,
    start: torch.Tensor,
    *,
    softcap: float = 0.0,
    window: int = 0,
) -> torch.Tensor:
    """K2's CUDA-core kernel (v1) on either pool dtype: the yardstick of the
    tensor-core kernel.  No model path calls it."""
    if q.device.type != "cuda":
        raise ValueError(f"paged_prefill_attention_cuda_cores runs on cuda, not {q.device}")
    return _prefill_launch(q, k_pool, v_pool, block_tables, start, softcap=softcap, window=window, cuda_cores=True)


def paged_attention_quantized(
    q: torch.Tensor,  # (B, H, hd)
    k_pool: torch.Tensor,  # int8 / e4m3 (N, bs, KV, hd)
    v_pool: torch.Tensor,
    k_scale: torch.Tensor,  # fp32 (N, bs, KV, 1)
    v_scale: torch.Tensor,
    block_tables: torch.Tensor,
    seq_lens: torch.Tensor,
    *,
    softcap: float = 0.0,
    window: int = 0,
) -> torch.Tensor:
    """Decode over a quantized pool: the dequantizing plain version on
    every device (no kernel, as in the JAX package)."""
    return paged_attention_plain(
        q, k_pool, v_pool, block_tables, seq_lens, softcap=softcap, window=window, k_scale=k_scale, v_scale=v_scale
    )


def paged_prefill_attention_quantized(
    q: torch.Tensor,  # (B, C, H, hd)
    k_pool: torch.Tensor,  # int8 / e4m3 (N, bs, KV, hd)
    v_pool: torch.Tensor,
    k_scale: torch.Tensor,  # fp32 (N, bs, KV, 1)
    v_scale: torch.Tensor,
    block_tables: torch.Tensor,
    start: torch.Tensor,
    *,
    softcap: float = 0.0,
    window: int = 0,
) -> torch.Tensor:
    """Chunked prefill over a quantized pool: the dequantizing plain
    version on every device (no kernel, as in the JAX package)."""
    return paged_prefill_attention_plain(
        q, k_pool, v_pool, block_tables, start, softcap=softcap, window=window, k_scale=k_scale, v_scale=v_scale
    )
