"""BabelStream on the card: wrappers of the hand-written CUDA kernels (K6).

``csrc/babelstream.cu`` is the Hopper counterpart of the JAX package's
Pallas BabelStream kernels (``kernels/babelstream.py``): copy, mul, add,
triad and dot over 1-D arrays, the memory-bandwidth benchmark behind the
paper's Fig. 10.  It is compiled with ``nvcc`` for ``sm_90a`` at first use
into ``build/`` and loaded with ``ctypes`` (``kernels.build``).

The wrappers keep the JAX signatures (``scalar=0.4``, ``block``) and its
``n % block == 0`` rule; ``block`` is the tile of the Pallas grid, and on
the card only ``stream_dot`` uses it (one fp32 partial per tile, summed
here, as the JAX package sums its partials outside the kernel).  fp32 and
bf16; the scalar is rounded to the array's dtype first (see
``babelstream_ref``), so copy, mul, add and triad are bit-equal to the plain
versions.

Each wrapper checks device, dtype, shape and alignment, allocates its
output with ``torch.empty``, launches on the current stream and raises if
the launch failed.  ``LAUNCHES["stream_<name>"]`` counts launches; a wrapper
adds one where it launches, nowhere else.  For tensors on the CPU it calls
the plain version; for CUDA tensors it launches the kernel or raises, and
never falls back.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.kernels.babelstream_ref import (
    DEFAULT_BLOCK,
    add_ref,
    copy_ref,
    dot_partials_ref,
    mul_ref,
    round_scalar,
    stream_bytes,
    triad_ref,
)

SOURCE = "babelstream.cu"  # under kernels/csrc

NAMES = ("copy", "mul", "add", "triad", "dot")
LAUNCHES = {f"stream_{n}": 0 for n in NAMES}
_OPS = {"copy": 0, "mul": 1, "add": 2, "triad": 3}

__all__ = [
    "DEFAULT_BLOCK",
    "LAUNCHES",
    "reset_launches",
    "stream_add",
    "stream_bytes",
    "stream_copy",
    "stream_dot",
    "stream_mul",
    "stream_triad",
]


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _declare(lib) -> None:
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.stream_run.argtypes = [i, i, p, p, p, ll, ctypes.c_float, p]
    lib.stream_run.restype = i
    lib.stream_dot_partials.argtypes = [i, p, p, p, ll, ll, p]
    lib.stream_dot_partials.restype = i


def _on_cpu(*ts) -> bool:
    """True for CPU tensors; raises for a device that is neither."""
    dev = ts[0].device
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"BabelStream runs on cuda or cpu, not {dev}")
    for t in ts[1:]:
        if t.device != dev:
            raise ValueError(f"operands on {t.device} and {dev}")
    return dev.type == "cpu"


def _check(*ts) -> None:
    """The kernels' terms: 1-D, one dtype (fp32 or bf16), one length,
    contiguous, 16-byte aligned and a whole number of 16-byte chunks."""
    a = ts[0]
    if a.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"dtype {a.dtype}: need float32 or bfloat16")
    for t in ts:
        if t.dim() != 1 or t.shape != a.shape or t.dtype != a.dtype:
            raise ValueError(f"operands {[(tuple(x.shape), x.dtype) for x in ts]}: need 1-D arrays of one shape and dtype")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError("operands must be contiguous and start on a 16-byte boundary")
    if (a.numel() * a.element_size()) % 16:
        raise ValueError(f"n={a.numel()}: need a multiple of {16 // a.element_size()} elements")


def _grid_1d(n: int, block: int) -> None:
    assert n % block == 0, (n, block)


def launch_map(op: str, x: torch.Tensor, y: torch.Tensor | None, scalar: float) -> torch.Tensor:
    """Launch one of copy/mul/add/triad on CUDA tensors.  ``scalar`` is
    passed to the kernel as it is: the wrappers round it to the dtype first."""
    ts = (x,) if y is None else (x, y)
    _check(*ts)
    out = torch.empty_like(x)
    lib = build.load(SOURCE, _declare)
    rc = lib.stream_run(
        _OPS[op], int(x.dtype == torch.bfloat16), x.data_ptr(), None if y is None else y.data_ptr(),
        out.data_ptr(), x.numel(), float(scalar), torch.cuda.current_stream(x.device).cuda_stream,
    )
    if rc != 0:
        raise RuntimeError(f"stream_{op} launch failed: CUDA error {rc}")
    LAUNCHES[f"stream_{op}"] += 1
    return out


def stream_copy(a: torch.Tensor, *, block: int = DEFAULT_BLOCK) -> torch.Tensor:
    """c = a."""
    _grid_1d(a.shape[0], block)
    if _on_cpu(a):
        return copy_ref(a)
    return launch_map("copy", a, None, 0.0)


def stream_mul(c: torch.Tensor, scalar: float = 0.4, *, block: int = DEFAULT_BLOCK) -> torch.Tensor:
    """b = scalar * c, the scalar rounded to c's dtype."""
    _grid_1d(c.shape[0], block)
    if _on_cpu(c):
        return mul_ref(c, scalar)
    return launch_map("mul", c, None, round_scalar(scalar, c.dtype))


def stream_add(a: torch.Tensor, b: torch.Tensor, *, block: int = DEFAULT_BLOCK) -> torch.Tensor:
    """c = a + b."""
    _grid_1d(a.shape[0], block)
    if _on_cpu(a, b):
        return add_ref(a, b)
    return launch_map("add", a, b, 0.0)


def stream_triad(b: torch.Tensor, c: torch.Tensor, scalar: float = 0.4, *, block: int = DEFAULT_BLOCK) -> torch.Tensor:
    """a = b + scalar * c, the scalar rounded to the dtype; in bf16 the
    product is rounded before the sum, in fp32 it is one fused
    multiply-add (see ``babelstream_ref.triad_ref``)."""
    _grid_1d(b.shape[0], block)
    if _on_cpu(b, c):
        return triad_ref(b, c, scalar)
    return launch_map("triad", b, c, round_scalar(scalar, c.dtype))


def dot_partials(a: torch.Tensor, b: torch.Tensor, *, block: int = DEFAULT_BLOCK) -> torch.Tensor:
    """The fp32 partial sums of fp32(a) * fp32(b), one per ``block``-element
    tile: (n // block,)."""
    _grid_1d(a.shape[0], block)
    if _on_cpu(a, b):
        return dot_partials_ref(a, b, block)
    _check(a, b)
    if (block * a.element_size()) % 16:
        raise ValueError(f"block={block}: need a multiple of {16 // a.element_size()} elements")
    partials = torch.empty(a.shape[0] // block, dtype=torch.float32, device=a.device)
    lib = build.load(SOURCE, _declare)
    rc = lib.stream_dot_partials(
        int(a.dtype == torch.bfloat16), a.data_ptr(), b.data_ptr(), partials.data_ptr(), a.numel(), block,
        torch.cuda.current_stream(a.device).cuda_stream,
    )
    if rc != 0:
        raise RuntimeError(f"stream_dot launch failed: CUDA error {rc}")
    LAUNCHES["stream_dot"] += 1
    return partials


def stream_dot(a: torch.Tensor, b: torch.Tensor, *, block: int = DEFAULT_BLOCK) -> torch.Tensor:
    """sum(fp32(a) * fp32(b)): a () fp32 tensor, the sum of the per-tile
    partials."""
    return torch.sum(dot_partials(a, b, block=block))
