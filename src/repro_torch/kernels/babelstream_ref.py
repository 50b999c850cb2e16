"""Plain PyTorch versions of the BabelStream kernels (K6).

The JAX package's ``kernels/babelstream_ref.py`` and the bodies of its
Pallas kernels (``kernels/babelstream.py``), on 1-D tensors.  The CPU tests
hold them against the Pallas kernels in interpret mode, bit for bit; on the
card ``kernels.babelstream`` holds the CUDA kernels against them.

The scalar of ``mul`` and ``triad`` is rounded to the array's dtype before
it multiplies, as JAX rounds a weakly typed Python float: in bf16,
``0.4 * c`` is ``bf16(0.4) * c``, rounded once, and ``b + s * c`` rounds the
product and then the sum.  PyTorch's own ``0.4 * c`` multiplies by the
unrounded scalar (and ``torch.add(b, c, alpha=0.4)`` fuses the two), which
gives other bf16 results on about one element in ten.
"""

from __future__ import annotations

import torch

DEFAULT_BLOCK = 65_536  # elements per tile of the JAX kernels (and per dot partial)


def round_scalar(scalar: float, dtype: torch.dtype) -> float:
    """``scalar`` rounded to ``dtype``.  PyTorch multiplies a bf16 or fp32
    tensor by a Python float in fp32, which holds the rounded value exactly,
    so ``round_scalar(s, c.dtype) * c`` rounds once, as JAX's ``s * c``."""
    return float(torch.tensor(scalar, dtype=dtype))


def copy_ref(a: torch.Tensor) -> torch.Tensor:
    return a.clone()


def mul_ref(c: torch.Tensor, scalar: float = 0.4) -> torch.Tensor:
    return round_scalar(scalar, c.dtype) * c


def add_ref(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return a + b


def triad_ref(b: torch.Tensor, c: torch.Tensor, scalar: float = 0.4) -> torch.Tensor:
    """bf16: the product rounded, then the sum.  fp32: one fused
    multiply-add, rounded once, as XLA compiles the JAX kernel's
    ``b + scalar * c`` (two PyTorch ops would round twice and differ on
    about one element in five)."""
    s = round_scalar(scalar, c.dtype)
    if c.dtype == torch.float32:
        return fma_f32(s, c, b)
    return b + s * c


def fma_f32(s: float, c: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """fp32 ``s * c + b`` rounded once.  The product is exact in float64 (24
    by 24 bits).  The float64 sum is made round-to-odd: where TwoSum finds
    it inexact and its last bit is even, it moves one float64 step towards
    the exact value.  Rounding a round-to-odd value with 29 more bits than
    fp32 to the nearest fp32 is correct, where a plain float64 sum would
    round twice."""
    p = c.double() * s
    bd = b.double()
    t = bd + p
    bv = t - bd
    err = (bd - (t - bv)) + (p - bv)  # t + err == bd + p exactly (Knuth's TwoSum)
    even = (t.view(torch.int64) & 1) == 0
    away = torch.where(err > 0, torch.inf, -torch.inf).to(t.dtype)
    t = torch.where((err != 0) & even, torch.nextafter(t, away), t)
    return t.float()


def dot_ref(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """sum(a * b) in fp32: a () fp32 tensor."""
    return torch.sum(a.float() * b.float())


def dot_partials_ref(a: torch.Tensor, b: torch.Tensor, block: int = DEFAULT_BLOCK) -> torch.Tensor:
    """The fp32 partial sum of each ``block``-element tile, as the Pallas
    ``_dot_kernel`` writes them: (n // block,)."""
    return (a.float() * b.float()).reshape(-1, block).sum(dim=1)


def stream_bytes(kernel: str, n: int, itemsize: int) -> int:
    """Device-memory bytes moved per kernel invocation (BabelStream convention)."""
    mult = {"copy": 2, "mul": 2, "add": 3, "triad": 3, "dot": 2}[kernel]
    return mult * n * itemsize
