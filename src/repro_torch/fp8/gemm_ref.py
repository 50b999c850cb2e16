"""Plain PyTorch version of the FP8 GEMM (K4): upcast the fp8 operands to
fp32, multiply with fp32 accumulation, then scale by ``1/(sa*sb)``.

The CPU tests hold it against the JAX package's Pallas ``fp8_gemm``
(interpret mode), and on the card ``fp8.gemm`` holds the CUDA kernel
against it.  The JAX ``fp8_gemm_ref`` divides by ``sa*sb`` where the Pallas
kernel (and this version) multiplies by the reciprocal: the two differ by
at most one ulp.
"""

from __future__ import annotations

import torch


def fp8_gemm_plain(
    a: torch.Tensor,  # (M, K) fp8, any strides
    b: torch.Tensor,  # (K, N) fp8, any strides
    a_scale: torch.Tensor,  # () fp32
    b_scale: torch.Tensor,  # () fp32
) -> torch.Tensor:
    """Dequantizing GEMM: returns ``(a/a_scale) @ (b/b_scale)`` in fp32."""
    acc = a.float() @ b.float()
    return acc * (1.0 / (a_scale.float() * b_scale.float()))
