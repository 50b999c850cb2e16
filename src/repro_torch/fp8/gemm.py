"""The FP8 GEMM (K4) on the card: wrapper of the hand-written CUDA kernel.

``kernels/csrc/fp8_gemm.cu`` is the Hopper counterpart of the JAX package's
Pallas ``fp8_gemm``: ``(a/a_scale) @ (b/b_scale)`` from fp8 operands, fp32
products and sums, fp32 output.  It is compiled with ``nvcc`` for ``sm_90a``
at first use into ``build/`` and loaded with ``ctypes`` (``kernels.build``).

The wrapper checks device, dtype, shape and strides, allocates the output
with ``torch.empty``, launches on the current stream and raises if the
launch failed.  Each operand is passed with its strides, so a transposed
view (``qw.T`` in the backward of ``fp8_dot``) costs no copy; one of its two
strides must be 1.  ``LAUNCHES["fp8_gemm"]`` counts launches; the wrapper
adds one where it launches, nowhere else.  For tensors on the CPU it calls
the plain version (``fp8.gemm_ref.fp8_gemm_plain``); for CUDA tensors it
launches the kernel or raises, and never falls back.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.fp8.gemm_ref import fp8_gemm_plain
from repro_torch.fp8.quantize import E4M3, E5M2
from repro_torch.kernels import build

SOURCE = "fp8_gemm.cu"  # under kernels/csrc

LAUNCHES = {"fp8_gemm": 0}


def reset_launches() -> None:
    LAUNCHES["fp8_gemm"] = 0


def _declare(lib) -> None:
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.fp8_gemm.argtypes = [p] * 5 + [i] * 3 + [ll] * 4 + [i] * 4 + [p]
    lib.fp8_gemm.restype = i


def _layout(t: torch.Tensor, name: str) -> tuple[int, int, bool]:
    """(stride of dim 0, stride of dim 1, 16-byte loads allowed) of a 2-D
    operand with one unit stride.  A dim of size 1 may take stride 1."""
    s0, s1 = t.stride()
    if t.shape[1] == 1:
        s1 = 1
    elif t.shape[0] == 1 and s1 != 1:
        s0 = 1
    if s1 != 1 and s0 != 1:
        raise ValueError(f"{name} strides {t.stride()}: one of them must be 1 (row- or column-major)")
    lead = s0 if s1 == 1 else s1
    vec = t.data_ptr() % 16 == 0 and lead % 16 == 0
    return s0, s1, vec


def fp8_gemm(
    a: torch.Tensor,  # (M, K) fp8
    b: torch.Tensor,  # (K, N) fp8
    a_scale: torch.Tensor,  # () fp32
    b_scale: torch.Tensor,  # () fp32
) -> torch.Tensor:
    """K4.  Returns ``(a/a_scale) @ (b/b_scale)``, (M, N) fp32."""
    if a.device.type == "cpu":
        return fp8_gemm_plain(a, b, a_scale, b_scale)
    if a.device.type != "cuda":
        raise ValueError(f"fp8_gemm runs on cuda or cpu, not {a.device}")
    for name, t in (("b", b), ("a_scale", a_scale), ("b_scale", b_scale)):
        if t.device != a.device:
            raise ValueError(f"{name} is on {t.device}, a on {a.device}")
    if a.dtype not in (E4M3, E5M2) or b.dtype not in (E4M3, E5M2):
        raise TypeError(f"operands {a.dtype}/{b.dtype}: need float8_e4m3fn or float8_e5m2")
    if a_scale.dtype != torch.float32 or b_scale.dtype != torch.float32 or a_scale.numel() != 1 or b_scale.numel() != 1:
        raise TypeError("scales must be one-element float32 tensors")
    if a.dim() != 2 or b.dim() != 2 or a.shape[1] != b.shape[0]:
        raise ValueError(f"shapes {tuple(a.shape)} @ {tuple(b.shape)}")
    (M, K), N = a.shape, b.shape[1]
    if max(M, N, K) >= 2**31:
        raise ValueError(f"dims {M, N, K} exceed int32")
    a_sm, a_sk, a_vec = _layout(a, "a")
    b_sk, b_sn, b_vec = _layout(b, "b")
    out = torch.empty((M, N), dtype=torch.float32, device=a.device)
    if M == 0 or N == 0:
        return out
    lib = build.load(SOURCE, _declare)
    rc = lib.fp8_gemm(
        a.data_ptr(), b.data_ptr(), a_scale.data_ptr(), b_scale.data_ptr(), out.data_ptr(),
        M, N, K, a_sm, a_sk, b_sk, b_sn, int(a.dtype == E5M2), int(b.dtype == E5M2),
        int(a_vec), int(b_vec), torch.cuda.current_stream(a.device).cuda_stream,
    )
    if rc != 0:
        raise RuntimeError(f"fp8_gemm launch failed: CUDA error {rc}")
    LAUNCHES["fp8_gemm"] += 1
    return out
