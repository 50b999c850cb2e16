"""The FP8 GEMM (K4) on the card: wrapper of the hand-written CUDA kernel.

``kernels/csrc/fp8_gemm.cu`` is the Hopper counterpart of the JAX package's
Pallas ``fp8_gemm``: ``(a/a_scale) @ (b/b_scale)`` from fp8 operands, exact
products, fp32 sums, fp32 output, on the tensor cores (TMA loads, ``wgmma``).
It is compiled with ``nvcc`` for ``sm_90a`` at first use into ``build/`` and
loaded with ``ctypes`` (``kernels.build``).

The kernel reads each operand K-major: ``a`` as (M, K) and ``b`` as (N, K),
rows a multiple of 16 bytes apart.  ``layout_plan`` says whether an operand
is already stored so; where it is not (``qw`` in the forward of ``fp8_dot``,
both operands of its weight gradient, a K not a multiple of 16), the
wrapper makes a K-major copy, padded in K to a multiple of 16
(``kmajor_copy``; ``LAUNCHES["fp8_layout_copy"]`` counts them).  The kernel
never reads the padding: its loads stop at K.

The wrapper checks device, dtype and shape, allocates the output with
``torch.empty``, launches on the current stream and raises if the launch
failed.  ``LAUNCHES["fp8_gemm"]`` counts launches; the wrapper adds one
where it launches, nowhere else.  For tensors on the CPU it calls the plain
version (``fp8.gemm_ref.fp8_gemm_plain``) on the operands as given, with no
copy; for CUDA tensors it launches the kernel or raises, and never falls
back.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.fp8.gemm_ref import fp8_gemm_plain
from repro_torch.fp8.quantize import E4M3, E5M2
from repro_torch.kernels import build

SOURCE = "fp8_gemm.cu"  # under kernels/csrc

LAUNCHES = {"fp8_gemm": 0, "fp8_layout_copy": 0}

ALIGN = 16  # bytes: TMA's rule for global strides and base addresses


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _declare(lib) -> None:
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.fp8_gemm.argtypes = [p] * 5 + [i] * 3 + [ll] * 2 + [i] * 2 + [p]
    lib.fp8_gemm.restype = i


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def layout_plan(t: torch.Tensor, k_dim: int) -> tuple[bool, int]:
    """For a 2-D fp8 operand whose dim ``k_dim`` is K: (whether the kernel
    needs a K-major copy of it, the leading dimension in elements of what
    the kernel reads).  The operand is read as it is when its K stride is 1
    (or K is 1) and its other stride is at least K and a multiple of 16
    bytes, from a 16-byte aligned base; otherwise the copy has K padded to a
    multiple of 16."""
    K, rows = t.shape[k_dim], t.shape[1 - k_dim]
    s_k, s_rows = t.stride(k_dim), t.stride(1 - k_dim)
    lead = _round_up(K, ALIGN)
    if rows == 1:  # a single row: its stride is never used
        s_rows = lead
    k_major = s_k == 1 or K == 1
    if k_major and s_rows >= K and s_rows % ALIGN == 0 and t.data_ptr() % ALIGN == 0:
        return False, s_rows
    return True, lead


def kmajor_copy(t: torch.Tensor, k_dim: int, lead: int) -> torch.Tensor:
    """A (rows, lead) copy of the operand with K along dim 1 and the
    elements past K left unset.  ``[:, :K]`` of it holds the operand."""
    K, rows = t.shape[k_dim], t.shape[1 - k_dim]
    with torch.profiler.record_function("fp8_layout_copy"):  # a profile's span of the copies
        out = torch.empty((rows, lead), dtype=t.dtype, device=t.device)
        out[:, :K].copy_(t if k_dim == 1 else t.T)
    LAUNCHES["fp8_layout_copy"] += 1
    return out


def _kmajor(t: torch.Tensor, k_dim: int) -> tuple[torch.Tensor, int]:
    """(tensor whose data_ptr starts the K-major storage, leading dim)."""
    copy, lead = layout_plan(t, k_dim)
    return (kmajor_copy(t, k_dim, lead), lead) if copy else (t, lead)


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
    out = torch.empty((M, N), dtype=torch.float32, device=a.device)
    if M == 0 or N == 0:
        return out
    if K == 0:
        return out.zero_()
    ak, lda = _kmajor(a, 1)
    bk, ldb = _kmajor(b, 0)
    lib = build.load(SOURCE, _declare)
    rc = lib.fp8_gemm(
        ak.data_ptr(), bk.data_ptr(), a_scale.data_ptr(), b_scale.data_ptr(), out.data_ptr(),
        M, N, K, lda, ldb, int(a.dtype == E5M2), int(b.dtype == E5M2),
        torch.cuda.current_stream(a.device).cuda_stream,
    )
    if rc == -1:
        raise RuntimeError(f"fp8_gemm: cuTensorMapEncodeTiled refused a tensor map (lda {lda}, ldb {ldb})")
    if rc != 0:
        raise RuntimeError(f"fp8_gemm launch failed: CUDA error {rc}")
    LAUNCHES["fp8_gemm"] += 1
    return out
