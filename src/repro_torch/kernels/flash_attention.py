"""Flash attention on the card: wrapper of the hand-written CUDA kernel (K3).

``csrc/flash_attention.cu`` is the Hopper counterpart of the JAX package's
Pallas ``flash_attention_bhsd``: the FlashAttention-2 forward with an fp32
online softmax, causal, sliding-window and softcap masks, and GQA.  It is
compiled with ``nvcc`` for ``sm_90a`` at first use into ``build/`` and
loaded with ``ctypes`` (``kernels.build``).

The kernel is chosen by the inputs' dtype alone (``ROUTES``): bf16 runs on
the tensor cores (``wgmma`` fed by TMA, P split into two bf16 terms so that
P.V keeps fp32-like accuracy); fp32 runs the first, CUDA-core kernel,
since ``wgmma`` would take fp32 only as tf32.  This is a dispatch, not a
fallback: a bf16 kernel that fails to build or launch raises.
``flash_attention_cuda_cores`` runs the CUDA-core kernel on either dtype;
no model path calls it: it is the yardstick the tensor-core kernel is timed
against.

Two entry points, as in the JAX package: ``flash_attention_bhsd`` on the
kernel's ``(B, H, S, hd)`` layout, and ``flash_attention`` on the model's
``(B, S, H, hd)`` layout.  The kernel takes every tensor with its batch,
head and sequence strides, so the model layout is passed as a transposed
view with no copy.

The wrapper checks device, dtype, shape and strides, allocates the output
with ``torch.empty``, launches on the current stream and raises if the
launch failed.  ``LAUNCHES["flash_attention"]`` counts launches of either
route, ``LAUNCHES["flash_attention_cuda_cores"]`` the yardstick's; each
wrapper adds one where it launches, nowhere else.  For tensors on the CPU it calls
the plain version (``flash_attention_ref``); for CUDA tensors it launches
the kernel or raises, and never falls back.

Forward only: the JAX package defines no gradient for this kernel.  With
grad mode on and an input that requires grad, both entry points raise
instead of taking a differentiable path.
"""

from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import build
from repro_torch.kernels.flash_attention_ref import flash_attention_plain

SOURCE = "flash_attention.cu"  # under kernels/csrc

LAUNCHES = {"flash_attention": 0, "flash_attention_cuda_cores": 0}

# the kernel each input dtype runs
ROUTES = {torch.bfloat16: "tensor_cores_bf16", torch.float32: "cuda_cores_fp32"}

MAX_SMEM = 232_448  # bytes of shared memory one H100 thread block may use


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _declare(lib) -> None:
    p, i, f, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_longlong
    lib.flash_attention_fwd.argtypes = [p] * 4 + [i] * 8 + [ll] * 12 + [f, i, i, f, p]
    lib.flash_attention_fwd.restype = i
    lib.flash_attention_smem_bytes.argtypes = [i, i]
    lib.flash_attention_smem_bytes.restype = ctypes.c_size_t


def _no_grad(*ts) -> None:
    if torch.is_grad_enabled() and any(t.requires_grad for t in ts):
        raise RuntimeError(
            "flash attention (K3) is forward only: the JAX package defines no gradient for it. "
            "Call it under torch.no_grad(), or use attn_impl='torch' to differentiate"
        )


def _check(q, k, v) -> None:
    for name, t in (("k", k), ("v", v)):
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
        if t.dtype != q.dtype:
            raise TypeError(f"{name} dtype {t.dtype} != q dtype {q.dtype}")
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"dtype {q.dtype}: need float32 or bfloat16")
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"shapes q {tuple(q.shape)}, k {tuple(k.shape)}, v {tuple(v.shape)}")
    B, H, Sq, hd = q.shape
    Bk, KV, Skv, hdk = k.shape
    if Bk != B or hdk != hd or KV == 0 or H % KV != 0:
        raise ValueError(f"q {tuple(q.shape)} does not fit k/v {tuple(k.shape)}")
    if Sq == 0 or Skv == 0:
        raise ValueError(f"empty sequence: Sq {Sq}, Skv {Skv}")
    if hd % 16 != 0 or not 16 <= hd <= 256:
        raise ValueError(f"head_dim {hd}: need a multiple of 16 in [16, 256]")
    if B > 65535 or H > 65535:
        raise ValueError(f"batch {B} or heads {H} exceed the grid")
    es = q.element_size()
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.stride(3) != 1:
            raise ValueError(f"{name} must be contiguous along head_dim")
        if t.data_ptr() % 16 or any((s * es) % 16 for s in t.stride()[:3]):
            raise ValueError(f"{name} rows must start on 16-byte boundaries (strides {t.stride()})")


def _launch(q, k, v, out, causal: bool, window: int, softcap: float, cuda_cores: bool = False) -> None:
    """Launch K3 on (B, H, S, hd) views; ``out`` is written in place.  The
    kernel follows the dtype (``ROUTES``); ``cuda_cores`` runs the CUDA-core
    kernel on either dtype."""
    B, H, Sq, hd = q.shape
    KV, Skv = k.shape[1], k.shape[2]
    lib = build.load(SOURCE, _declare)
    tensor_cores = q.dtype == torch.bfloat16 and not cuda_cores
    smem = lib.flash_attention_smem_bytes(hd, int(tensor_cores))
    if smem > MAX_SMEM:
        raise ValueError(f"head_dim {hd} needs {smem} B of shared memory (max {MAX_SMEM})")
    strides = [s for t in (q, k, v, out) for s in t.stride()[:3]]
    rc = lib.flash_attention_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B, H, KV, Sq, Skv, hd,
        int(q.dtype == torch.bfloat16), int(cuda_cores), *strides, 1.0 / math.sqrt(hd), int(causal),
        int(window), float(softcap), torch.cuda.current_stream(q.device).cuda_stream,
    )
    if rc != 0:
        why = "a TMA tensor map was refused" if rc == -1 else f"CUDA error {rc}"
        raise RuntimeError(f"flash_attention launch failed: {why}")
    LAUNCHES["flash_attention_cuda_cores" if cuda_cores else "flash_attention"] += 1


def flash_attention_bhsd(
    q: torch.Tensor,  # (B, H, Sq, hd)
    k: torch.Tensor,  # (B, KV, Skv, hd)
    v: torch.Tensor,
    *,
    causal: bool = True,
    window: int = 0,
    softcap: float = 0.0,
) -> torch.Tensor:
    """K3 on the kernel layout.  Returns (B, H, Sq, hd) in q's dtype."""
    _no_grad(q, k, v)
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal=causal, window=window, softcap=softcap)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention runs on cuda or cpu, not {q.device}")
    _check(q, k, v)
    out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    _launch(q, k, v, out, causal, window, softcap)
    return out


def flash_attention(
    q: torch.Tensor,  # (B, Sq, H, hd), the model layout
    k: torch.Tensor,  # (B, Skv, KV, hd)
    v: torch.Tensor,
    *,
    causal: bool = True,
    window: int = 0,
    softcap: float = 0.0,
) -> torch.Tensor:
    """K3 on the model layout.  Returns (B, Sq, H, hd) in q's dtype."""
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    if q.device.type != "cuda":
        return flash_attention_bhsd(qt, kt, vt, causal=causal, window=window, softcap=softcap).transpose(1, 2)
    _no_grad(q, k, v)
    _check(qt, kt, vt)
    out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    _launch(qt, kt, vt, out.transpose(1, 2), causal, window, softcap)
    return out


def flash_attention_cuda_cores(
    q: torch.Tensor,  # (B, H, Sq, hd), on the card
    k: torch.Tensor,  # (B, KV, Skv, hd)
    v: torch.Tensor,
    *,
    causal: bool = True,
    window: int = 0,
    softcap: float = 0.0,
) -> torch.Tensor:
    """The CUDA-core kernel on the kernel layout, bf16 or fp32: the yardstick
    of the tensor-core kernel.  No model path calls it."""
    _no_grad(q, k, v)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention_cuda_cores runs on cuda, not {q.device}")
    _check(q, k, v)
    out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    _launch(q, k, v, out, causal, window, softcap, cuda_cores=True)
    return out
