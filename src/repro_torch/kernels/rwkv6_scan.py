"""The RWKV6 WKV scan on the card: wrapper of the hand-written CUDA kernels (K5).

``csrc/rwkv6_scan.cu`` is the Hopper counterpart of the JAX package's
Pallas ``wkv6_chunked``: the chunked WKV recurrence with data-dependent
decay from a zero state, returning the outputs (not the final state).  It
is compiled with ``nvcc`` for ``sm_90a`` at first use into ``build/`` and
loaded with ``ctypes`` (``kernels.build``).

Two entry points, as in the JAX package: ``wkv6_chunked`` on the kernel's
``(B*H, S, n)`` layout with ``u`` of shape ``(B*H, n)``, and the op
``wkv6`` on the model's ``(B, S, H, n)`` layout with ``u`` of shape
``(H, n)`` (the JAX package's ``src/repro/kernels/rwkv6_scan_ops.py``).
The kernels take every operand with its batch, head and sequence strides,
so the model layout needs no copy.  Head size and chunk in {16, 32, 64};
S a multiple of the chunk.

For CUDA tensors both launch the chunk-parallel kernel: one block per
chunk computes the chunk's state term, takes its step of the walk of the
state over the chunks from the state the previous chunk's block publishes,
then the chunk's outputs; the products on the tensor cores with each fp32
operand split into two TF32 terms (the source's note; the numerics are
emulated by ``rwkv6_scan_ref.wkv6_chunked_split``).  A call allocates the
walk's scratch with ``torch``: a ring of two (n, n) states per (batch,
head), a ticket counter and a flag per (batch, head).
``wkv6_cuda_cores`` runs the first kernel (v1: one block per (batch,
head) walking its chunks, on the CUDA cores); no model path calls it: it
is the yardstick the chunk-parallel kernel is timed against.

The wrappers check device, dtype (fp32, as the model hands them over),
shape and strides, allocate the fp32 output, launch on the current stream
and raise if a launch failed.  ``LAUNCHES["rwkv6_scan"]`` counts calls of
the chunk-parallel K5, one a call whatever the launches inside it, and
``LAUNCHES["rwkv6_scan_cuda_cores"]`` v1's; a wrapper adds one where it
launches, nowhere else.  For tensors on the CPU ``wkv6`` and
``wkv6_chunked`` call the plain version (``rwkv6_scan_ref.wkv6_chunked_plain``);
for CUDA tensors they launch the kernels or raise, and never fall back.

Forward only, as in the JAX package, which defines no gradient for this
kernel: with grad mode on and an input that requires grad, the entry
points raise.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.kernels.rwkv6_scan_ref import wkv6_chunked_plain

SOURCE = "rwkv6_scan.cu"  # under kernels/csrc

LAUNCHES = {"rwkv6_scan": 0, "rwkv6_scan_cuda_cores": 0}

SIZES = (16, 32, 64)  # head sizes and chunks the kernel is built for


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _declare(lib) -> None:
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.wkv6_fwd.argtypes = [p] * 8 + [i] * 5 + [ll] * 17 + [p]
    lib.wkv6_fwd.restype = i
    lib.wkv6_fwd_cuda_cores.argtypes = [p] * 6 + [i] * 5 + [ll] * 17 + [p]
    lib.wkv6_fwd_cuda_cores.restype = i


def _no_grad(*ts) -> None:
    if torch.is_grad_enabled() and any(t.requires_grad for t in ts):
        raise RuntimeError(
            "the WKV scan kernel (K5) is forward only: the JAX package defines no gradient for it. "
            "Call it under torch.no_grad(), or use wkv_impl='chunked' to differentiate"
        )


def _on_cpu(r) -> bool:
    if r.device.type not in ("cuda", "cpu"):
        raise ValueError(f"the WKV scan runs on cuda or cpu, not {r.device}")
    return r.device.type == "cpu"


def _check(ts, u, chunk: int) -> None:
    """ts: r, k, v, logw as (B, H, S, n) views; u: (B, H, n) view."""
    r = ts[0]
    for t in (*ts, u):
        if t.device != r.device:
            raise ValueError(f"operands on {t.device} and {r.device}")
        if t.dtype != torch.float32:
            raise TypeError(f"dtype {t.dtype}: the kernel takes float32 operands")
        if t.stride(-1) != 1:
            raise ValueError("operands must be contiguous along the head size")
    B, H, S, n = r.shape
    if any(t.shape != r.shape for t in ts) or u.shape != (B, H, n):
        raise ValueError(f"shapes {[tuple(t.shape) for t in ts]}, u {tuple(u.shape)}")
    if n not in SIZES or chunk not in SIZES:
        raise ValueError(f"head size {n}, chunk {chunk}: the kernel is built for {SIZES}")
    if S % chunk:
        raise ValueError(f"S={S} is not a multiple of chunk={chunk}")


def _launch(ts, u, out, chunk: int, cuda_cores: bool = False) -> None:
    """Launch K5 on (B, H, S, n) views, the chunk-parallel kernel or, with
    ``cuda_cores``, v1; ``out`` is written in place."""
    r = ts[0]
    B, H, S, n = r.shape
    lib = build.load(SOURCE, _declare)
    strides = [s for t in (*ts, out) for s in t.stride()[:3]] + list(u.stride()[:2])
    ptrs = [t.data_ptr() for t in (*ts, u, out)]
    stream = torch.cuda.current_stream(r.device).cuda_stream
    if cuda_cores:
        rc = lib.wkv6_fwd_cuda_cores(*ptrs, B, H, S, n, chunk, *strides, stream)
    else:  # the walk's scratch: a ring of two states per (batch, head), a ticket counter and flags
        ring = torch.empty((B * H, 2, n, n), dtype=torch.float32, device=r.device)
        sync = torch.zeros((1 + B * H,), dtype=torch.int32, device=r.device)
        rc = lib.wkv6_fwd(*ptrs, ring.data_ptr(), sync.data_ptr(), B, H, S, n, chunk, *strides, stream)
    if rc != 0:
        raise RuntimeError(f"rwkv6_scan launch failed: CUDA error {rc}")
    LAUNCHES["rwkv6_scan_cuda_cores" if cuda_cores else "rwkv6_scan"] += 1


def wkv6_chunked(r, k, v, logw, u, *, chunk: int = 64) -> torch.Tensor:
    """K5 on the kernel layout.  r, k, v, logw: (BH, S, n); u: (BH, n).
    Returns (BH, S, n) fp32."""
    _no_grad(r, k, v, logw, u)
    BH, S, n = r.shape
    assert S % chunk == 0, (S, chunk)
    if _on_cpu(r):
        return wkv6_chunked_plain(r, k, v, logw, u, chunk=chunk)
    ts = [t[:, None] for t in (r, k, v, logw)]  # (BH, 1, S, n)
    _check(ts, u[:, None], chunk)
    out = torch.empty((BH, S, n), dtype=torch.float32, device=r.device)
    _launch(ts, u[:, None], out[:, None], chunk)
    return out


def wkv6(r, k, v, logw, u, *, chunk: int = 64) -> torch.Tensor:
    """K5 on the model layout.  r, k, v, logw: (B, S, H, n); u: (H, n).
    Returns (B, S, H, n) fp32."""
    _no_grad(r, k, v, logw, u)
    B, S, H, n = r.shape
    ub = u.expand(B, H, n)
    if _on_cpu(r):
        to_bh = lambda x: x.transpose(1, 2).reshape(B * H, S, n)  # noqa: E731
        out = wkv6_chunked(*(to_bh(x) for x in (r, k, v, logw)), ub.reshape(B * H, n), chunk=chunk)
        return out.reshape(B, H, S, n).transpose(1, 2)
    assert S % chunk == 0, (S, chunk)
    ts = [t.transpose(1, 2) for t in (r, k, v, logw)]  # (B, H, S, n) views
    _check(ts, ub, chunk)
    out = torch.empty((B, S, H, n), dtype=torch.float32, device=r.device)
    _launch(ts, ub, out.transpose(1, 2), chunk)
    return out


def wkv6_cuda_cores(r, k, v, logw, u, *, chunk: int = 64) -> torch.Tensor:
    """v1 on the model layout, as ``wkv6``: the yardstick of the
    chunk-parallel kernel.  CUDA tensors only; no model path calls it."""
    _no_grad(r, k, v, logw, u)
    if r.device.type != "cuda":
        raise ValueError(f"wkv6_cuda_cores runs on cuda, not {r.device}")
    B, S, H, n = r.shape
    ub = u.expand(B, H, n)
    ts = [t.transpose(1, 2) for t in (r, k, v, logw)]
    _check(ts, ub, chunk)
    out = torch.empty((B, S, H, n), dtype=torch.float32, device=r.device)
    _launch(ts, ub, out.transpose(1, 2), chunk, cuda_cores=True)
    return out
