"""Quantized KV cache: int8 and fp8 (e4m3) rows with per-(token, head) scales.

The JAX package's ``serving/kvquant.py`` in PyTorch (KIVI-style,
arXiv:2402.02750)::

    k_q[..., s, h, :] = round(k[..., s, h, :] / scale),  scale = amax / 127

Paged pools (``InferenceEngine(quantize_kv=...)``) use ``quantize`` at every
write site (chunk scatter, decode, speculative verify), storing quantized
``k``/``v`` blocks with fp32 per-(token, head) scales in sibling
``k_scale``/``v_scale`` pool leaves; the block-table ops in
``serving.kvcache`` move scale rows together with their data rows.

Two block dtypes share the layout and the dequantizing read path
(``pool.float() * scale`` in ``kernels.paged_attention_ref``):

* ``"int8"``: symmetric round-to-nearest, scale = amax / 127.
* ``"fp8"``: e4m3 saturating cast, scale = amax / 448.  The same bytes as
  int8 on a nonuniform grid: finer near zero, coarser at the amax edge.

``quantize`` is bit-equal to the JAX package's: fp32 arithmetic, a true
division by the scale, ``torch.round`` (half to even, as ``jnp.round``)
then a clip for int8, a clip to +-448 before the e4m3 cast (which is not
saturating) for fp8.  Quantized pools have no kernel, in the JAX package
as here: they read through the plain dequantizing path on every device.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

E4M3 = torch.float8_e4m3fn
E4M3_MAX = 448.0

KV_QUANT_MODES = ("int8", "fp8")
_STORAGE_DTYPES = {"int8": torch.int8, "fp8": E4M3}


def normalize_kv_quant(mode) -> str | None:
    """Engine knob -> canonical mode string (``True`` means int8)."""
    if not mode:
        return None
    if mode is True:
        return "int8"
    if mode not in KV_QUANT_MODES:
        raise ValueError(f"quantize_kv must be one of {KV_QUANT_MODES}, got {mode!r}")
    return mode


def kv_storage_dtype(mode) -> torch.dtype:
    return _STORAGE_DTYPES[normalize_kv_quant(mode)]


def kv_quant_mode_of(dtype) -> str | None:
    """Mode implied by a pool's storage dtype (None for unquantized pools)."""
    for mode, dt in _STORAGE_DTYPES.items():
        if dtype == dt:
            return mode
    return None


def is_quantized_kv(dtype) -> bool:
    """True when a pool dtype carries sibling scale leaves (int8 or fp8)."""
    return kv_quant_mode_of(dtype) is not None


class QuantizedKV(NamedTuple):
    k_q: torch.Tensor  # int8/e4m3, same shape as k
    k_scale: torch.Tensor  # fp32 (..., seq, heads, 1)
    v_q: torch.Tensor
    v_scale: torch.Tensor


def quantize(x: torch.Tensor, mode: str = "int8") -> tuple[torch.Tensor, torch.Tensor]:
    """Per-(token, head) symmetric quantize.  x: (..., seq, heads, head_dim).

    Returns ``(q, scale)`` with dequant = ``q.float() * scale``, so every
    consumer (the plain reads, the spill tier, COW copies) is mode-agnostic.
    No host work: a CUDA graph can capture it."""
    xf = x.float()
    top = E4M3_MAX if mode == "fp8" else 127.0
    scale = torch.clamp(torch.amax(torch.abs(xf), dim=-1, keepdim=True) / top, min=1e-8)
    if mode == "fp8":
        # the e4m3 cast maps out-of-range values to NaN: clip first
        return torch.clamp(xf / scale, -E4M3_MAX, E4M3_MAX).to(E4M3), scale
    return torch.clamp(torch.round(xf / scale), -127, 127).to(torch.int8), scale


def dequantize(q: torch.Tensor, scale: torch.Tensor, dtype=torch.bfloat16) -> torch.Tensor:
    return (q.float() * scale).to(dtype)


def quantize_cache(k: torch.Tensor, v: torch.Tensor) -> QuantizedKV:
    k_q, k_s = quantize(k)
    v_q, v_s = quantize(v)
    return QuantizedKV(k_q, k_s, v_q, v_s)


def cache_bytes(kv: QuantizedKV) -> int:
    return sum(a.numel() * a.element_size() for a in kv)


def attend_quantized(cfg, q: torch.Tensor, kv: QuantizedKV, mask: torch.Tensor) -> torch.Tensor:
    """Plain decode attention over a quantized cache.

    q: (B, 1, H, hd); kv arrays: (B, W, KV, hd); mask: (B, 1, 1, 1, W).
    Returns (B, 1, H, hd)."""
    from repro_torch.models.attention import _attend_block

    k = dequantize(kv.k_q, kv.k_scale, q.dtype)
    v = dequantize(kv.v_q, kv.v_scale, q.dtype)
    return _attend_block(cfg, q, k, v, mask)


def memory_saving(seq: int, kv_heads: int, head_dim: int, layers: int, batch: int, from_dtype_bytes: int = 2) -> dict:
    """Bytes of one decode step's K/V reads, unquantized against int8 + fp32
    scales (global, per step)."""
    base = 2 * layers * batch * seq * kv_heads * head_dim * from_dtype_bytes
    quant = 2 * layers * batch * seq * kv_heads * (head_dim * 1 + 4)  # int8 + fp32 scale
    return {"bf16_bytes": base, "int8_bytes": quant, "ratio": base / quant}
