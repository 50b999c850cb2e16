"""FP8 cast/dequant, per-tensor scales, delayed scaling, and ``fp8_dot``.

The JAX package's ``fp8/quantize.py`` in PyTorch.  The recipe (Micikevicius
et al., arXiv:2209.05433, as Transformer Engine runs it):

* **e4m3** for forward tensors (activations and weights), max-normal 448;
* **e5m2** for gradients, max-normal 57344;
* **per-tensor scales**: ``q = cast(clip(x * scale))``, ``x ~= q / scale``
  with ``scale = fp8_max / (2^margin * amax)``;
* **delayed scaling**: the scale used at step *t* comes from an amax history
  of earlier steps (``Fp8State``); gradients are scaled just in time.

``quantize`` is bit-identical to the reference's: multiply in fp32, clip to
the format's max (the cast of an out-of-range value is not saturating),
then narrow with round-to-nearest-even.
"""

from __future__ import annotations

from typing import Any, NamedTuple

import torch

from repro_torch.device import resolve_device

E4M3 = torch.float8_e4m3fn
E5M2 = torch.float8_e5m2

FP8_DTYPES = {"e4m3": E4M3, "e5m2": E5M2}
FP8_MAX = {E4M3: 448.0, E5M2: 57344.0}

_AMAX_EPS = 1e-12  # guards the 0-amax (never-observed) scale


def compute_scale(amax: torch.Tensor, dtype, margin: float = 0.0) -> torch.Tensor:
    """Scale that maps [-amax, amax] onto the FP8 window (minus 2^margin headroom)."""
    amax = torch.clamp(amax.float(), min=_AMAX_EPS)
    # a true division: ``float / tensor`` would multiply by the reciprocal
    return torch.div(torch.full_like(amax, FP8_MAX[dtype]), amax * (2.0**margin))


def quantize(x: torch.Tensor, scale: torch.Tensor, dtype=E4M3) -> torch.Tensor:
    """Saturating cast to FP8: clip(x * scale) in fp32, then narrow."""
    m = FP8_MAX[dtype]
    return torch.clamp(x.float() * scale, -m, m).to(dtype)


def dequantize(q: torch.Tensor, scale: torch.Tensor, dtype=torch.float32) -> torch.Tensor:
    return (q.float() / scale).to(dtype)


def tensor_amax(x: torch.Tensor) -> torch.Tensor:
    """Observed absolute max as a () fp32 tensor, detached (amaxes steer
    scales, not gradients)."""
    return x.detach().abs().amax().float()


# ---------------------------------------------------------------------------
# delayed-scaling state
# ---------------------------------------------------------------------------


class Fp8State(NamedTuple):
    """Per-tensor delayed-scaling state, carried in ``TrainState``.

    ``amax_history``: dict site-key -> (num_layers, window) fp32, newest
    observation first along the window.  ``scale``: dict site-key ->
    (num_layers,) fp32, the scales to use at the next step.  ``step``: ()
    int32, the number of updates applied.
    """

    amax_history: Any
    scale: Any
    step: torch.Tensor


def init_fp8_state(keys: list[str], window: int, num_layers: int = 1, device=None) -> Fp8State:
    """Zero amax windows and unit scales for ``keys``, on the card unless
    ``device`` says otherwise (``None``: the card, raising without one)."""
    device = resolve_device(device)
    return Fp8State(
        amax_history={k: torch.zeros((num_layers, window), dtype=torch.float32, device=device) for k in keys},
        scale={k: torch.ones((num_layers,), dtype=torch.float32, device=device) for k in keys},
        step=torch.zeros((), dtype=torch.int32, device=device),
    )


def update_fp8_state(state: Fp8State, amaxes: dict, dtype=E4M3, margin: float = 0.0) -> Fp8State:
    """Roll each site's amax window and recompute its per-layer scales.

    ``amaxes``: dict site-key -> (num_layers,) fp32 observed this step (a
    site that was not exercised reports 0 and simply ages the window).
    Returns a new state; the old one is left as it was.
    """

    def roll(hist, obs):
        obs = torch.broadcast_to(obs.float(), (hist.shape[0],))
        return torch.cat([obs[:, None], hist[:, :-1]], dim=1)

    new_hist = {k: roll(state.amax_history[k], amaxes[k]) for k in state.amax_history}
    new_scale = {k: compute_scale(torch.amax(h, dim=1), dtype, margin) for k, h in new_hist.items()}
    return Fp8State(amax_history=new_hist, scale=new_scale, step=state.step + 1)


# ---------------------------------------------------------------------------
# FP8 matmul with straight-through quantization gradients
# ---------------------------------------------------------------------------


class _Fp8Dot(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, x_scale, w_scale, fwd_dtype, gemm_fn, amax_reduce):
        qx = quantize(x, x_scale, fwd_dtype)
        qw = quantize(w, w_scale, fwd_dtype)
        ctx.save_for_backward(qx, qw, x_scale, w_scale)
        ctx.gemm_fn = gemm_fn
        ctx.amax_reduce = amax_reduce
        ctx.dtypes = (x.dtype, w.dtype)
        return gemm_fn(qx, qw, x_scale, w_scale)

    @staticmethod
    def backward(ctx, g):
        """Backward GEMMs in e5m2 with current (just-in-time) scaling.

        dx = g @ w^T and dw = x^T @ g reuse the *quantized* forward operands,
        the values the forward consumed, so the quantization gradient is
        straight-through (saturation included).  The transposes are views:
        the GEMM takes each operand with its strides.  Where ``g`` is one
        rank's shard of the gradient (sharded training), ``amax_reduce``
        takes its amax to the whole tensor's.
        """
        qx, qw, sx, sw = ctx.saved_tensors
        x_dtype, w_dtype = ctx.dtypes
        amax = tensor_amax(g)
        if ctx.amax_reduce is not None:
            amax = ctx.amax_reduce(amax)
        g_scale = compute_scale(amax, E5M2)
        qg = quantize(g, g_scale, E5M2)
        dx = ctx.gemm_fn(qg, qw.T, g_scale, sw).to(x_dtype)
        dw = ctx.gemm_fn(qx.T, qg, sx, g_scale).to(w_dtype)
        return dx, dw, None, None, None, None, None


def fp8_dot(x, w, x_scale, w_scale, fwd_dtype, gemm_fn, amax_reduce=None) -> torch.Tensor:
    """``x @ w`` through the FP8 path: quantize both operands with the given
    (delayed) scales, run the fp32-accumulating FP8 GEMM, dequantize.

    x: (M, K), w: (K, N); returns (M, N) fp32.  ``gemm_fn`` is one of the
    port's FP8 GEMMs (``fp8.gemm.fp8_gemm``, the kernel, or
    ``fp8.gemm_ref.fp8_gemm_plain``) with signature
    ``(a_q, b_q, a_scale, b_scale) -> fp32``.  Differentiable in x and w;
    the scales get no gradient.  ``amax_reduce`` (sharded training): maps
    the amax of the backward's local gradient to the whole gradient's, so
    every rank scales it alike (``parallel.collectives.all_reduce_max``).
    """
    return _Fp8Dot.apply(x, w, x_scale, w_scale, fwd_dtype, gemm_fn, amax_reduce)
