"""Which matmuls run FP8, and the per-forward quantization context.

The JAX package's ``fp8/policy.py`` in PyTorch.  Policy: the big projection
GEMMs of every block (attention q/k/v/o, FFN up/gate/down) run FP8; logits,
norms, softmax, embeddings and the residual stream stay on the
mixed-precision path.

``Fp8Ctx`` bridges the model functions and the delayed-scaling state.  The
forward's layer loop calls ``bind_layer_scales(layer)`` before each block;
it returns the handle (``Fp8Layer``) the block's projections call, holding
that layer's scale slice, and opens the layer for observation.  After the
block the loop calls ``drain()``, which closes the layer and returns its
amaxes.  The handle carries its layer explicitly because the port
recomputes blocks with ``torch.utils.checkpoint``: the recompute in the
backward calls ``matmul`` again, long after the layer was drained.  It then
uses the same scales and records nothing, so each layer's amaxes come from
its original forward alone and never mix with another layer's.  (The JAX
package drains observations as scan outputs, so its remat cannot
double-count them.)
"""

from __future__ import annotations

import torch

from repro_torch.fp8 import gemm, gemm_ref
from repro_torch.fp8.quantize import FP8_DTYPES, Fp8State, fp8_dot, init_fp8_state, tensor_amax
from repro_torch.models.ffn import is_gated

SUPPORTED_FAMILIES = ("dense", "audio", "moe", "hybrid")

ATTN_SITES = ("attn_q", "attn_k", "attn_v", "attn_o")
FFN_SITES = ("ffn_up", "ffn_gate", "ffn_down")

GEMM_IMPLS = {
    "kernel": gemm.fp8_gemm,
    "plain": gemm_ref.fp8_gemm_plain,
}


def fp8_supported(cfg) -> bool:
    return cfg.family in SUPPORTED_FAMILIES


def fp8_peak_applies(cfg) -> bool:
    """Whether a roofline should cost this arch's fp8 run at the FP8 peak.

    Only when the quantized sites carry the *dominant* GEMM FLOPs: moe is
    excluded, since its routed expert FFNs (the bulk of active FLOPs) stay
    bf16, so costing the whole cell at 2x would understate compute_s by
    about 2x.
    """
    return fp8_supported(cfg) and cfg.family != "moe"


def fp8_sites(cfg) -> list[str]:
    """GEMM sites quantized for this architecture (stable order: the site
    list fixes the ``Fp8State`` structure)."""
    sites: list[str] = []
    if cfg.has_attention:
        sites += list(ATTN_SITES)
    uses_dense_ffn = cfg.family != "moe" or (cfg.moe is not None and cfg.moe.dense_residual)
    if cfg.family in SUPPORTED_FAMILIES and uses_dense_ffn:
        for s in FFN_SITES:
            if s == "ffn_gate" and not is_gated(cfg.activation):
                continue
            sites.append(s)
    return sites


def scale_keys(cfg) -> list[str]:
    """One delayed scale per GEMM operand: ``<site>/x`` and ``<site>/w``."""
    return [f"{s}/{op}" for s in fp8_sites(cfg) for op in ("x", "w")]


def make_fp8_state(cfg, precision, device=None) -> Fp8State:
    """A fresh delayed-scaling state for ``cfg``'s FP8 sites, on the card
    unless ``device`` says otherwise."""
    # per-tensor scales: one (history, scale) row per GEMM operand per layer
    return init_fp8_state(scale_keys(cfg), window=precision.fp8_amax_history, num_layers=cfg.num_layers, device=device)


class Fp8Layer:
    """One layer's view of an ``Fp8Ctx``: its scale slice and its matmul."""

    def __init__(self, ctx: "Fp8Ctx", layer: int):
        self.ctx = ctx
        self.layer = layer
        self.scales = {k: s[layer] for k, s in ctx.state.scale.items()}

    def matmul(self, site: str, x: torch.Tensor, w: torch.Tensor, amax_of: torch.Tensor | None = None) -> torch.Tensor:
        """``x @ w`` through the FP8 path.

        x: (..., K) activations (compute dtype); w: (K, N) master weights.
        Returns (..., N) in ``x.dtype``.  Records the operands' amaxes while
        the layer is open (its original forward), not in a recompute;
        ``amax_of``: the whole leaf whose slice ``w`` is, whose amax the
        weight's record takes (a rank's kv head of ``wk`` / ``wv`` under
        the ``"grouped"`` attention layout).
        """
        kx, kw = f"{site}/x", f"{site}/w"
        x2 = x.reshape(-1, x.shape[-1])
        if self.ctx.observing(self.layer):
            self.ctx._observe(kx, tensor_amax(x2))
            self.ctx._observe(kw, tensor_amax(w if amax_of is None else amax_of))
        out = fp8_dot(x2, w, self.scales[kx], self.scales[kw], self.ctx.fwd_dtype, self.ctx.gemm_fn,
                      self.ctx.amax_reduce)
        return out.to(x.dtype).reshape(x.shape[:-1] + (w.shape[-1],))


class Fp8Ctx:
    """Routes projection matmuls through FP8 and collects amax observations.

    One context serves one forward (one microbatch).  See the module
    docstring for the bind / matmul / drain protocol.  ``amax_reduce``
    (sharded training) takes the amax of a rank's shard of a backward
    gradient to the whole gradient's (``fp8_dot``); the forward's
    observations are reduced by the train step.
    """

    def __init__(self, cfg, precision, state: Fp8State, amax_reduce=None):
        if precision.fp8_dtype not in FP8_DTYPES:
            raise ValueError(f"precision.fp8_dtype={precision.fp8_dtype!r}: expected one of {sorted(FP8_DTYPES)}")
        gemm_fn = precision.fp8_gemm
        if not (callable(gemm_fn) or gemm_fn in GEMM_IMPLS):
            raise ValueError(f"precision.fp8_gemm={gemm_fn!r}: expected one of {sorted(GEMM_IMPLS)} or a GEMM")
        self.fwd_dtype = FP8_DTYPES[precision.fp8_dtype]
        self.gemm_fn = gemm_fn if callable(gemm_fn) else GEMM_IMPLS[gemm_fn]
        self.state = state
        self.amax_reduce = amax_reduce
        self.keys = scale_keys(cfg)
        self._amax: dict[str, torch.Tensor] = {}
        self._open: int | None = None

    def bind_layer_scales(self, layer: int) -> Fp8Layer:
        """Open ``layer`` for observation and return the handle its block
        calls (called by the forward's layer loop before each block)."""
        self._open = layer
        self._amax = {}
        return Fp8Layer(self, layer)

    def observing(self, layer: int) -> bool:
        return self._open == layer

    def _observe(self, key: str, amax: torch.Tensor) -> None:
        prev = self._amax.get(key)
        self._amax[key] = amax if prev is None else torch.maximum(prev, amax)

    def drain(self) -> dict:
        """The open layer's amaxes (zeros for sites it did not exercise);
        closes the layer."""
        if self._open is None:
            raise RuntimeError("Fp8Ctx.drain called with no layer bound")
        device = next(iter(self.state.scale.values())).device
        zero = torch.zeros((), dtype=torch.float32, device=device)
        obs = {k: self._amax.get(k, zero) for k in self.keys}
        self._amax = {}
        self._open = None
        return obs


def make_fp8_ctx(cfg, precision, state: Fp8State, amax_reduce=None) -> Fp8Ctx:
    return Fp8Ctx(cfg, precision, state, amax_reduce)
