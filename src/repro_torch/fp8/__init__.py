"""FP8 quantized training: e4m3/e5m2 casts, delayed scaling, FP8 GEMMs.

``quantize`` (scales, ``Fp8State``, ``fp8_dot``), ``gemm`` (the CUDA
kernel K4), ``gemm_ref`` (its plain version) and ``policy`` (site
selection, ``Fp8Ctx``).  Enabled by ``PrecisionConfig.fp8``.
"""

from repro_torch.fp8.gemm import fp8_gemm
from repro_torch.fp8.gemm_ref import fp8_gemm_plain
from repro_torch.fp8.policy import (
    Fp8Ctx,
    fp8_peak_applies,
    fp8_sites,
    fp8_supported,
    make_fp8_ctx,
    make_fp8_state,
    scale_keys,
)
from repro_torch.fp8.quantize import (
    E4M3,
    E5M2,
    FP8_DTYPES,
    FP8_MAX,
    Fp8State,
    compute_scale,
    dequantize,
    fp8_dot,
    init_fp8_state,
    quantize,
    tensor_amax,
    update_fp8_state,
)

__all__ = [
    "E4M3",
    "E5M2",
    "FP8_DTYPES",
    "FP8_MAX",
    "Fp8Ctx",
    "Fp8State",
    "compute_scale",
    "dequantize",
    "fp8_dot",
    "fp8_gemm",
    "fp8_gemm_plain",
    "fp8_peak_applies",
    "fp8_sites",
    "fp8_supported",
    "init_fp8_state",
    "make_fp8_ctx",
    "make_fp8_state",
    "quantize",
    "scale_keys",
    "tensor_amax",
    "update_fp8_state",
]
