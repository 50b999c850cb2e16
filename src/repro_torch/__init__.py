"""PyTorch/CUDA port of the serving path, beside the JAX package ``repro``.

Imports ``torch``, numpy and the standard library only; it never imports
``jax`` or anything of ``repro``.  Entry points run on the card unless the
caller passes ``device="cpu"``.  The slice ported so far is paged dense
serving: configs, the dense model on a paged KV cache, the paged-attention
CUDA kernels (decode and chunked prefill) and the continuous-batching
engine with prefix caching and chunked prefill.
"""

from repro_torch.config import ModelConfig, reduce_for_smoke
from repro_torch.configs import get_config
from repro_torch.device import resolve_device
from repro_torch.models import decode_step, init_paged_cache, init_params, prefill_step
from repro_torch.serving import InferenceEngine

__all__ = [
    "InferenceEngine",
    "ModelConfig",
    "decode_step",
    "get_config",
    "init_paged_cache",
    "init_params",
    "prefill_step",
    "reduce_for_smoke",
    "resolve_device",
]
