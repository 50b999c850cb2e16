"""PyTorch/CUDA port of the JAX package ``repro``, beside it.

Imports ``torch``, numpy and the standard library only; it never imports
``jax`` or anything of ``repro``.  Entry points run on the card unless the
caller passes ``device="cpu"``.  Ported so far:

* paged serving (dense and moe families): configs, the dense and moe
  models on a paged KV cache (``models.moe``: GShard routing with expert
  capacity), the paged-attention CUDA kernels (decode and chunked prefill)
  and the continuous-batching engine with prefix caching and chunked
  prefill;
* training (dense family): the full-sequence forward, AdamW, synthetic
  data, FP8 training with delayed scaling through the FP8 GEMM CUDA
  kernel, the flash-attention CUDA kernel for the forward, the train step
  and its launcher (``python -m repro_torch.launch.train``);
* the RWKV6 (ssm) family's model and full-sequence forward, with the WKV
  scan CUDA kernel for the evaluation forward;
* BabelStream (paper Fig. 10): the five memory-bandwidth CUDA kernels and
  their benchmark (``python -m repro_torch.benchmarks.babelstream``).
"""

from repro_torch.config import ModelConfig, reduce_for_smoke
from repro_torch.configs import get_config
from repro_torch.device import resolve_device
from repro_torch.models import decode_step, forward, init_paged_cache, init_params, prefill_step
from repro_torch.serving import InferenceEngine
from repro_torch.train import TrainState, init_train_state, loss_fn, make_train_step

__all__ = [
    "InferenceEngine",
    "ModelConfig",
    "TrainState",
    "decode_step",
    "forward",
    "get_config",
    "init_paged_cache",
    "init_params",
    "init_train_state",
    "loss_fn",
    "make_train_step",
    "prefill_step",
    "reduce_for_smoke",
    "resolve_device",
]
