from repro_torch.models.cache import NULL_BLOCK, init_cache, init_paged_cache, paged_cache_bytes
from repro_torch.models.initializers import init_params, param_specs
from repro_torch.models.model import (
    REMAT_POLICIES,
    decode_step,
    embed_input,
    forward,
    lm_logits,
    prefill_step,
    unified_step,
    verify_step,
)

__all__ = [
    "NULL_BLOCK",
    "REMAT_POLICIES",
    "decode_step",
    "embed_input",
    "forward",
    "init_cache",
    "init_paged_cache",
    "init_params",
    "lm_logits",
    "paged_cache_bytes",
    "param_specs",
    "prefill_step",
    "unified_step",
    "verify_step",
]
