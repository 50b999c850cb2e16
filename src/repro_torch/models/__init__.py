from repro_torch.models.cache import NULL_BLOCK, SERVED_FAMILIES, cache_bytes, init_cache, init_paged_cache, paged_cache_bytes, supports_paged
from repro_torch.models.initializers import init_params, param_specs
from repro_torch.models.model import (
    CHUNKED_PREFILL_FAMILIES,
    REMAT_POLICIES,
    decode_step,
    embed_input,
    forward,
    lm_logits,
    prefill,
    prefill_step,
    supports_chunked_prefill,
    unified_step,
    verify_step,
)

__all__ = [
    "CHUNKED_PREFILL_FAMILIES",
    "NULL_BLOCK",
    "REMAT_POLICIES",
    "SERVED_FAMILIES",
    "cache_bytes",
    "decode_step",
    "embed_input",
    "forward",
    "init_cache",
    "init_paged_cache",
    "init_params",
    "lm_logits",
    "paged_cache_bytes",
    "param_specs",
    "prefill",
    "prefill_step",
    "supports_chunked_prefill",
    "supports_paged",
    "unified_step",
    "verify_step",
]
