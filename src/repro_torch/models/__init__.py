from repro_torch.models.cache import NULL_BLOCK, init_paged_cache, paged_cache_bytes
from repro_torch.models.initializers import init_params, param_specs
from repro_torch.models.model import decode_step, embed_input, lm_logits, prefill_step

__all__ = [
    "NULL_BLOCK",
    "decode_step",
    "embed_input",
    "init_paged_cache",
    "init_params",
    "lm_logits",
    "paged_cache_bytes",
    "param_specs",
    "prefill_step",
]
