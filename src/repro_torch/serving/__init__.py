from repro_torch.serving.engine import InferenceEngine
from repro_torch.serving.kvcache import (
    clear_block_row,
    copy_block_rows,
    gather_block_rows,
    make_table_row,
    restore_block_rows,
    truncate_block_rows,
)
from repro_torch.serving.kvquant import (
    KV_QUANT_MODES,
    QuantizedKV,
    attend_quantized,
    cache_bytes,
    dequantize,
    is_quantized_kv,
    kv_quant_mode_of,
    kv_storage_dtype,
    memory_saving,
    normalize_kv_quant,
    quantize,
    quantize_cache,
)
from repro_torch.serving.prefix import is_spilled
from repro_torch.serving.scheduler import Request, RequestState
from repro_torch.serving.spill import SPILL_MODES, SpillPool

__all__ = [
    "InferenceEngine",
    "KV_QUANT_MODES",
    "QuantizedKV",
    "Request",
    "RequestState",
    "SPILL_MODES",
    "SpillPool",
    "attend_quantized",
    "cache_bytes",
    "clear_block_row",
    "copy_block_rows",
    "dequantize",
    "gather_block_rows",
    "is_quantized_kv",
    "is_spilled",
    "kv_quant_mode_of",
    "kv_storage_dtype",
    "make_table_row",
    "memory_saving",
    "normalize_kv_quant",
    "quantize",
    "quantize_cache",
    "restore_block_rows",
    "truncate_block_rows",
]
