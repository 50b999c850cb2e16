from repro_torch.serving.async_engine import AsyncEngine, StreamEvent
from repro_torch.serving.engine import InferenceEngine
from repro_torch.serving.faults import FaultPlan, ReplicaCrashed, ServiceUnavailable
from repro_torch.serving.http import HttpFrontend, serve_http
from repro_torch.serving.kvcache import (
    clear_block_row,
    clear_slot,
    copy_block_rows,
    decode_cache_from_prefill,
    gather_block_rows,
    graft_prefill_into_blocks,
    make_engine_cache,
    make_table_row,
    restore_block_rows,
    truncate_block_rows,
    write_prefill_into_slot,
    write_request_into_slot,
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
from repro_torch.serving.metrics import ManualClock
from repro_torch.serving.prefix import is_spilled, routing_key
from repro_torch.serving.replica import Replica, ReplicaState
from repro_torch.serving.router import ROUTING_POLICIES, Router, RouterRequest
from repro_torch.serving.scheduler import Request, RequestState
from repro_torch.serving.spill import SPILL_MODES, SpillPool
from repro_torch.serving.trace import replica_track

__all__ = [
    "AsyncEngine",
    "FaultPlan",
    "HttpFrontend",
    "InferenceEngine",
    "KV_QUANT_MODES",
    "ManualClock",
    "QuantizedKV",
    "ROUTING_POLICIES",
    "Replica",
    "ReplicaCrashed",
    "ReplicaState",
    "Request",
    "RequestState",
    "Router",
    "RouterRequest",
    "SPILL_MODES",
    "ServiceUnavailable",
    "SpillPool",
    "StreamEvent",
    "attend_quantized",
    "cache_bytes",
    "clear_block_row",
    "clear_slot",
    "copy_block_rows",
    "decode_cache_from_prefill",
    "dequantize",
    "gather_block_rows",
    "graft_prefill_into_blocks",
    "is_quantized_kv",
    "is_spilled",
    "kv_quant_mode_of",
    "kv_storage_dtype",
    "make_engine_cache",
    "make_table_row",
    "memory_saving",
    "normalize_kv_quant",
    "quantize",
    "quantize_cache",
    "replica_track",
    "restore_block_rows",
    "routing_key",
    "serve_http",
    "truncate_block_rows",
    "write_prefill_into_slot",
    "write_request_into_slot",
]
