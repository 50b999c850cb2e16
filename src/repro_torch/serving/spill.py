"""Host-memory spill tier for evicted prefix-cache blocks.

The JAX package's ``serving/spill.py`` in PyTorch.  Isambard-AI backs its
GPU HBM with capacity tiers so hot working sets can overflow device memory
without losing locality; this module is the serving stack's counterpart.
Without it, every LRU eviction from the ``BlockAllocator``'s cached pool
destroys the block's K/V content, and the prefix cache is capped at one
card's memory.  With a ``SpillPool`` attached
(``InferenceEngine(spill_bytes=...)``), eviction *demotes* the block: its
K/V rows are gathered off the device pool and parked in host RAM, the
``PrefixIndex`` entry stays matchable under a negative **spill handle**,
and a later prefix hit swaps the rows back into freshly allocated device
blocks (``promote``) instead of running prefill again.

Tier state machine for one prefix-indexed block::

      alloc            free_cached          _evict_one
    free ──► in-use ──────────► cached ─────────────────► spilled
                 ▲                ▲        (SpillPool.put)    │
                 │  reuse_cached  │                           │ prefix hit:
                 │  (device hit)  │                           │ promote + swap-in
                 └────────────────┘◄──────────────────────────┘
                                      restore into a fresh
                                      device block (refcount 1)

    spilled ──► dropped   when the pool's byte budget forces out its own
                          LRU entry (``on_drop`` cascades the index unmap)

Design points, as in the JAX package:

* **Handles are negative ints** (-1, -2, ...), disjoint from physical block
  ids (>= 1; 0 is the null block).
* **Double-buffered writeback**: ``put`` *stages* the gathered device rows
  (``kvcache.gather_block_rows`` copies them, so the pool block can be
  reused at once) and defers the host copy.  Only when a staged entry is
  pushed past ``staging_depth`` by newer spills is it compressed and copied
  to host memory as CPU tensors (numpy has no bf16 or e4m3): that copy is
  the device-to-host sync.  A restore that finds its entry still staged is
  a device-to-device move.
* **At-rest compression** (``mode``): ``"cache"`` keeps the pool's own
  dtype (a bit-exact round trip; quantized pools' rows are already int8 or
  e4m3 with scales); ``"int8"`` quantizes float leaves per (token, head)
  through ``serving.kvquant``; ``"fp8"`` casts them to e4m3 with one amax
  scale per leaf (``fp8.quantize``).  ``get`` / ``pop`` return the rows
  decompressed to fp32 (the restore casts to the pool dtype).
* **Which leaves compress**: fp16, fp32 and fp64 rows only, never the
  scale leaves.  The JAX package asks ``np.issubdtype(dtype, np.floating)``,
  which is false for bf16 and e4m3 under ml_dtypes, so a **bf16 pool
  spills its native bytes in every mode**; ``_is_float_leaf`` keeps that.
* **Byte budget**: ``capacity_bytes`` bounds the *compressed* host bytes,
  computed from shapes, so the accounting never waits on the device.  A
  ``put`` that would overflow drops the pool's own LRU entries first,
  calling ``on_drop(handle)`` so the prefix index can unmap them.
"""

from __future__ import annotations

import math
import warnings
from collections import OrderedDict
from typing import Callable, Optional

import torch

from repro_torch.fp8.quantize import E4M3, compute_scale, tensor_amax
from repro_torch.fp8.quantize import dequantize as fp8_dequantize
from repro_torch.fp8.quantize import quantize as fp8_quantize
from repro_torch.serving import kvquant

SPILL_MODES = ("cache", "int8", "fp8")

_QSUFFIX = "@qscale"  # compressed-leaf sibling key for quantization scales
_COMPRESSIBLE = (torch.float16, torch.float32, torch.float64)  # np.floating without ml_dtypes' types


def _is_float_leaf(name: str, t: torch.Tensor) -> bool:
    """Leaves eligible for lossy at-rest compression: float K/V rows of a
    dtype numpy calls floating.  Scale leaves (fp32 metadata), int8, e4m3
    and bf16 rows stay as they are."""
    return not name.endswith("_scale") and t.dtype in _COMPRESSIBLE


class SpillPool:
    """Byte-budgeted host-RAM pool of spilled KV blocks (LRU, compressed)."""

    def __init__(
        self,
        capacity_bytes: int,
        *,
        mode: str = "cache",
        staging_depth: int = 2,
        on_drop: Optional[Callable[[int], None]] = None,
    ):
        if capacity_bytes <= 0:
            raise ValueError(f"capacity_bytes={capacity_bytes} (need > 0)")
        if mode not in SPILL_MODES:
            raise ValueError(f"mode={mode!r} (choose from {SPILL_MODES})")
        if staging_depth < 0:
            raise ValueError(f"staging_depth={staging_depth}")
        self.capacity_bytes = capacity_bytes
        self.mode = mode
        self.staging_depth = staging_depth
        self.on_drop = on_drop  # called AFTER the entry is removed
        self._next = -1  # handles count down: -1, -2, ...
        self._payload: OrderedDict[int, dict] = OrderedDict()  # LRU order
        self._nbytes: dict[int, int] = {}
        self._staged: set[int] = set()  # handles whose payload is still on the device
        self._staging_order: list[int] = []  # oldest first
        self.bytes_used = 0
        self.spills = 0  # entries admitted
        self.drops = 0  # entries evicted by the byte budget
        self.restores = 0  # entries swapped back to the device (engine-reported)
        self.refused = 0  # put() refusals (entry alone exceeds capacity)
        self._metrics = None

    def attach_metrics(self, registry) -> None:
        self._metrics = registry
        self._m_blocks = registry.gauge("spill_blocks", "KV blocks resident in the host spill tier")
        self._m_bytes = registry.gauge("spill_bytes_used", "compressed host bytes held by spilled blocks")
        self._m_spills = registry.counter("spill_blocks_total", "blocks demoted to the host tier")
        self._m_drops = registry.counter("spill_drops_total", "spilled blocks evicted by the byte budget")
        self._publish()

    def _publish(self) -> None:
        if self._metrics is not None:
            self._m_blocks.set(len(self._payload))
            self._m_bytes.set(self.bytes_used)

    def __len__(self) -> int:
        return len(self._payload)

    def __contains__(self, handle: int) -> bool:
        return handle in self._payload

    # -- byte accounting (from shapes: no device syncs) -----------------
    def _leaf_nbytes(self, name: str, t: torch.Tensor) -> int:
        size = t.numel()
        if self.mode == "cache" or not _is_float_leaf(name, t):
            return size * t.element_size()
        if self.mode == "int8":
            # int8 rows + one fp32 scale per (..., head) row
            return size + math.prod(t.shape[:-1]) * 4
        return size + 4  # fp8: e4m3 rows + one fp32 scale per leaf

    def entry_nbytes(self, payload: dict) -> int:
        return sum(self._leaf_nbytes(n, t) for n, t in payload.items())

    # -- compression codecs ---------------------------------------------
    def _compress(self, payload: dict) -> dict:
        """Device rows -> compressed host tensors (the device-to-host sync)."""
        out = {}
        for name, t in payload.items():
            if self.mode == "cache" or not _is_float_leaf(name, t):
                out[name] = t.cpu()
            elif self.mode == "int8":
                q, scale = kvquant.quantize(t)
                out[name] = q.cpu()
                out[name + _QSUFFIX] = scale.cpu()
            else:  # fp8 at rest: one saturating e4m3 cast per leaf
                scale = compute_scale(tensor_amax(t), E4M3)
                out[name] = fp8_quantize(t, scale, E4M3).cpu()
                out[name + _QSUFFIX] = scale.cpu()
        return out

    def _decompress(self, comp: dict) -> dict:
        """Compressed host tensors -> rows (the restore casts to the pool
        dtype and moves them to the device)."""
        out = {}
        for name, t in comp.items():
            if name.endswith(_QSUFFIX):
                continue
            scale = comp.get(name + _QSUFFIX)
            if scale is None:
                out[name] = t
            elif self.mode == "int8":
                out[name] = kvquant.dequantize(t, scale, torch.float32)
            else:
                out[name] = fp8_dequantize(t, scale, torch.float32)
        return out

    # -- staging ring (the double buffer) -------------------------------
    def _materialize(self, handle: int) -> None:
        if handle not in self._staged:
            return
        self._staged.discard(handle)
        if handle in self._staging_order:
            self._staging_order.remove(handle)
        self._payload[handle] = self._compress(self._payload[handle])

    def flush(self) -> None:
        """Materialize every staged entry (tests / shutdown)."""
        for h in list(self._staging_order):
            self._materialize(h)

    # -- admission / eviction -------------------------------------------
    def put(self, payload: dict) -> Optional[int]:
        """Admit one block's rows; returns the spill handle, or None when the
        entry alone exceeds the byte budget (the caller drops it).  May evict
        the pool's own LRU entries (``on_drop`` per victim)."""
        nbytes = self.entry_nbytes(payload)
        if nbytes > self.capacity_bytes:
            self.refused += 1
            return None
        while self.bytes_used + nbytes > self.capacity_bytes:
            self._drop(next(iter(self._payload)))
        handle = self._next
        self._next -= 1
        self._payload[handle] = payload
        self._nbytes[handle] = nbytes
        self.bytes_used += nbytes
        self._staged.add(handle)
        self._staging_order.append(handle)
        # drain the staging ring: entries pushed past the depth pay their
        # compression and host copy now, overlapped with the steps since
        # their put
        while len(self._staging_order) > self.staging_depth:
            self._materialize(self._staging_order[0])
        self.spills += 1
        if self._metrics is not None:
            self._m_spills.inc()
        self._publish()
        return handle

    def _drop(self, handle: int) -> None:
        self._remove(handle)
        self.drops += 1
        if self._metrics is not None:
            self._m_drops.inc()
        if self.on_drop is not None:
            self.on_drop(handle)

    def _remove(self, handle: int) -> None:
        del self._payload[handle]
        self.bytes_used -= self._nbytes.pop(handle)
        self._staged.discard(handle)
        if handle in self._staging_order:
            self._staging_order.remove(handle)
        self._publish()

    def discard(self, handle: int) -> None:
        """Remove an entry without the ``on_drop`` callback (the prefix
        index calls this from its own unmap cascade)."""
        if handle in self._payload:
            self._remove(handle)
            self.drops += 1
            if self._metrics is not None:
                self._m_drops.inc()

    # -- lookup / restore -----------------------------------------------
    def touch(self, handle: int) -> None:
        """LRU bump on a match."""
        if handle in self._payload:
            self._payload.move_to_end(handle)

    def get(self, handle: int) -> dict:
        """The entry's rows, decompressed, without removing it (a partial-hit
        copy-on-write keeps the canonical spilled entry in place)."""
        payload = self._payload[handle]
        self._payload.move_to_end(handle)
        if handle in self._staged:
            return dict(payload)  # device rows: a device-to-device restore
        return self._decompress(payload)

    def pop(self, handle: int) -> dict:
        """Remove the entry and return its rows, decompressed.  The caller
        owns the payload from here: a restore admission pops *before*
        allocating device blocks, so eviction inside ``alloc`` can never
        LRU-drop an entry that is about to be swapped back in."""
        payload = self._payload[handle]
        staged = handle in self._staged
        self._remove(handle)
        return dict(payload) if staged else self._decompress(payload)

    def stats(self) -> dict:
        return {
            "blocks": len(self._payload),
            "bytes_used": self.bytes_used,
            "capacity_bytes": self.capacity_bytes,
            "mode": self.mode,
            "staged": len(self._staged),
            "spills": self.spills,
            "drops": self.drops,
            "restores": self.restores,
            "refused": self.refused,
        }


def warn_if_fp8_over_int8(quantize_kv, mode: str) -> str:
    """fp8 at rest over a quantized (int8/fp8) pool would quantize already
    quantized rows; keep the exact pool-native bytes instead.
    ``quantize_kv``: the engine's normalized pool mode (None/"int8"/"fp8")."""
    if quantize_kv and mode == "fp8":
        warnings.warn(
            f"spill_dtype='fp8' over a quantized (quantize_kv={quantize_kv!r}) pool "
            "would re-quantize quantized rows; spilling pool-native bytes+scales instead",
            RuntimeWarning,
            stacklevel=3,
        )
        return "cache"
    return mode
