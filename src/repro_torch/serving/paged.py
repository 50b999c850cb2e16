"""Paged KV-cache block allocator (vLLM-style, host-side, refcounted).

The engine's KV memory is a global pool of fixed-size blocks shared by every
batch slot; a request owns ``ceil(tokens / block_size)`` physical blocks,
recorded in its block-table row.  Admission is gated on *free blocks*, not
free slots — the structural change that decouples max concurrency from
``max_seq``: a 16-token request costs 1 block, not a ``max_seq``-long dense
cache line.

Physical block 0 is the **null block**: never allocated, permanently the
target of inactive slots' block tables, so their (masked) decode writes land
in a scratch bin instead of a live request's memory.

The allocator is deliberately oblivious to device meshes: under
tensor-parallel serving the pools shard along the **kv-head** axis (every
device holds its head slice of every block), so block ids — and with them
every alloc/free/refcount decision here — are device-invariant.  Allocator
state never needs sharding, mirroring, or per-device reconciliation.

Blocks are **refcounted** so prefix caching (``serving.prefix``) can share
one physical block between every request whose prompt starts with the same
token-aligned content: each sharer holds one reference, writes never touch a
block whose positions are covered by more than one table row, and a block
only leaves live accounting when its last reference drops.  A dropped block
goes one of two ways:

* ``free``        — eagerly back to the free list (content dead).
* ``free_cached`` — into an **LRU cached pool**: the content is still a
  valid prefix-cache entry, so the block is only reclaimed (oldest first,
  ``on_evict`` notified so the prefix index unmaps it) when an allocation
  finds the free list empty.  Cached blocks therefore count as free for
  admission gating — they are reclaimable on demand.

Eviction is **tier-aware**: the ``on_evict`` callback may return a tier tag
— ``"spilled"`` when the prefix index demoted the block's content into a
host-RAM ``serving.spill.SpillPool`` (the entry stays matchable), anything
else meaning the content was dropped — and the allocator accounts the two
outcomes separately (``evictions_spilled`` / ``evictions_dropped``).
``uncache`` is the stranding repair path: when an index unmap cascade finds
a still-cached descendant that can no longer be matched (its parent's entry
is gone), the block moves straight from the cached pool to the free list
instead of leaking reclaimable-but-unreachable capacity.

Blocks are position-independent (any physical block can hold any logical
block), so "fragmentation" here is purely a locality concern: a scattered
free list means scattered DMA reads on real hardware.  ``fragmentation()``
reports it and ``defrag()`` sorts the free list so subsequent allocations are
contiguous — allocation/free/defrag accounting without any copying.  (The
cached pool is exempt: those blocks pin live content at their address.)
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Callable, Optional


class OutOfBlocks(RuntimeError):
    """Allocation would exceed the pool — admission must backpressure."""


def blocks_needed(tokens: int, block_size: int) -> int:
    """Physical blocks required to hold ``tokens`` cache positions."""
    return -(-max(tokens, 1) // block_size)


def truncate_blocks(
    blocks: list[int], tokens: int, block_size: int
) -> tuple[list[int], list[int]]:
    """Token-level truncate of a block list: ``(kept, tail)``.

    ``kept`` covers logical positions [0, tokens); ``tail`` is every block
    past the truncation point.  Speculative decoding uses this when a
    request finishes mid-window: the engine reserved headroom for the draft
    window, and any tail blocks hold only rejected speculative writes (or
    were never written) — they are dead content that must be freed eagerly,
    never parked in the prefix cache's LRU pool.  ``tokens <= 0`` keeps
    nothing.
    """
    n = blocks_needed(tokens, block_size) if tokens > 0 else 0
    n = min(n, len(blocks))
    return blocks[:n], blocks[n:]


class BlockAllocator:
    def __init__(self, num_blocks: int, on_evict: Optional[Callable[[int], None]] = None):
        if num_blocks < 2:
            raise ValueError(f"need >= 2 blocks (1 null + 1 usable), got {num_blocks}")
        self.num_blocks = num_blocks
        # LIFO free list: freshly freed (cache-warm) blocks are reused first
        self._free = list(range(num_blocks - 1, 0, -1))
        self._ref: dict[int, int] = {}  # live block -> refcount
        self._cached: OrderedDict[int, None] = OrderedDict()  # refcount-0, LRU order
        # called with the block id before reclaiming it; may return a tier
        # tag ("spilled" = content demoted to a host pool, else dropped)
        self.on_evict = on_evict
        self.peak_in_use = 0
        self.total_allocs = 0
        self.total_frees = 0
        self.evictions = 0
        self.evictions_spilled = 0  # content demoted to the host spill tier
        self.evictions_dropped = 0  # content destroyed
        self.stranded_reclaims = 0  # cached-but-unreachable blocks uncache()d
        self._metrics = None  # attach_metrics publishes occupancy per mutation

    def attach_metrics(self, registry) -> None:
        """Publish allocator accounting into a ``serving.metrics``
        registry: occupancy gauges refreshed on every alloc/free, eviction
        and alloc/free counters.  Host-side scalar updates only."""
        self._metrics = registry
        self._m_in_use = registry.gauge("pool_blocks_in_use", "live (refcounted) blocks")
        self._m_free = registry.gauge("pool_blocks_free", "allocatable blocks (free list + evictable cached)")
        self._m_cached = registry.gauge("pool_blocks_cached", "refcount-0 blocks parked in the prefix LRU")
        self._m_allocs = registry.counter("pool_allocs_total", "blocks allocated (cached revivals count)")
        self._m_frees = registry.counter("pool_frees_total", "blocks freed or parked in the LRU")
        self._m_evictions = registry.counter("pool_evictions_total", "LRU cached blocks reclaimed on demand")
        self._m_evict_spilled = registry.counter("pool_evictions_spilled_total", "evicted blocks demoted to the host spill tier")
        self._m_stranded = registry.counter("pool_stranded_reclaims_total", "cached-but-unreachable blocks returned to the free list")
        self._publish()

    def _publish(self) -> None:
        if self._metrics is None:
            return
        self._m_in_use.set(len(self._ref))
        self._m_free.set(self.num_free)
        self._m_cached.set(len(self._cached))

    # -- accounting ----------------------------------------------------
    @property
    def capacity(self) -> int:
        """Usable blocks (excludes the null block)."""
        return self.num_blocks - 1

    @property
    def num_free(self) -> int:
        """Blocks an ``alloc`` can hand out: truly free + evictable cached."""
        return len(self._free) + len(self._cached)

    @property
    def blocks_in_use(self) -> int:
        return len(self._ref)

    @property
    def num_cached(self) -> int:
        return len(self._cached)

    def refcount(self, block: int) -> int:
        return self._ref.get(block, 0)

    def is_cached(self, block: int) -> bool:
        return block in self._cached

    def fragmentation(self) -> float:
        """1 - (longest contiguous free run / free blocks); 0 = fully
        contiguous free space, -> 1 = maximally scattered."""
        if len(self._free) <= 1:
            return 0.0
        ids = sorted(self._free)
        longest = run = 1
        for a, b in zip(ids, ids[1:]):
            run = run + 1 if b == a + 1 else 1
            longest = max(longest, run)
        return 1.0 - longest / len(ids)

    def defrag(self) -> float:
        """Sort the free list so future allocations come out id-contiguous
        (DMA locality on real HW).  Returns the pre-defrag fragmentation."""
        frag = self.fragmentation()
        self._free.sort(reverse=True)  # popped from the tail -> ascending ids
        return frag

    # -- alloc / free --------------------------------------------------
    def _evict_one(self) -> int:
        block, _ = self._cached.popitem(last=False)  # oldest entry
        tier = self.on_evict(block) if self.on_evict is not None else None
        if tier == "spilled":
            self.evictions_spilled += 1
        else:
            self.evictions_dropped += 1
        self.evictions += 1
        if self._metrics is not None:
            self._m_evictions.inc()
            if tier == "spilled":
                self._m_evict_spilled.inc()
        return block

    def alloc(self, n: int) -> list[int]:
        """Allocate ``n`` blocks (refcount 1) or raise ``OutOfBlocks``
        (all-or-nothing).  Draws from the free list first; when it runs dry,
        evicts the least-recently-used cached blocks."""
        if n < 0:
            raise ValueError(f"alloc({n})")
        if n > self.num_free:
            raise OutOfBlocks(f"need {n} blocks, {self.num_free} free of {self.capacity}")
        blocks = []
        for _ in range(n):
            blocks.append(self._free.pop() if self._free else self._evict_one())
        for b in blocks:
            self._ref[b] = 1
        self.total_allocs += n
        self.peak_in_use = max(self.peak_in_use, len(self._ref))
        if self._metrics is not None:
            self._m_allocs.inc(n)
            self._publish()
        return blocks

    def incref(self, block: int) -> None:
        """Add a reference to a live block (prefix sharing)."""
        if block not in self._ref:
            raise ValueError(f"incref on non-live block {block}")
        self._ref[block] += 1

    def reuse_cached(self, block: int) -> None:
        """Revive a refcount-0 cached block into live use (prefix hit on an
        evictable entry): removed from the LRU pool, refcount 1.  Counts as
        an allocation so ``total_allocs == total_frees`` stays the drained-
        engine leak check: every park in the cached pool counted a free."""
        if block not in self._cached:
            raise ValueError(f"block {block} is not in the cached pool")
        del self._cached[block]
        self._ref[block] = 1
        self.total_allocs += 1
        self.peak_in_use = max(self.peak_in_use, len(self._ref))
        if self._metrics is not None:
            self._m_allocs.inc()
            self._publish()

    def _decref(self, block: int) -> bool:
        if block not in self._ref:
            raise ValueError(f"double free / foreign block {block}")
        self._ref[block] -= 1
        if self._ref[block] > 0:
            return False
        del self._ref[block]
        return True

    def free(self, blocks: list[int]) -> None:
        """Drop one reference per block; last reference returns the block to
        the free list (content dead)."""
        for b in blocks:
            if self._decref(b):
                self._free.append(b)
                self.total_frees += 1
                if self._metrics is not None:
                    self._m_frees.inc()
        self._publish()

    def free_cached(self, blocks: list[int]) -> None:
        """Drop one reference per block; last reference parks the block in
        the LRU cached pool (content stays matchable until evicted)."""
        for b in blocks:
            if self._decref(b):
                self._cached[b] = None  # appended at the MRU end
                self.total_frees += 1
                if self._metrics is not None:
                    self._m_frees.inc()
        self._publish()

    def uncache(self, block: int) -> None:
        """Return a refcount-0 cached block straight to the free list — the
        stranding repair: an index unmap cascade found this block cached but
        unreachable for matching (its parent entry is gone), so parking it
        in the LRU any longer only wastes reclaimable capacity.  Not an
        eviction (``on_evict`` already unmapped it) and not a new free (its
        park in the cached pool counted one)."""
        if block not in self._cached:
            raise ValueError(f"block {block} is not in the cached pool")
        del self._cached[block]
        self._free.append(block)
        self.stranded_reclaims += 1
        if self._metrics is not None:
            self._m_stranded.inc()
        self._publish()

    def stats(self) -> dict:
        return {
            "capacity": self.capacity,
            "blocks_in_use": self.blocks_in_use,
            "num_free": self.num_free,
            "num_cached": self.num_cached,
            "peak_in_use": self.peak_in_use,
            "total_allocs": self.total_allocs,
            "total_frees": self.total_frees,
            "evictions_spilled": self.evictions_spilled,
            "evictions_dropped": self.evictions_dropped,
            "stranded_reclaims": self.stranded_reclaims,
            "fragmentation": round(self.fragmentation(), 3),
        }
