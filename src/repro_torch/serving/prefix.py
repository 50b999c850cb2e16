"""Prefix cache: content-addressed index over paged KV blocks.

Shared system prompts dominate interactive serving traffic (every request in
a deployment carries the same instruction header), yet a naive engine
re-prefills that prefix per request.  This module lets admission *reuse* the
K/V blocks of any previously-prefilled prompt prefix:

* Every **full, token-aligned** block of a prefilled prompt is registered
  under a chain hash ``h_i = H(h_{i-1}, tokens[i*bs:(i+1)*bs])`` — the hash
  commits to the whole prefix, not just the block's own tokens, so two
  prompts share a block only when *everything before it* matches too.
  Token tuples are stored alongside and compared on lookup, so a Python
  hash collision can never alias two different prefixes.
* ``match`` walks a new prompt's chain as far as it stays indexed, then
  looks at the *children* of the last matched node for a block whose tokens
  extend the prompt partially — the *partial tail* case.  Full-block hits
  are shared by refcount (copy never happens: full prompt blocks are
  write-once); a partial hit is **copy-on-write** — the caller copies the
  cached block's K/V rows into a freshly-allocated private block and
  overwrites from the divergence point.
* Matching is capped at ``len(prompt) - 1`` tokens: at least one suffix
  token must run through the model so admission has logits to sample the
  first generated token from.
* The index keys on *tokens and block ids only* — under tensor-parallel
  serving the pools are head-sharded but block ids stay device-invariant,
  so one replicated host-side index serves the whole mesh unchanged
  (counters are asserted mesh-invariant in ``tests/test_sharded_serving.py``).

Lifecycle is refcount-driven (``serving.paged.BlockAllocator``): a matched
block gains one reference per sharer; ``release`` routes indexed blocks to
the allocator's LRU cached pool instead of the free list, so a prefix stays
matchable after its last user finishes and is only evicted (``on_evict``
fires here) when an allocation actually needs the space.

**Tiers**: with a ``serving.spill.SpillPool`` attached (``attach_spill``),
eviction *demotes* instead of dropping — the block's K/V rows move to host
RAM and the entry is re-keyed under the pool's negative **spill handle**
(``is_spilled``), staying fully matchable: ``match`` walks chains through
mixed device/spilled entries unchanged.  A hit on a spilled entry is
``promote``d back to a freshly-allocated device block (the engine swaps the
rows in asynchronously); a cancelled swap-in is ``demote``d back.  Without
a pool (or when the pool refuses), eviction drops the entry — and runs the
**stranding cascade**: dropping a parent makes every descendant unreachable
for matching (walks start at the root), so ``_drop_entry`` unmaps the whole
subtree, discards spilled descendants from the pool and returns cached
device descendants to the free list (``BlockAllocator.uncache``) instead of
letting unreachable-but-resident blocks leak LRU capacity.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, NamedTuple, Optional

from repro_torch.serving.paged import BlockAllocator

_ROOT = 0  # chain-hash seed


def is_spilled(block: int) -> bool:
    """Tier tag of an index id: physical device blocks are >= 1 (0 is the
    null block); spill handles are negative (``SpillPool`` counts down)."""
    return block < 0


def chain_hash(parent: int, tokens: tuple[int, ...]) -> int:
    return hash((parent, tokens))


def routing_key(prompt: list[int], block_size: int) -> int:
    """Coarse affinity key for a prompt: the chain hash of its first block
    (short prompts hash whatever they have).

    Two prompts share cached blocks only if their chains agree from the
    root, and the chain's first link is exactly this value — so a router
    that keeps requests with equal keys on one replica keeps every
    same-system-prompt burst where its blocks are, even before the first
    request of the burst has prefilled anything the index could ``match``.
    """
    return chain_hash(_ROOT, tuple(prompt[: min(block_size, len(prompt))]))


class PartialHit(NamedTuple):
    block: int  # cached physical block to copy-on-write from
    tokens: int  # leading tokens of that block shared with the prompt


@dataclass
class _Entry:
    hash: int
    parent: int
    tokens: tuple[int, ...]


@dataclass
class PrefixIndex:
    allocator: BlockAllocator
    block_size: int
    by_hash: dict[int, int] = field(default_factory=dict)  # chain hash -> block
    meta: dict[int, _Entry] = field(default_factory=dict)  # block -> entry
    children: dict[int, list[int]] = field(default_factory=dict)  # parent hash -> blocks
    registered: int = 0
    spill: Optional[object] = field(default=None, repr=False)  # serving.spill.SpillPool
    _fetch: Optional[Callable[[int], dict]] = field(default=None, repr=False)
    spilled: int = 0  # entries demoted to the host tier
    promoted: int = 0  # spilled entries rewired back to device blocks
    demoted: int = 0  # cancelled swap-ins re-parked in the pool
    stranded_dropped: int = 0  # descendants unmapped by the cascade
    _metrics: Optional[object] = field(default=None, repr=False)

    def __post_init__(self):
        self.allocator.on_evict = self._on_evict

    def attach_spill(self, pool, fetch: Callable[[int], dict]) -> None:
        """Enable the host spill tier: ``pool`` holds demoted rows, ``fetch``
        (engine-provided) gathers one device block's K/V rows at evict time.
        The pool's own byte-budget drops cascade back through this index."""
        self.spill = pool
        self._fetch = fetch
        pool.on_drop = self._drop_entry

    def attach_metrics(self, registry) -> None:
        """Publish index size and registration volume into a
        ``serving.metrics`` registry."""
        self._metrics = registry
        self._m_entries = registry.gauge("prefix_entries", "indexed (matchable) prefix blocks")
        self._m_registered = registry.counter("prefix_registrations_total", "blocks ever indexed")
        self._m_entries.set(len(self.by_hash))

    def _publish(self) -> None:
        if self._metrics is not None:
            self._m_entries.set(len(self.by_hash))

    def __len__(self) -> int:
        return len(self.by_hash)

    # -- lookup --------------------------------------------------------
    def _lookup(self, parent: int, tokens: tuple[int, ...]) -> Optional[int]:
        h = chain_hash(parent, tokens)
        b = self.by_hash.get(h)
        if b is None:
            return None
        ent = self.meta[b]
        # verify: chain hashes are Python hashes, not cryptographic
        if ent.parent != parent or ent.tokens != tokens:
            return None
        return b

    def match(self, prompt: list[int]) -> tuple[list[int], Optional[PartialHit]]:
        """Longest indexed prefix of ``prompt``: (full blocks, partial tail).

        Pure lookup — takes no references; call ``acquire`` on the returned
        blocks (and the partial source, around the COW copy) to pin them.
        Never matches past ``len(prompt) - 1`` tokens.
        """
        bs = self.block_size
        limit = len(prompt) - 1  # leave >= 1 token to prefill
        blocks: list[int] = []
        parent = _ROOT
        i = 0
        while i + bs <= limit:
            blk = self._lookup(parent, tuple(prompt[i : i + bs]))
            if blk is None:
                break
            blocks.append(blk)
            parent = self.meta[blk].hash
            i += bs
        partial = None
        best = 0
        rem = prompt[i:limit]
        if rem:
            for cand in self.children.get(parent, ()):
                toks = self.meta[cand].tokens
                n = 0
                while n < len(rem) and n < len(toks) and toks[n] == rem[n]:
                    n += 1
                if n > best:
                    best, partial = n, PartialHit(cand, n)
        return blocks, partial

    def match_tokens(self, prompt: list[int]) -> int:
        """Tokens of ``prompt`` a ``match`` would serve from cache — a pure
        peek (no references taken), used by the router to score replicas."""
        full, partial = self.match(prompt)
        return len(full) * self.block_size + (partial.tokens if partial else 0)

    # -- reference management -------------------------------------------
    def acquire(self, blocks: list[int]) -> None:
        """Pin matched blocks: revive cached (refcount-0) entries, add a
        reference to live ones."""
        for b in blocks:
            if self.allocator.is_cached(b):
                self.allocator.reuse_cached(b)
            else:
                self.allocator.incref(b)

    def release(self, blocks: list[int]) -> None:
        """Drop one reference per block; indexed blocks park in the LRU
        cached pool (still matchable), unindexed ones free eagerly."""
        cached = [b for b in blocks if b in self.meta]
        plain = [b for b in blocks if b not in self.meta]
        if cached:
            self.allocator.free_cached(cached)
        if plain:
            self.allocator.free(plain)

    def parent_hash(self, blocks: list[int]) -> int:
        """Chain state after the given indexed prefix blocks (root if
        empty) — seed for incremental ``register`` calls."""
        return self.meta[blocks[-1]].hash if blocks else _ROOT

    # -- registration / eviction ----------------------------------------
    def register(
        self,
        prompt: list[int],
        blocks: list[int],
        upto: int,
        *,
        start_block: int = 0,
        parent: int = _ROOT,
    ) -> tuple[int, int]:
        """Index the full blocks of ``prompt[:upto]`` (already written to
        ``blocks``).  Idempotent; a hash already mapping to a *different*
        block keeps the first mapping (the newcomer keeps a private copy).

        ``start_block``/``parent`` resume the chain walk where a previous
        call left off, so per-chunk registration costs only the newly
        completed blocks instead of re-hashing the whole prefix; returns the
        updated ``(start_block, parent)`` pair to pass next time."""
        bs = self.block_size
        for j in range(start_block, min(upto, len(prompt)) // bs):
            toks = tuple(prompt[j * bs : (j + 1) * bs])
            h = chain_hash(parent, toks)
            b = blocks[j]
            if h not in self.by_hash and b not in self.meta:
                self.by_hash[h] = b
                self.meta[b] = _Entry(hash=h, parent=parent, tokens=toks)
                self.children.setdefault(parent, []).append(b)
                self.registered += 1
                if self._metrics is not None:
                    self._m_registered.inc()
            parent = h
            start_block = j + 1
        self._publish()
        return start_block, parent

    def _rekey(self, old: int, new: int, ent: _Entry) -> None:
        """Move an entry between ids (device block <-> spill handle) without
        touching the chain structure: hash map, meta and the parent's child
        list all follow; entries keyed by *hash* (children of this entry)
        are untouched — descendants stay reachable through the chain walk."""
        del self.meta[old]
        self.meta[new] = ent
        self.by_hash[ent.hash] = new
        sibs = self.children.get(ent.parent)
        if sibs and old in sibs:
            sibs[sibs.index(old)] = new

    def _on_evict(self, block: int) -> Optional[str]:
        """Allocator LRU eviction: demote the entry to the spill tier when a
        pool is attached and admits it, else drop it (with the stranding
        cascade).  The returned tier tag feeds the allocator's accounting."""
        ent = self.meta.get(block)
        if ent is None:
            return None
        if self.spill is not None and self._fetch is not None:
            handle = self.spill.put(self._fetch(block))
            if handle is not None:
                if block not in self.meta:
                    # reentrancy: the put's own byte-budget drop cascaded
                    # through an *ancestor* of this entry mid-spill, so the
                    # chain above it is gone and the rows are unmatchable —
                    # discard them rather than strand them in the pool
                    self.spill.discard(handle)
                    return "dropped"
                self._rekey(block, handle, ent)
                self.spilled += 1
                self._publish()
                return "spilled"
        self._drop_entry(block)
        return "dropped"

    def promote(self, handle: int, block: int) -> None:
        """Rewire a spilled entry onto a freshly-allocated device block (the
        caller has popped the rows from the pool and owns the swap-in)."""
        self._rekey(handle, block, self.meta[handle])
        self.promoted += 1
        self._publish()

    def demote(self, block: int, payload: dict) -> None:
        """Inverse of ``promote`` for a cancelled swap-in: re-park the rows
        in the pool and re-key the entry back to a spill handle.  When the
        pool refuses, the entry drops (the device block was never written,
        so it must not stay indexed — a later match would read garbage)."""
        ent = self.meta.get(block)
        if ent is None:
            return
        handle = self.spill.put(payload) if self.spill is not None else None
        if handle is None:
            self._drop_entry(block)
            return
        if block not in self.meta:
            # same reentrancy guard as ``_on_evict``: the put's budget drop
            # cascaded through an ancestor and already unmapped this entry
            self.spill.discard(handle)
            return
        self._rekey(block, handle, ent)
        self.demoted += 1
        self._publish()

    def _drop_entry(self, bid: int) -> None:
        """Unmap one entry and cascade over its now-unreachable descendants
        (matching always walks from the root, so a dropped parent strands
        its whole subtree): spilled descendants leave the pool, cached
        refcount-0 device descendants return to the free list
        (``uncache``), live ones are merely unindexed — their eventual
        release plain-frees them.  Also the ``SpillPool.on_drop`` hook."""
        ent = self.meta.pop(bid, None)
        if ent is None:
            return
        if self.by_hash.get(ent.hash) == bid:
            del self.by_hash[ent.hash]
        sibs = self.children.get(ent.parent)
        if sibs and bid in sibs:
            sibs.remove(bid)
            if not sibs:
                del self.children[ent.parent]
        for child in list(self.children.get(ent.hash, ())):
            self.stranded_dropped += 1
            if is_spilled(child):
                if self.spill is not None:
                    self.spill.discard(child)
            elif self.allocator.is_cached(child):
                self.allocator.uncache(child)
            self._drop_entry(child)
        self._publish()

    def stats(self) -> dict:
        spilled_entries = sum(1 for b in self.meta if is_spilled(b))
        return {
            "entries": len(self.by_hash),
            "device_entries": len(self.by_hash) - spilled_entries,
            "spilled_entries": spilled_entries,
            "registered": self.registered,
            "spilled": self.spilled,
            "promoted": self.promoted,
            "demoted": self.demoted,
            "stranded_dropped": self.stranded_dropped,
        }
