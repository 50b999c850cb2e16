"""Continuous-batching inference engine over a prefix-cached paged KV cache.

The port's counterpart of the JAX package's ``serving/engine.py``,
reduced to the paged dense path and its legacy step walk:

* **Paged cache**: a global block pool per layer plus per-request block
  tables (``serving.paged.BlockAllocator``).  Admission is gated on free
  blocks: a request reserves ``ceil((prompt + max_new_tokens) /
  block_size)`` blocks minus whatever the prefix cache already holds.
* **Prefix caching** (``serving.prefix``): every full block of a prefilled
  context is indexed by a content chain hash.  Admission matches the
  longest cached prefix, pins the shared blocks, copies a partial tail hit
  into a private block (copy-on-write) and schedules only the suffix.
* **Chunked prefill**: prompts stream in per-``step()`` budgeted chunks
  (``prefill_budget`` tokens per step, split into power-of-two chunks by
  ``scheduler.binary_chunks``) through ``models.prefill_step`` and the K2
  kernel; a mid-prefill slot keeps a null row in the engine block table so
  interleaved decode steps can't touch its blocks.
* **Decode**: every ``step()`` runs one scheduler pass
  (``scheduler.SchedulerCore``: admission with SLO preemption, then the
  prefill budget), then one batched ``models.decode_step`` over all
  ``max_batch`` slots (the K1 kernel) and one sampling call.

Options of the JAX engine that the port does not have yet raise
``NotImplementedError`` naming the option: ``spec_decode``, ``fused``,
``spill_bytes``, ``quantize_kv``, ``mesh``, ``cache_kind="dense"`` and
families other than dense.

Observability as in the JAX engine (``serving.metrics`` +
``serving.trace``): one injectable ``clock`` feeds every timestamp,
latencies land in histograms and request-lifecycle events in the tracer's
ring buffer.  A token's timestamp is taken after its value reached the
host, so on the card the latencies include the device work.
"""

from __future__ import annotations

import itertools
import time
import warnings
from typing import Optional

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.models import decode_step, init_paged_cache, prefill_step
from repro_torch.models.attention import ATTN_IMPLS
from repro_torch.serving.kvcache import copy_block_rows, make_table_row
from repro_torch.serving.metrics import MetricsRegistry
from repro_torch.serving.paged import BlockAllocator, blocks_needed, truncate_blocks
from repro_torch.serving.prefix import PrefixIndex
from repro_torch.serving.sampler import sample_token, sample_tokens
from repro_torch.serving.scheduler import Request, RequestState, SchedulerCore
from repro_torch.serving.trace import SCHEDULER_TRACK, Tracer, slot_track


class InferenceEngine:
    def __init__(
        self,
        cfg,
        params,
        *,
        max_batch: int = 4,
        max_seq: int = 512,
        eos_token: int = 1,
        seed: int = 0,
        cache_kind: str = "paged",
        block_size: int = 32,
        num_blocks: Optional[int] = None,
        cache_dtype=torch.bfloat16,
        quantize_kv: bool | str = False,
        attn_impl: str = "kernel",
        fused: bool = False,
        prefix_cache: Optional[bool] = None,
        prefill_budget: int = 0,
        policy: str = "slo",
        defrag_threshold: float = 0.5,
        spill_bytes: int = 0,
        spec_decode: str = "off",
        mesh=None,
        clock=None,
        metrics: Optional[MetricsRegistry] = None,
        tracer: Optional[Tracer] = None,
        trace_capacity: int = 4096,
        device="cuda",
    ):
        if cfg.is_encoder_only:
            raise ValueError(f"{cfg.name} is encoder-only; no decode serving")
        for name, value, default in (
            ("spec_decode", spec_decode, "off"),
            ("fused", fused, False),
            ("spill_bytes", spill_bytes, 0),
            ("quantize_kv", quantize_kv, False),
            ("mesh", mesh, None),
        ):
            if value != default:
                raise NotImplementedError(f"{name}={value!r} is not ported yet")
        if cache_kind != "paged":
            raise NotImplementedError(f"cache_kind={cache_kind!r} is not ported yet (only 'paged')")
        if cfg.family != "dense":
            raise NotImplementedError(f"family {cfg.family!r} ({cfg.name}) is not ported yet")
        if attn_impl not in ATTN_IMPLS:
            raise ValueError(f"attn_impl={attn_impl!r} (choose from {ATTN_IMPLS})")
        self.device = resolve_device(device)
        if params["embed"]["tok"].device.type != self.device.type:
            raise ValueError(f"params are on {params['embed']['tok'].device}, engine on {self.device}")
        self.cfg = cfg
        self.params = params
        self.max_batch = max_batch
        self.max_seq = max_seq
        self.eos = eos_token
        self.cache_kind = cache_kind
        self.attn_impl = attn_impl

        # ---- observability: one injectable clock feeds every timestamp,
        # one registry collects every counter/gauge/histogram, one bounded
        # ring buffer records the request-lifecycle events
        self._clock = clock if clock is not None else time.monotonic
        self.metrics = metrics if metrics is not None else MetricsRegistry()
        self.tracer = tracer if tracer is not None else Tracer(self._clock, trace_capacity)
        M = self.metrics
        self._c_submitted = M.counter("engine_requests_submitted_total", "requests accepted by submit()")
        self._c_admitted = M.counter("engine_requests_admitted_total", "requests admitted into a batch slot")
        self._c_finished = M.counter("engine_requests_finished_total", "requests finished (EOS or max_new_tokens)")
        self._c_tokens = M.counter("engine_tokens_out_total", "generated tokens emitted")
        self._c_prefill_tokens = M.counter("engine_prefill_tokens_total", "prompt tokens computed (prefix hits excluded)")
        self._c_prefix_hit = M.counter("engine_prefix_hit_tokens_total", "prompt tokens served from the prefix cache")
        self._c_preempted = M.counter("engine_preemptions_total", "scheduler evictions of running requests")
        self._c_deadline_miss = M.counter("engine_deadline_violations_total", "finished requests whose TTFT missed deadline_s")
        self._c_aborted = M.counter("engine_requests_aborted_total", "requests aborted (client cancel, deadline, migration)")
        self._h_queue_wait = M.histogram("engine_queue_wait_seconds", "submit to admission")
        self._h_ttft = M.histogram("engine_ttft_seconds", "submit to first generated token")
        self._h_admit_first = M.histogram("engine_admit_to_first_token_seconds", "admission to first generated token")
        self._h_tpot = M.histogram("engine_tpot_seconds", "mean inter-token time per finished request")
        self._h_step = M.histogram("engine_step_seconds", "wall time of one engine step()")
        self._h_prefill_chunk = M.histogram("engine_prefill_chunk_seconds", "one chunked-prefill call")
        self._h_decode = M.histogram(
            "engine_decode_seconds", "one batched decode step and its sampling, tokens on the host"
        )
        self._g_queue = M.gauge("engine_queue_depth", "requests waiting for admission")
        self._g_active = M.gauge("engine_active_slots", "slots decoding")
        self._g_prefilling = M.gauge("engine_prefilling_slots", "slots mid chunked prefill")

        # scheduling brain: queue ordering (SLO/FCFS), admission, preemption
        # decisions and the chunked-prefill budget live in SchedulerCore; the
        # engine provides the execution primitives (try_admit / run_chunk /
        # finish_prefill / preempt / ...) below
        self.scheduler = SchedulerCore(self, policy=policy, prefill_budget=prefill_budget)
        self.defrag_threshold = defrag_threshold

        self.block_size = block_size
        self.max_blocks_per_seq = -(-max_seq // block_size)
        if num_blocks is None:
            # default: one full-length sequence per slot (+ the null block)
            num_blocks = max_batch * self.max_blocks_per_seq + 1
        self.num_blocks = num_blocks
        self.allocator = BlockAllocator(num_blocks)
        self.prefix = PrefixIndex(self.allocator, block_size) if prefix_cache is None or prefix_cache else None
        # the allocator publishes pool occupancy into the shared registry;
        # the engine wraps the eviction callback (the prefix index set its
        # unmap hook) so LRU reclaims surface as trace events too
        self.allocator.attach_metrics(self.metrics)
        if self.prefix is not None:
            self.prefix.attach_metrics(self.metrics)
        self._g_frag = self.metrics.gauge("pool_fragmentation", "allocator free-list fragmentation")
        inner_evict = self.allocator.on_evict

        def _evict_hook(block, _inner=inner_evict):
            tier = _inner(block) if _inner is not None else None
            self.tracer.instant("evict", track=SCHEDULER_TRACK, block=block)
            return tier

        self.allocator.on_evict = _evict_hook
        self.tbl = np.zeros((max_batch, self.max_blocks_per_seq), np.int32)
        self._tbl_dirty = True
        self.cache = init_paged_cache(
            cfg, num_blocks, block_size, max_batch, self.max_blocks_per_seq, cache_dtype, device=self.device
        )

        self.pos = np.zeros((max_batch,), np.int32)  # next position per slot
        self.slots: list[Optional[Request]] = [None] * max_batch
        self.done: list[Request] = []
        self._preempted_ids: set[int] = set()  # distinct requests ever evicted
        self.deadline_violations = 0  # finished with ttft > deadline_s
        self.aborts = 0  # requests aborted (cancel / deadline / migration)
        self._ids = itertools.count()
        self._gen = torch.Generator(device=self.device).manual_seed(seed)
        self.steps = 0
        self.tokens_out = 0
        self.peak_active = 0
        self.prefill_chunks = 0
        self.prefill_tokens = 0  # prompt tokens actually run through the model
        self.prefix_hits = 0
        self.prefix_partial_hits = 0
        self.prefix_hit_tokens = 0  # prompt tokens served from cached blocks
        self.defrag_triggers = 0
        self._frees_seen = 0  # auto-defrag: only re-check after new frees

    # ------------------------------------------------------------------
    @property
    def queue(self) -> list[Request]:
        """Waiting requests in policy order — owned by the scheduler core."""
        return self.scheduler.queue

    @property
    def _prefilling(self) -> list[Request]:
        return self.scheduler.prefilling

    @property
    def has_work(self) -> bool:
        """True while any request is waiting, prefilling or decoding."""
        return bool(self.scheduler.queue) or any(s is not None for s in self.slots)

    def submit(
        self,
        prompt: list[int],
        *,
        max_new_tokens: int = 32,
        online: bool = True,
        temperature: float = 0.0,
        top_k: int = 0,
        priority: int = 0,
        deadline_s: Optional[float] = None,
    ) -> Request:
        if not prompt:
            raise ValueError("empty prompt")
        if max_new_tokens < 1:
            raise ValueError(f"max_new_tokens={max_new_tokens} (need >= 1)")
        if priority < 0:
            raise ValueError(f"priority={priority} (need >= 0)")
        if deadline_s is not None and deadline_s <= 0:
            raise ValueError(f"deadline_s={deadline_s} (need > 0, or None)")
        total = len(prompt) + max_new_tokens
        if total > self.max_seq:
            raise ValueError(f"prompt+max_new_tokens={total} exceeds max_seq={self.max_seq}")
        if blocks_needed(total, self.block_size) > self.allocator.capacity:
            raise ValueError(
                f"request needs {blocks_needed(total, self.block_size)} blocks, "
                f"pool capacity is {self.allocator.capacity}"
            )
        req = Request(
            req_id=next(self._ids),
            prompt=list(prompt),
            max_new_tokens=max_new_tokens,
            online=online,
            priority=priority,
            deadline_s=deadline_s,
            temperature=temperature,
            top_k=top_k,
            submit_t=self._clock(),
        )
        self.scheduler.enqueue(req)
        self._c_submitted.inc()
        self._g_queue.set(len(self.queue))
        self.tracer.instant(
            "submit", track=SCHEDULER_TRACK, req_id=req.req_id, prompt_len=len(req.prompt),
            online=online, priority=priority,
        )
        return req

    # ---- scheduler ops surface (see SchedulerCore's table) -----------
    def free_slots(self) -> list[int]:
        return [i for i, r in enumerate(self.slots) if r is None]

    def running(self) -> list[Request]:
        """Requests holding a slot (decoding or mid-prefill)."""
        return [r for r in self.slots if r is not None]

    def chunked(self) -> bool:
        return True

    def can_preempt(self) -> bool:
        return True

    def try_admit(self, req: Request, slot: int) -> bool:
        return self._admit_chunked(req, slot)

    def _release_request_blocks(self, req: Request, written: int) -> None:
        """Drop a leaving request's blocks: the tail past ``written`` frees
        eagerly, the kept span routes through the prefix index."""
        kept, tail = truncate_blocks(req.blocks, written, self.block_size)
        if tail:
            self.allocator.free(tail)
        self._release_blocks(kept[req.freed_blocks :])
        req.blocks = []
        req.freed_blocks = 0

    def _clear_slot(self, slot: int) -> None:
        self.slots[slot] = None
        self.pos[slot] = 0
        self.tbl[slot] = 0  # null block
        self._tbl_dirty = True

    def preempt(self, req: Request) -> None:
        """Evict a running request: park its committed K/V in the prefix
        cache (LRU pool), free everything else, clear its slot and mark it
        WAITING so the scheduler can requeue it.  The cache holds K/V for
        positions ``[0, written)``: ``len(ctx) - 1`` for a decoding request,
        ``prefill_pos`` for a mid-prefill one."""
        slot = req.slot
        written = int(req.prefill_pos if req.prefilling else self.pos[slot])
        if self.prefix is not None and req.freed_blocks == 0:
            # index the committed context up to the written position
            req.reg_block, req.reg_parent = self.prefix.register(
                req.context(), req.blocks, written, start_block=req.reg_block, parent=req.reg_parent
            )
        self._release_request_blocks(req, written)
        req.prefill_pos = 0
        req.prefilling = False
        req.reg_block = 0
        req.reg_parent = 0
        req.state = RequestState.WAITING
        req.slot = None
        req.preemptions += 1
        self._preempted_ids.add(req.req_id)
        self._c_preempted.inc()
        self._clear_slot(slot)
        self.tracer.instant(
            "preempt", track=slot_track(slot), req_id=req.req_id, committed_tokens=written,
            generated=len(req.generated), priority=req.priority,
        )

    # ------------------------------------------------------------------
    def find_request(self, req_id: int) -> Optional[Request]:
        """A live (waiting or active) request by id, or None."""
        for r in self.queue:
            if r.req_id == req_id:
                return r
        for r in self.slots:
            if r is not None and r.req_id == req_id:
                return r
        return None

    def abort(self, req, reason: str = "aborted") -> bool:
        """Abort a queued, prefilling or decoding request, releasing its slot
        and blocks (the committed span parks in the prefix cache).  Accepts
        a ``Request`` or a request id; returns False when the request is
        unknown or already finished."""
        if isinstance(req, int):
            req = self.find_request(req)
        if req is None or req.state == RequestState.DONE:
            return False
        slot = req.slot
        if req.state == RequestState.WAITING:
            if not self.scheduler.dequeue(req):
                return False
        else:  # ACTIVE: mid-prefill or decoding, holds a slot
            self.scheduler.drop_prefilling(req)
            written = int(req.prefill_pos if req.prefilling else self.pos[slot])
            self._release_request_blocks(req, written)
            self._clear_slot(slot)
            req.prefilling = False
            req.slot = None
        req.state = RequestState.DONE
        req.finish_reason = reason
        req.done_t = self._clock()
        self.aborts += 1
        self._c_aborted.inc()
        if reason == "deadline_exceeded":
            self.deadline_violations += 1
            self._c_deadline_miss.inc()
        self.tracer.instant(
            "abort", track=SCHEDULER_TRACK if slot is None else slot_track(slot),
            req_id=req.req_id, reason=reason, generated=len(req.generated),
        )
        self._g_queue.set(len(self.queue))
        self.done.append(req)
        return True

    def _enforce_deadlines(self) -> None:
        """Abort requests whose TTFT deadline passed with no first token."""
        now = self._clock()
        at_risk = [
            r
            for r in list(self.queue) + [s for s in self.slots if s is not None]
            if r.first_token_t is None and now > r.deadline_t
        ]
        for r in at_risk:
            self.abort(r, reason="deadline_exceeded")

    # ------------------------------------------------------------------
    def _note_admit(self, req: Request, slot: int) -> None:
        req.admit_t = self._clock()
        self._c_admitted.inc()
        self._h_queue_wait.observe(req.admit_t - req.submit_t)
        self.tracer.instant(
            "admit", track=slot_track(slot), req_id=req.req_id, prompt_len=len(req.prompt),
            prefix_hit_tokens=req.prefix_hit_tokens, blocks=len(req.blocks),
        )
        if req.preemptions:
            self.tracer.instant(
                "resume", track=slot_track(slot), req_id=req.req_id, preemptions=req.preemptions,
                generated=len(req.generated), recovered_tokens=req.prefill_pos,
            )

    def _release_blocks(self, blocks: list[int]) -> None:
        """Drop this request's references; the prefix index parks indexed
        blocks in the LRU cached pool, everything else frees eagerly."""
        if not blocks:
            return
        if self.prefix is not None:
            self.prefix.release(blocks)
        else:
            self.allocator.free(blocks)

    def _admit_chunked(self, req: Request, slot: int) -> bool:
        """Prefix-matched, block-budgeted admission (no model call: context
        chunks run inside later ``step()`` prefill budgets).  Returns False
        when the pool can't cover the request's unshared blocks.  A resumed
        (previously preempted) request admits with its committed context
        ``prompt + generated`` in place of the prompt."""
        needed = blocks_needed(len(req.prompt) + req.max_new_tokens, self.block_size)
        ctx = req.context()
        full, partial = self.prefix.match(ctx) if self.prefix is not None else ([], None)
        need_new = needed - len(full)
        if self.prefix is not None:
            # pin matched blocks first so the free-count check below can't
            # hand them out as eviction victims
            self.prefix.acquire(full)
            if partial is not None:
                self.prefix.acquire([partial.block])
        if need_new > self.allocator.num_free:
            if self.prefix is not None:
                self.prefix.release(full)
                if partial is not None:
                    self.prefix.release([partial.block])
            return False  # out of blocks: backpressure until frees
        reg_parent = self.prefix.parent_hash(full) if self.prefix is not None else 0
        new_blocks = self.allocator.alloc(need_new)
        req.blocks = list(full) + new_blocks
        matched = len(full) * self.block_size
        if partial is not None:
            # copy-on-write: the partially-shared block's rows move into the
            # request's first private block; its suffix is overwritten by
            # the first prefill chunk while the cached original stays put
            copy_block_rows(self.cache, partial.block, new_blocks[0])
            self.prefix.release([partial.block])
            matched += partial.tokens
            self.prefix_partial_hits += 1
        if matched:
            self.prefix_hits += 1
            self.prefix_hit_tokens += matched
            req.prefix_hit_tokens += matched  # accumulates across resumes
            self._c_prefix_hit.inc(matched)
        if self.prefix is not None:
            # registration resumes after the matched (already indexed) blocks
            req.reg_block = len(full)
            req.reg_parent = reg_parent
        req.prefill_pos = matched
        req.prefilling = True
        req.state = RequestState.ACTIVE
        req.slot = slot
        self.slots[slot] = req
        self.peak_active = max(self.peak_active, sum(r is not None for r in self.slots))
        self.pos[slot] = matched
        self._note_admit(req, slot)
        # the engine table row stays null until the prompt completes, so
        # interleaved decode steps write into the scratch null block
        self._prefilling.append(req)
        return True

    def _emit_first_token(self, req: Request, logits: torch.Tensor) -> None:
        tok = sample_token(logits, req.temperature, self._gen, top_k=req.top_k)
        req.generated.append(tok)
        req.first_token_t = self._clock()
        self.tokens_out += 1
        self._c_tokens.inc()
        self._h_ttft.observe(req.first_token_t - req.submit_t)
        if req.admit_t is not None:
            self._h_admit_first.observe(req.first_token_t - req.admit_t)
        self.tracer.instant("first_token", track=slot_track(req.slot), req_id=req.req_id)
        self._finish_if_done(req)

    # ------------------------------------------------------------------
    def _device_ints(self, values) -> torch.Tensor:
        return torch.as_tensor(np.asarray(values, np.int32), device=self.device)

    def run_chunk(self, req: Request, c: int) -> torch.Tensor:
        """Run one c-token context chunk; returns the chunk's last logits."""
        ctx = req.context()
        start = req.prefill_pos
        toks = self._device_ints(ctx[start : start + c])[None]
        row = self._device_ints(make_table_row(req.blocks, self.max_blocks_per_seq))[None]
        t0 = self._clock()
        logits, self.cache = prefill_step(
            self.cfg, self.params, self.cache, toks, self._device_ints([start]), row,
            attn_impl=self.attn_impl,
        )
        self._h_prefill_chunk.observe(self._clock() - t0)
        self.tracer.span(
            "prefill_chunk", t0, track=slot_track(req.slot), req_id=req.req_id, pos=start, tokens=c
        )
        req.prefill_pos += c
        self.pos[req.slot] = req.prefill_pos
        self.prefill_chunks += 1
        self.prefill_tokens += c
        self._c_prefill_tokens.inc(c)
        if self.prefix is not None:
            # index the newly-completed full context blocks (written above)
            req.reg_block, req.reg_parent = self.prefix.register(
                ctx, req.blocks, req.prefill_pos, start_block=req.reg_block, parent=req.reg_parent
            )
        return logits

    def finish_prefill(self, req: Request, logits) -> None:
        """Context complete: publish the block table to the decode path.  A
        fresh request samples its first token from the last chunk's logits;
        a resumed one already holds it and re-feeds it at the next decode."""
        self.tbl[req.slot] = make_table_row(req.blocks, self.max_blocks_per_seq)
        self._tbl_dirty = True
        self.pos[req.slot] = req.prefill_target
        req.prefilling = False
        if not req.generated:
            self._emit_first_token(req, logits[0])

    # ------------------------------------------------------------------
    def _finish_if_done(self, req: Request) -> None:
        if req.state != RequestState.ACTIVE:
            return
        eos = bool(req.generated) and req.generated[-1] == self.eos
        if len(req.generated) < req.max_new_tokens and not eos:
            return
        req.state = RequestState.DONE
        req.finish_reason = "eos" if eos else "length"
        req.done_t = self._clock()
        slot = req.slot
        self._c_finished.inc()
        if req.tpot is not None:
            self._h_tpot.observe(req.tpot)
        if req.deadline_s is not None and req.ttft is not None and req.ttft > req.deadline_s:
            self.deadline_violations += 1
            self._c_deadline_miss.inc()
        self.tracer.instant(
            "finish", track=slot_track(slot), req_id=req.req_id, reason=req.finish_reason,
            tokens=len(req.generated),
        )
        if req.admit_t is not None:
            # one span covering the request's residency in its slot
            self.tracer.span(
                f"req {req.req_id}", req.admit_t, end=req.done_t, track=slot_track(slot),
                req_id=req.req_id, tokens=len(req.generated), prefix_hit_tokens=req.prefix_hit_tokens,
            )
        # token-level truncate at the final committed length: tail blocks
        # hold unused reserve and free eagerly; the kept span routes through
        # the prefix index
        self._release_request_blocks(req, len(req.prompt) + len(req.generated))
        self._clear_slot(slot)
        self.done.append(req)

    def _reclaim_window_blocks(self, req: Request) -> None:
        """Sliding-window archs: drop blocks that slid out of the window.  A
        block covering positions [i*bs, (i+1)*bs) is dead once
        (i+1)*bs - 1 <= next_pos - W; its table entry points back at the
        null block (the window mask already excludes those positions)."""
        W = self.cfg.sliding_window
        if W <= 0:
            return
        nxt = int(self.pos[req.slot])
        d = min((nxt - W + 1) // self.block_size, len(req.blocks))
        if d <= req.freed_blocks:
            return
        self._release_blocks(req.blocks[req.freed_blocks : d])
        self.tbl[req.slot, req.freed_blocks : d] = 0
        req.freed_blocks = d
        self._tbl_dirty = True

    def _maybe_defrag(self) -> None:
        """Auto-defrag: sort the free list when scatter exceeds the
        threshold, re-checked only after new frees."""
        if self.defrag_threshold >= 1.0 or self.allocator.total_frees == self._frees_seen:
            return
        self._frees_seen = self.allocator.total_frees
        if self.allocator.fragmentation() > self.defrag_threshold:
            self.allocator.defrag()
            self.defrag_triggers += 1

    def _sync_tables(self) -> None:
        if self._tbl_dirty:
            self.cache["tbl"].copy_(torch.from_numpy(self.tbl))
            self._tbl_dirty = False

    def step(self) -> int:
        """One engine iteration: one scheduling pass (admission with SLO
        preemption, then the chunked-prefill budget), then advance all
        decoding slots by one batched decode step and one sampling call."""
        t0 = self._clock()
        self._enforce_deadlines()
        self.scheduler.schedule()
        self.peak_active = max(self.peak_active, sum(r is not None for r in self.slots))
        active = [r for r in self.slots if r is not None and not r.prefilling]
        produced = 0
        if active:
            self._sync_tables()
            tokens = np.zeros((self.max_batch, 1), np.int32)
            temps = np.zeros((self.max_batch,), np.float32)
            top_ks = np.zeros((self.max_batch,), np.int32)
            for r in active:
                tokens[r.slot, 0] = r.generated[-1]
                temps[r.slot] = r.temperature
                top_ks[r.slot] = r.top_k
            t_decode = self._clock()
            logits, self.cache = decode_step(
                self.cfg, self.params, self.cache, self._device_ints(tokens), self._device_ints(self.pos),
                attn_impl=self.attn_impl,
            )
            self.steps += 1
            # one whole-batch sampling call; the all-greedy batch (the common
            # serving default) skips the sort/multinomial work
            if all(r.temperature <= 0.0 for r in active):
                sampled = torch.argmax(logits, dim=-1).cpu().numpy()
            else:
                sampled = sample_tokens(
                    logits, torch.as_tensor(temps, device=self.device),
                    torch.as_tensor(top_ks, device=self.device), self._gen,
                ).cpu().numpy()
            self._h_decode.observe(self._clock() - t_decode)
            for r in active:
                tok = int(sampled[r.slot])
                r.generated.append(tok)
                self.pos[r.slot] += 1
                produced += 1
                self.tokens_out += 1
                self._c_tokens.inc()
                self._reclaim_window_blocks(r)
                self._finish_if_done(r)
        self._maybe_defrag()
        self._note_step(t0, produced)
        return produced

    def _note_step(self, t0: float, produced: int) -> None:
        """Per-step observability tail: step latency + span, gauges."""
        dt = max(self._clock() - t0, 0.0)
        self._h_step.observe(dt)
        self.tracer.span("step", t0, end=t0 + dt, track=SCHEDULER_TRACK, produced=produced)
        self._g_queue.set(len(self.queue))
        self._g_active.set(sum(r is not None and not r.prefilling for r in self.slots))
        self._g_prefilling.set(len(self._prefilling))
        self._g_frag.set(self.allocator.fragmentation())

    def run_until_drained(self, max_steps: int = 10_000) -> list[Request]:
        """Closed-loop drain: step until no request is waiting, prefilling
        or decoding."""
        for _ in range(max_steps):
            if not self.has_work:
                break
            self.step()
        else:
            n_queued = len(self.queue)
            n_active = sum(r is not None for r in self.slots)
            if n_queued or n_active:
                warnings.warn(
                    f"run_until_drained exhausted max_steps={max_steps} with "
                    f"{n_queued} queued and {n_active} active requests unfinished",
                    RuntimeWarning,
                    stacklevel=2,
                )
        return self.done

    # ------------------------------------------------------------------
    def cache_bytes(self) -> int:
        """Device bytes held by the engine's KV cache (pools + table)."""
        return sum(t.numel() * t.element_size() for t in self.cache.values())

    def stats(self) -> dict:
        """Engine counters, as the JAX engine's ``stats()`` for the paged
        path.  A defensive snapshot: every value is a scalar or a fresh dict,
        every derived rate division-by-zero guarded.  ``done + queued +
        active + prefilling`` equals every request ever submitted."""
        ttfts = [r.ttft for r in self.done if r.ttft is not None]
        s = {
            "cache_kind": self.cache_kind,
            "scheduler_policy": self.scheduler.policy,
            "preemptions": self.scheduler.preemptions,
            "requests_preempted": len(self._preempted_ids),
            "deadline_violations": self.deadline_violations,
            "requests_aborted": self.aborts,
            "requests_done": len(self.done),
            "requests_queued": len(self.queue),
            "requests_active": sum(r is not None and not r.prefilling for r in self.slots),
            "requests_prefilling": len(self._prefilling),
            "decode_steps": self.steps,
            "tokens_out": self.tokens_out,
            "mean_ttft_s": float(np.mean(ttfts)) if ttfts else None,
            "ttft_p50_s": self._h_ttft.percentile(50),
            "ttft_p99_s": self._h_ttft.percentile(99),
            "tpot_p50_s": self._h_tpot.percentile(50),
            "tpot_p99_s": self._h_tpot.percentile(99),
            "slot_utilization": 1.0 - len(self.free_slots()) / self.max_batch if self.max_batch else 0.0,
            "peak_active": self.peak_active,
            "cache_bytes": self.cache_bytes(),
            "prefill_chunks": self.prefill_chunks,
            "prefill_tokens": self.prefill_tokens,
            "block_size": self.block_size,
            "defrag_triggers": self.defrag_triggers,
            "evictions": self.allocator.evictions,
        }
        s.update({f"alloc_{k}": v for k, v in self.allocator.stats().items()})
        if self.prefix is not None:
            served = self.prefix_hit_tokens + self.prefill_tokens
            s["prefix_hits"] = self.prefix_hits
            s["prefix_partial_hits"] = self.prefix_partial_hits
            s["prefix_hit_tokens"] = self.prefix_hit_tokens
            s["prefix_hit_rate"] = self.prefix_hit_tokens / served if served else 0.0
            s.update({f"prefix_{k}": v for k, v in self.prefix.stats().items()})
        return s
