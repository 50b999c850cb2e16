"""Continuous-batching inference engine over a prefix-cached paged KV cache.

The port's counterpart of the JAX package's ``serving/engine.py`` for the
dense family.  Two cache layouts:

* ``cache_kind="paged"`` (default): block pools and per-request block
  tables, with everything below.
* ``cache_kind="dense"``: the slot-granular ring cache
  (``kvcache.make_engine_cache``), the JAX engine's A/B baseline.  A
  request admits with one blocking whole-prompt ``models.prefill``
  (right-padded to a power-of-two bucket, logits at the last real token),
  its K/V written into its batch slot (``kvcache.write_prefill_into_slot``)
  and its first token sampled from the prefill's logits; ``decode_step``
  then reads the ring cache in tensor ops (no kernel, as in the JAX
  package).  A freed slot is emptied (``kvcache.clear_slot``).  The paged
  options (prefix cache, prefill budget, speculative decoding, quantized
  pools, the spill tier) warn and are ignored, ``fused=True`` raises, and
  no request is preempted, as in the JAX engine.

The paged layout:

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
* **Fused one-dispatch step** (``fused=True``): the scheduler emits a
  typed ``StepPlan`` instead of walking phases, and each tick is one call
  over a unified (rows, width) batch.  Pure-decode ticks run
  ``decode_step`` with sampling folded in; mixed ticks run decode rows and
  prefill chunks together through ``models.unified_step`` (K2 for every
  row) and ``sampler.fused_sample_accept``.  On the card each tick is one
  replay of a CUDA graph (``serving.graphs``); on the CPU the same step
  functions run eagerly.  The host reads the tick's tokens in one sync.
  As in the JAX engine, a prompt that completes mid-tick joins decode one
  tick later than in the legacy walk: token sequences are unchanged.
* **Speculative decoding** (``spec_decode="ngram"|"draft"``): each step
  drafts up to ``spec_k`` tokens per slot (``serving.spec_decode``: n-gram
  prompt lookup, or a reduced-depth draft model over per-slot dense ring
  caches) and scores the whole window in one verify pass through the
  chunked-prefill machinery (``models.verify_step``, K2).
  ``sampler.spec_accept`` keeps the longest prefix the target agrees with
  plus one correction or bonus token, and the rejected tail's K/V rows are
  zeroed (``kvcache.truncate_block_rows``).  Admission reserves ``spec_k``
  positions of headroom per request, so verify writes land in the
  request's own blocks.  The legacy walk runs one verify call, one
  ``spec_accept`` call and one batched rollback a step; with ``fused``,
  every spec tick is a mixed tick whose verify rows ride the (rows, width)
  batch, with the accept and the rollback inside the same call (one graph
  replay on the card).  Greedy tokens equal plain decoding's.
* **Quantized pools** (``quantize_kv="int8"|"fp8"``, ``True`` for int8):
  the block pools store int8 / e4m3 rows with fp32 per-(token, head)
  scales (``serving.kvquant``), quantized at every write site inside the
  step (so inside the fused step's graphs too).  They read through the
  dequantizing plain path on every device: the JAX package has no kernel
  for them either, and the engine warns when ``attn_impl="kernel"``.
* **Tiered KV cache** (``spill_bytes=``, ``spill_dtype=``): the pool is
  backed by a host-RAM spill tier (``serving.spill.SpillPool``).  An LRU
  eviction of a prefix-cached block demotes its rows to host memory, the
  index entry stays matchable under a spill handle, and a later prefix hit
  swaps the rows back into fresh device blocks (``kvcache.restore_block_rows``)
  under a per-step ``restore_budget``, in one batched in-place scatter a
  scheduler pass.  The scheduler skips a request's prefill until its
  swap-ins land; preempt and abort cancel pending swap-ins first and
  demote their payloads back to the pool.  In the fused walk the restores
  run eagerly between graph replays, from ``plan()``'s restore pass.

Dispatches and host syncs are counted at the JAX engine's seams
(``_dispatch``, ``_host_fetch``, the first-token sample), and ``stats()``
reports them per step.  ``profile=True`` brackets each dispatch with the
engine's clock and a device sync (``_block_until_ready``, one counted host
sync each): the seconds land in ``engine_profile_<phase>_seconds``
histograms and each step span's ``phases``; off by default, when it adds
no sync.  An ``EnergyBridge`` (``serving.metrics``, the H100's power model
in ``core.telemetry``) charges each step's card-seconds at the step's slot
occupancy and splits the joules over the requests that computed tokens in
it, by tokens: ``Request.energy_j``, ``stats()["energy_joules"]`` and
``["joules_per_token"]``.

Options of the JAX engine that the port does not have yet raise
``NotImplementedError`` naming the option: ``mesh`` and families other
than dense.

Observability as in the JAX engine (``serving.metrics`` +
``serving.trace``): one injectable ``clock`` feeds every timestamp,
latencies land in histograms and request-lifecycle events in the tracer's
ring buffer.  A token's timestamp is taken after its value reached the
host, so on the card the latencies include the device work.

Front-ends: ``on_token(req, new_tokens)`` and ``on_finish(req)`` (None
by default) fire where the JAX engine fires them, on the thread that
steps, at every emission batch and at every finish or abort.
``serving.async_engine.AsyncEngine`` streams through them (its steps and
aborts on one stepping thread) and ``serving.router.Router`` hooks each
replica's engine.  ``stats()`` reads host state only, so an HTTP handler
may call it while a step, even a graph capture, runs on another thread.
"""

from __future__ import annotations

import itertools
import time
import warnings
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.device import resolve_device
from repro_torch.models import (
    decode_step,
    init_paged_cache,
    init_params,
    prefill,
    prefill_step,
    unified_step,
    verify_step,
)
from repro_torch.models.attention import ATTN_IMPLS
from repro_torch.serving.graphs import StepGraphs
from repro_torch.serving.kvcache import (
    clear_block_row,
    clear_slot,
    copy_block_rows,
    gather_block_rows,
    make_engine_cache,
    make_table_row,
    restore_block_rows,
    truncate_block_rows,
    write_prefill_into_slot,
)
from repro_torch.serving.kvquant import normalize_kv_quant
from repro_torch.serving.metrics import EnergyBridge, MetricsRegistry
from repro_torch.serving.paged import BlockAllocator, blocks_needed, truncate_blocks
from repro_torch.serving.prefix import PrefixIndex, is_spilled
from repro_torch.serving.sampler import fused_sample_accept, sample_token, sample_tokens, spec_accept
from repro_torch.serving.scheduler import Request, RequestState, SchedulerCore
from repro_torch.serving.spec_decode import DraftModel, make_draft_config, ngram_draft
from repro_torch.serving.spill import SPILL_MODES, SpillPool, warn_if_fp8_over_int8
from repro_torch.serving.trace import SCHEDULER_TRACK, Tracer, slot_track


def _block_until_ready(device: torch.device) -> None:
    """Wait for the work queued on ``device``: the profiler's seam, a
    module-level name so that a caller can count its calls (``profile=False``
    must never reach it)."""
    if device.type == "cuda":
        torch.cuda.current_stream(device).synchronize()


# the blocking prefill pads prompts to a power-of-two bucket: exact for the
# dense family (causal attention: pad positions never reach earlier K/V or
# the last real token's logits)
MIN_PREFILL_BUCKET = 8


@dataclass
class _RestoreTask:
    """One pending spill swap-in: ``payload`` rows destined for device block
    ``dst``.  ``cow`` marks a partial-tail restore whose canonical entry
    stays in the pool (a cancel must not demote the private copy back)."""

    dst: int
    payload: dict
    cow: bool
    t0: float


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
        spill_dtype: str = "cache",
        restore_budget: int = 4,
        spec_decode: str = "off",
        spec_k: int = 4,
        draft_cfg=None,
        draft_params=None,
        mesh=None,
        clock=None,
        metrics: Optional[MetricsRegistry] = None,
        tracer: Optional[Tracer] = None,
        trace_capacity: int = 4096,
        profile: bool = False,
        energy: Optional[EnergyBridge] = None,
        device="cuda",
    ):
        if cfg.is_encoder_only:
            raise ValueError(f"{cfg.name} is encoder-only; no decode serving")
        if mesh is not None:
            raise NotImplementedError(f"mesh={mesh!r} is not ported yet")
        if cache_kind not in ("paged", "dense"):
            raise ValueError(f"cache_kind={cache_kind!r}")
        if cfg.family != "dense":
            raise NotImplementedError(f"family {cfg.family!r} ({cfg.name}) is not ported yet")
        if attn_impl not in ATTN_IMPLS:
            raise ValueError(f"attn_impl={attn_impl!r} (choose from {ATTN_IMPLS})")
        if spec_decode not in ("off", "ngram", "draft"):
            raise ValueError(f"spec_decode={spec_decode!r}")
        if spec_k < 1:
            raise ValueError(f"spec_k={spec_k} (need >= 1)")
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
        quantize_kv = normalize_kv_quant(quantize_kv)  # "int8" | "fp8" | None
        if quantize_kv and cache_kind != "paged":
            warnings.warn(
                f"quantize_kv only applies to paged block pools; ignored for cache_kind={cache_kind!r} ({cfg.name})",
                RuntimeWarning,
                stacklevel=2,
            )
        self.quantize_kv = quantize_kv if cache_kind == "paged" else None
        if self.quantize_kv and attn_impl == "kernel":
            warnings.warn(
                f"{self.quantize_kv} block pools have no kernel yet; decode runs the "
                "dequantizing plain path despite attn_impl='kernel'",
                RuntimeWarning,
                stacklevel=2,
            )

        # ---- observability: one injectable clock feeds every timestamp,
        # one registry collects every counter/gauge/histogram, one bounded
        # ring buffer records the request-lifecycle events
        self._clock = clock if clock is not None else time.monotonic
        self.metrics = metrics if metrics is not None else MetricsRegistry()
        self.tracer = tracer if tracer is not None else Tracer(self._clock, trace_capacity)
        self._profile = profile
        self._phase_acc: dict[str, float] = {}  # this step's profiled seconds by phase
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
        self._c_spill_hit = M.counter("engine_spill_hit_tokens_total", "prompt tokens served from the host spill tier")
        self._c_restored = M.counter("engine_restores_total", "spilled blocks swapped back into device blocks")
        self._c_restore_cancel = M.counter("engine_restores_cancelled_total", "queued swap-ins cancelled by preempt/abort")
        self._h_queue_wait = M.histogram("engine_queue_wait_seconds", "submit to admission")
        self._h_restore_wait = M.histogram("engine_restore_wait_seconds", "swap-in queued to rows scattered on device")
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
        self._c_drafted = M.counter("engine_spec_drafted_total", "speculative candidate tokens proposed")
        self._c_accepted = M.counter("engine_spec_accepted_total", "speculative candidate tokens committed")
        self._c_energy = M.counter("engine_energy_joules_total", "IT-side joules charged to serving steps")
        # dispatch/sync accounting, at the JAX engine's seams: every model or
        # sampling call counts one dispatch, every device-to-host read one sync
        self.dispatches_total = 0
        self.host_syncs_total = 0
        self._g_dispatches = M.gauge("engine_dispatches_per_step", "model and sampling calls per engine step")
        self._g_host_syncs = M.gauge("engine_host_syncs_per_step", "device->host syncs per engine step")

        # DCIM bridge (paper §IV.A): each step charges card-seconds at its
        # slot occupancy; the engine splits the joules over the requests
        # that did work in it
        self.energy = energy if energy is not None else EnergyBridge(chips=1)

        # chunked prefill (and with it the prefix cache, speculative
        # decoding and the fused step) needs a paged cache
        self._chunked = cache_kind == "paged"
        if prefix_cache and not self._chunked:
            warnings.warn(
                f"prefix_cache needs a paged cache; disabled for {cfg.name} ({cache_kind})",
                RuntimeWarning,
                stacklevel=2,
            )
        if prefill_budget > 0 and not self._chunked:
            warnings.warn(
                f"prefill_budget requires chunked prefill (paged cache); {cfg.name} ({cache_kind}) keeps the "
                f"blocking admission prefill",
                RuntimeWarning,
                stacklevel=2,
            )
        if fused and not self._chunked:
            raise ValueError(
                f"fused=True needs a paged cache; got {cfg.name} ({cache_kind})"
            )
        self.fused = bool(fused)
        if spec_decode != "off" and not self._chunked:
            warnings.warn(
                f"spec_decode needs a paged cache; disabled for {cfg.name} ({cache_kind})",
                RuntimeWarning,
                stacklevel=2,
            )
            spec_decode = "off"

        # scheduling brain: queue ordering (SLO/FCFS), admission, preemption
        # decisions and the chunked-prefill budget live in SchedulerCore; the
        # engine provides the execution primitives (try_admit / run_chunk /
        # finish_prefill / preempt / ...) below
        if restore_budget < 1:
            raise ValueError(f"restore_budget={restore_budget} (need >= 1)")
        self.scheduler = SchedulerCore(self, policy=policy, prefill_budget=prefill_budget, restore_budget=restore_budget)
        self.defrag_threshold = defrag_threshold

        # speculative decoding: a verify pass writes up to spec_k positions
        # past the committed sequence, so admission reserves that headroom
        # and speculative writes always land in the request's own blocks.
        # ``draft_params=None`` draws the port's own random draft weights
        # from ``seed + 1``, which differ from the JAX engine's draw: parity
        # runs pass the same (bridged) draft weights to both.
        self.spec_mode = spec_decode
        self.spec_k = spec_k
        self._spec_extra = spec_k if spec_decode != "off" else 0
        self._draft: Optional[DraftModel] = None
        if spec_decode == "draft":
            dcfg = draft_cfg if draft_cfg is not None else make_draft_config(cfg)
            if dcfg.padded_vocab != cfg.padded_vocab:
                raise ValueError(f"draft model vocab {dcfg.padded_vocab} != target {cfg.padded_vocab}")
            if draft_params is None:
                draft_params = init_params(dcfg, seed + 1, device=self.device)
            if draft_params["embed"]["tok"].device.type != self.device.type:
                raise ValueError(f"draft params are on {draft_params['embed']['tok'].device}, engine on {self.device}")
            self._draft = DraftModel(
                dcfg, draft_params, max_batch=max_batch, max_seq=max_seq, seed=seed, metrics=self.metrics,
                device=self.device,
            )

        if cache_kind == "paged":
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
                # the prefix index returns "spilled" when the block's rows were
                # demoted to the host pool; the allocator counts the two apart
                tier = _inner(block) if _inner is not None else None
                self.tracer.instant("spill" if tier == "spilled" else "evict", track=SCHEDULER_TRACK, block=block)
                return tier

            self.allocator.on_evict = _evict_hook
            # host spill tier: evicted prefix blocks park in host RAM and swap
            # back in on a later hit instead of running prefill again
            if spill_dtype not in SPILL_MODES:
                raise ValueError(f"spill_dtype={spill_dtype!r} (choose from {SPILL_MODES})")
            self.spill = None
            if spill_bytes > 0:
                if self.prefix is None:
                    warnings.warn(
                        f"spill_bytes needs the prefix cache; disabled for {cfg.name}",
                        RuntimeWarning,
                        stacklevel=2,
                    )
                else:
                    spill_dtype = warn_if_fp8_over_int8(self.quantize_kv, spill_dtype)
                    self.spill = SpillPool(spill_bytes, mode=spill_dtype)
                    self.prefix.attach_spill(self.spill, self._fetch_block_rows)
                    self.spill.attach_metrics(self.metrics)
            self.tbl = np.zeros((max_batch, self.max_blocks_per_seq), np.int32)
            self._tbl_dirty = True
            self.cache = init_paged_cache(
                cfg, num_blocks, block_size, max_batch, self.max_blocks_per_seq, cache_dtype, quantized=self.quantize_kv,
                device=self.device,
            )
        else:
            self.allocator = None
            self.prefix = None
            self.spill = None
            if spill_bytes > 0:
                warnings.warn(
                    f"spill_bytes only applies to paged caches; ignored for cache_kind={cache_kind!r} ({cfg.name})",
                    RuntimeWarning,
                    stacklevel=2,
                )
            self.cache = make_engine_cache(cfg, max_batch, max_seq, cache_dtype, device=self.device)

        self.pos = np.zeros((max_batch,), np.int32)  # next position per slot
        self.slots: list[Optional[Request]] = [None] * max_batch
        self.done: list[Request] = []
        self._preempted_ids: set[int] = set()  # distinct requests ever evicted
        self.deadline_violations = 0  # finished with ttft > deadline_s
        self.aborts = 0  # requests aborted (cancel / deadline / migration)
        self._ids = itertools.count()
        self._gen = torch.Generator(device=self.device).manual_seed(seed)
        # the fused step's graphs hold the pools' and the table's addresses:
        # everything below writes them in place
        self._graphs = StepGraphs(self.device, self._gen, lambda: self.cache) if self.fused else None
        self.steps = 0
        self.tokens_out = 0
        self.peak_active = 0
        self.prefill_chunks = 0
        self.prefill_tokens = 0  # prompt tokens actually run through the model
        self.prefix_hits = 0
        self.prefix_partial_hits = 0
        self.prefix_hit_tokens = 0  # prompt tokens served from cached blocks
        # verify-window tokens count apart from prefill_tokens: they are
        # decode work, and folding them in would deflate prefix_hit_rate
        self.verify_tokens = 0
        self.spec_steps = 0  # verify dispatches
        self.spec_slot_steps = 0  # per-slot verify passes (the tokens-per-verify denominator)
        self.spec_drafted = 0  # candidate tokens proposed (valid lanes only)
        self.spec_accepted = 0  # drafted tokens committed
        self.spec_emitted = 0  # tokens emitted through verify passes
        self.defrag_triggers = 0
        self._frees_seen = 0  # auto-defrag: only re-check after new frees
        self.spill_hits = 0  # admissions that matched >= 1 spilled block
        self.spill_hit_tokens = 0  # prompt tokens served from the host tier
        self.restores = 0  # spilled blocks swapped back onto the device
        self.restores_cancelled = 0  # queued swap-ins cancelled (preempt/abort)
        self._restore_q: list[_RestoreTask] = []  # FIFO, drained per scheduler pass
        self._restoring: set[int] = set()  # dst blocks with a queued task
        # streaming hooks for the front-ends (serving.async_engine), called on
        # the stepping thread: on_token(req, new_tokens) per emission batch,
        # on_finish(req) when a request completes or is aborted
        self.on_token = None
        self.on_finish = None

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
        if self.cache_kind == "paged":
            span = total + self._spec_extra  # worst case + speculative headroom
            if span > self.max_seq:
                headroom = f" (+{self._spec_extra} spec_k headroom)" if self._spec_extra else ""
                raise ValueError(f"prompt+max_new_tokens={total}{headroom} exceeds max_seq={self.max_seq}")
            if blocks_needed(span, self.block_size) > self.allocator.capacity:
                raise ValueError(
                    f"request needs {blocks_needed(span, self.block_size)} blocks, "
                    f"pool capacity is {self.allocator.capacity}"
                )
        elif self.cfg.has_attention and self.cfg.sliding_window == 0 and total > self.max_seq:
            # full-attention ring cache: positions past max_seq would wrap the
            # ring and overwrite the oldest entries
            raise ValueError(f"prompt+max_new_tokens={total} exceeds max_seq={self.max_seq}")
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
        return self._chunked

    def can_preempt(self) -> bool:
        # eviction and resume ride the chunked paged path: the resumed
        # context prefills again in chunks
        return self._chunked

    def try_admit(self, req: Request, slot: int) -> bool:
        admit = self._admit_chunked if self._chunked else self._admit_blocking
        return admit(req, slot)

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
        if self.cache_kind == "paged":
            self.tbl[slot] = 0  # null block
            self._tbl_dirty = True
            self.cache = clear_block_row(self.cfg, self.cache, slot)
        else:
            self.cache = clear_slot(self.cfg, self.cache, slot)

    def preempt(self, req: Request) -> None:
        """Evict a running request: park its committed K/V in the prefix
        cache (LRU pool), free everything else, clear its slot and mark it
        WAITING so the scheduler can requeue it.  The cache holds K/V for
        positions ``[0, written)``: ``len(ctx) - 1`` for a decoding request,
        ``prefill_pos`` for a mid-prefill one."""
        slot = req.slot
        # cancel in-flight swap-ins first: cancelled entries demote back to
        # the spill pool, so the register below skips their chain positions
        # and the release frees the never-written destination blocks
        self._cancel_restores(req)
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
            if self.cache_kind == "paged":
                self._cancel_restores(req)
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
        if self.on_finish is not None:
            self.on_finish(req)
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

    # ---- spill tier: gather / swap-in machinery ----------------------
    def _fetch_block_rows(self, block: int) -> dict:
        """One block's K/V rows off the device pool, copied (the prefix
        index calls this at evict time, before the allocator reuses the
        block): the ``SpillPool`` staging ring holds the copy."""
        return gather_block_rows(self.cache, block)

    def _queue_restore(self, dst: int, payload: dict, *, cow: bool, req: Request) -> None:
        self._restore_q.append(_RestoreTask(dst, payload, cow, self._clock()))
        self._restoring.add(dst)
        req.pending_restores.add(dst)

    def restoring(self, req: Request) -> bool:
        """Scheduler gate: the request's block table points at rows the
        restore pass has not scattered yet, so no prefill chunk (or table
        publish) may run until the swap-ins land."""
        return bool(req.pending_restores)

    def run_restores(self, budget: int) -> int:
        """Execute up to ``budget`` queued swap-ins as ONE in-place scatter
        (rows stacked along a new block axis), then unblock every admitted
        request that waited on them.  The scheduler calls it between
        admission and the prefill budget of each pass (``plan()`` in the
        fused walk, eagerly between graph replays)."""
        if budget <= 0 or not self._restore_q:
            return 0
        tasks = self._restore_q[:budget]
        del self._restore_q[: len(tasks)]
        t0 = self._clock()
        rows = {
            name: torch.stack(
                [t.payload[name].to(device=self.device, dtype=self.cache[name].dtype) for t in tasks], dim=1
            )
            for name in tasks[0].payload
        }
        blocks = self._device_ints([t.dst for t in tasks])
        self.cache = self._dispatch("restore", restore_block_rows, self.cache, blocks, rows)
        now = self._clock()
        done = {t.dst for t in tasks}
        self._restoring -= done
        for r in self.slots:
            if r is not None and r.pending_restores:
                r.pending_restores -= done
        for t in tasks:
            self._h_restore_wait.observe(max(now - t.t0, 0.0))
        n = len(tasks)
        self.restores += n
        self._c_restored.inc(n)
        if self.spill is not None:
            self.spill.restores += n
        self.tracer.span("restore", t0, track=SCHEDULER_TRACK, blocks=n, queued=len(self._restore_q))
        return n

    def _cancel_restores(self, req: Request) -> None:
        """Drop the request's pending swap-ins (preempt / abort mid-restore).
        A task another admitted request also waits on stays queued; an
        exclusive full-block task is removed and its entry *demoted* back to
        the spill pool: the destination block was never written, so the rows
        exist only in the payload.  COW tasks just drop (the canonical entry
        never left the pool)."""
        if not req.pending_restores:
            return
        for b in sorted(req.pending_restores):
            req.pending_restores.discard(b)
            if any(r is not None and r is not req and b in r.pending_restores for r in self.slots):
                continue
            task = next((t for t in self._restore_q if t.dst == b), None)
            if task is None:
                continue  # already scattered
            self._restore_q.remove(task)
            self._restoring.discard(b)
            self.restores_cancelled += 1
            self._c_restore_cancel.inc()
            if not task.cow and self.prefix is not None:
                self.prefix.demote(b, task.payload)
            self.tracer.instant("restore_cancel", track=SCHEDULER_TRACK, block=b, req_id=req.req_id)

    def _admit_chunked(self, req: Request, slot: int) -> bool:
        """Prefix-matched, block-budgeted admission (no model call: context
        chunks run inside later ``step()`` prefill budgets).  Returns False
        when the pool can't cover the request's unshared blocks.  A resumed
        (previously preempted) request admits with its committed context
        ``prompt + generated`` in place of the prompt.

        Matched blocks may live on either tier: device entries pin by
        refcount; **spilled** entries (negative handles) need a fresh device
        block each.  Their payloads are popped from the host pool *before*
        ``alloc`` (eviction inside alloc can spill new entries and must never
        LRU-drop rows about to swap back in), the entries are ``promote``d
        onto the new blocks, and the row scatter is queued for the
        scheduler's budgeted restore pass.  A spilled partial tail copies on
        write from the pool's decompressed rows while the canonical entry
        stays put."""
        needed = blocks_needed(len(req.prompt) + req.max_new_tokens + self._spec_extra, self.block_size)
        ctx = req.context()
        full, partial = self.prefix.match(ctx) if self.prefix is not None else ([], None)
        dev_full = [b for b in full if not is_spilled(b)]
        spilled = [b for b in full if is_spilled(b)]
        partial_spilled = partial is not None and is_spilled(partial.block)
        need_new = needed - len(dev_full)
        if self.prefix is not None:
            # pin matched device blocks first so the free-count check below
            # can't hand them out as eviction victims
            self.prefix.acquire(dev_full)
            if partial is not None and not partial_spilled:
                self.prefix.acquire([partial.block])
        if need_new > self.allocator.num_free:
            if self.prefix is not None:
                self.prefix.release(dev_full)
                if partial is not None and not partial_spilled:
                    self.prefix.release([partial.block])
            return False  # out of blocks: backpressure until frees
        payloads = {h: self.spill.pop(h) for h in spilled}
        cow_payload = self.spill.get(partial.block) if partial_spilled else None
        # chain state is read while the handles are still in the index
        # (promote re-keys them)
        reg_parent = self.prefix.parent_hash(full) if self.prefix is not None else 0
        new_blocks = self.allocator.alloc(need_new)
        ni = 0
        blocks: list[int] = []
        for b in full:
            if not is_spilled(b):
                if b in self._restoring:
                    # promoted by an earlier admission, rows still in
                    # flight: this sharer waits on the same task
                    req.pending_restores.add(b)
                blocks.append(b)
                continue
            nb = new_blocks[ni]
            ni += 1
            self.prefix.promote(b, nb)
            self._queue_restore(nb, payloads[b], cow=False, req=req)
            blocks.append(nb)
        req.blocks = blocks + new_blocks[ni:]
        matched = len(full) * self.block_size
        if partial is not None:
            # copy-on-write: the partially-shared block's rows move into the
            # request's first private block; its suffix is overwritten by
            # the first prefill chunk while the cached original stays put
            # (device tier) or parked in the spill pool (host tier)
            dst = new_blocks[ni]
            if partial_spilled:
                self._queue_restore(dst, cow_payload, cow=True, req=req)
            else:
                copy_block_rows(self.cache, partial.block, dst)
                self.prefix.release([partial.block])
            matched += partial.tokens
            self.prefix_partial_hits += 1
        if matched:
            self.prefix_hits += 1
            self.prefix_hit_tokens += matched
            req.prefix_hit_tokens += matched  # accumulates across resumes
            self._c_prefix_hit.inc(matched)
        spill_matched = len(spilled) * self.block_size + (partial.tokens if partial_spilled else 0)
        if spill_matched:
            self.spill_hits += 1
            self.spill_hit_tokens += spill_matched
            self._c_spill_hit.inc(spill_matched)
            self.tracer.instant(
                "spill_hit", track=slot_track(slot), req_id=req.req_id, tokens=spill_matched,
                blocks=len(spilled) + int(partial_spilled),
            )
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
        if self._draft is not None:
            self._draft.reset(slot)
        self._note_admit(req, slot)
        # the engine table row stays null until the prompt completes, so
        # interleaved decode steps write into the scratch null block
        self._prefilling.append(req)
        return True

    def _admit_blocking(self, req: Request, slot: int) -> bool:
        """One-shot admission of the dense slot cache: the whole prompt in
        one ``models.prefill`` call, its K/V copied into the slot's ring
        rows, the first token sampled from the prefill's logits."""
        self._note_admit(req, slot)
        t0 = self._clock()
        logits, raw = self._dispatch("prefill", self._run_prefill, req)
        n = len(req.prompt)
        self.prefill_chunks += 1
        self.prefill_tokens += n
        self._c_prefill_tokens.inc(n)
        req.step_work += n
        self._h_prefill_chunk.observe(self._clock() - t0)
        self.tracer.span("prefill", t0, track=slot_track(slot), req_id=req.req_id, tokens=n)
        write_prefill_into_slot(self.cfg, self.cache, raw, slot, seq_filled=n)
        self.pos[slot] = n
        req.state = RequestState.ACTIVE
        req.slot = slot
        self.slots[slot] = req
        self.peak_active = max(self.peak_active, sum(r is not None for r in self.slots))
        self._emit_first_token(req, logits[0])
        return True

    def _bucket_len(self, n: int) -> int:
        """Power-of-two prefill length bucket (a bounded set of shapes)."""
        p = MIN_PREFILL_BUCKET
        while p < n:
            p *= 2
        return min(p, self.max_seq)

    def _run_prefill(self, req: Request):
        """The blocking prefill of ``req``'s prompt, right-padded to its
        bucket, logits at its last real token."""
        n = len(req.prompt)
        toks = req.prompt + [0] * (self._bucket_len(n) - n)
        batch = {"tokens": self._device_ints(toks)[None], "last_index": self._device_ints([n - 1])}
        return prefill(self.cfg, self.params, batch)

    def _emit_first_token(self, req: Request, logits: torch.Tensor) -> None:
        self.dispatches_total += 1
        self.host_syncs_total += 1
        self._note_first_token(req, sample_token(logits, req.temperature, self._gen, top_k=req.top_k))

    def _note_first_token(self, req: Request, tok: int) -> None:
        """First-token bookkeeping shared by the legacy walk (which samples
        from the final chunk's logits) and the fused step (whose token comes
        out of the step's own sampling)."""
        req.generated.append(tok)
        req.first_token_t = self._clock()
        self.tokens_out += 1
        self._c_tokens.inc()
        self._h_ttft.observe(req.first_token_t - req.submit_t)
        if req.admit_t is not None:
            self._h_admit_first.observe(req.first_token_t - req.admit_t)
        self.tracer.instant("first_token", track=slot_track(req.slot), req_id=req.req_id)
        if self.on_token is not None:
            self.on_token(req, [tok])
        self._finish_if_done(req)

    # ------------------------------------------------------------------
    def _device_ints(self, values) -> torch.Tensor:
        return torch.as_tensor(np.asarray(values, np.int32), device=self.device)

    def _dispatch(self, phase: str, fn, *args, **kw):
        """Run one model or step call, counted as one dispatch.

        ``profile=False`` (default) is a plain call: no timing, no sync.
        ``profile=True`` brackets the call with the engine's clock and a
        device sync (``_block_until_ready``, one counted host sync), so a
        step's latency splits by phase (``engine_profile_<phase>_seconds``
        and the step span's ``phases``)."""
        self.dispatches_total += 1
        if not self._profile:
            return fn(*args, **kw)
        t0 = self._clock()
        out = fn(*args, **kw)
        _block_until_ready(self.device)
        self.host_syncs_total += 1
        self._note_phase(phase, self._clock() - t0)
        return out

    def _note_phase(self, phase: str, dt: float) -> None:
        """One profiled span of ``phase``: its histogram and the step's sum."""
        self.metrics.histogram(f"engine_profile_{phase}_seconds", f"synced {phase} dispatch time").observe(dt)
        self._phase_acc[phase] = self._phase_acc.get(phase, 0.0) + dt

    def _host_fetch(self, *tensors) -> tuple:
        """Bring device results to the host as one counted sync: on the
        card one copy each into pinned memory, then the stream's sync."""
        self.host_syncs_total += 1
        if self.device.type == "cpu":
            return tuple(t.numpy() for t in tensors)
        host = [torch.empty(t.shape, dtype=t.dtype, pin_memory=True) for t in tensors]
        for h, t in zip(host, tensors):
            h.copy_(t, non_blocking=True)
        torch.cuda.current_stream(self.device).synchronize()
        return tuple(h.numpy() for h in host)

    def run_chunk(self, req: Request, c: int) -> torch.Tensor:
        """Run one c-token context chunk; returns the chunk's last logits."""
        ctx = req.context()
        start = req.prefill_pos
        toks = self._device_ints(ctx[start : start + c])[None]
        row = self._device_ints(make_table_row(req.blocks, self.max_blocks_per_seq))[None]
        t0 = self._clock()
        logits, self.cache = self._dispatch(
            "prefill_chunk", prefill_step, self.cfg, self.params, self.cache, toks, self._device_ints([start]), row,
            attn_impl=self.attn_impl,
        )
        self._h_prefill_chunk.observe(self._clock() - t0)
        self.tracer.span(
            "prefill_chunk", t0, track=slot_track(req.slot), req_id=req.req_id, pos=start, tokens=c
        )
        req.prefill_pos += c
        req.step_work += c
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
        if self.cache_kind == "paged":
            # token-level truncate at the final committed length: tail blocks
            # hold unused reserve and free eagerly; the kept span routes
            # through the prefix index
            self._release_request_blocks(req, len(req.prompt) + len(req.generated))
        self._clear_slot(slot)
        self.done.append(req)
        if self.on_finish is not None:
            self.on_finish(req)

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
        if self.allocator is None or self.defrag_threshold >= 1.0 or self.allocator.total_frees == self._frees_seen:
            return
        self._frees_seen = self.allocator.total_frees
        if self.allocator.fragmentation() > self.defrag_threshold:
            self.allocator.defrag()
            self.defrag_triggers += 1

    def _sync_tables(self) -> None:
        if self.cache_kind == "paged" and self._tbl_dirty:
            self.cache["tbl"].copy_(torch.from_numpy(self.tbl))
            self._tbl_dirty = False

    # ---- speculative decoding ----------------------------------------
    def _propose(self, req: Request) -> tuple[list[int], Optional[np.ndarray]]:
        """Draft up to ``spec_k`` tokens for a decoding slot (never past the
        generation budget) and count them.  Returns ``(tokens, probs)``:
        the draft model's (n, V) proposal law, or None for the n-gram
        drafter, whose law is the one-hot of its tokens."""
        k = self.scheduler.spec_window(req, self.spec_k)
        ctx = req.context()
        if self._draft is None:
            d, q = ngram_draft(ctx, k), None
        else:
            d, q = self._draft.draft(req.slot, ctx, k, temperature=req.temperature, top_k=req.top_k)
        self.spec_slot_steps += 1
        self.spec_drafted += len(d)
        self._c_drafted.inc(len(d))
        self.verify_tokens += self.spec_k + 1  # the fed window: last committed token + spec_k lanes
        req.step_work += self.spec_k + 1
        return d, q

    def _commit_verify(self, req: Request, drafts, n_acc: int, final: int, cut: int, base: int) -> None:
        """Commit a verify window's first ``cut`` emitted tokens
        (``drafts[:n_acc] + [final]`` cut at the first EOS and the budget):
        their K/V is already in the request's blocks, at ``base`` on."""
        slot = req.slot
        emitted = ([int(t) for t in drafts[:n_acc]] + [final])[:cut]
        committed = len(req.prompt) + len(req.generated)  # context before this step
        req.generated.extend(emitted)
        self.pos[slot] = base + cut
        self.tokens_out += cut
        self._c_tokens.inc(cut)
        self.spec_accepted += min(n_acc, cut)
        self._c_accepted.inc(min(n_acc, cut))
        self.spec_emitted += cut
        self.tracer.instant(
            "spec_accept", track=slot_track(slot), req_id=req.req_id, drafted=len(drafts), accepted=n_acc,
            emitted=cut,
        )
        if self.on_token is not None and emitted:
            self.on_token(req, emitted)
        if self._draft is not None:
            # the drafter absorbed its own provisional tokens: truncate its
            # view to the committed prefix (the next draft re-feeds the rest)
            self._draft.rollback(slot, committed + min(n_acc, cut))
        self._finish_if_done(req)

    def _spec_step(self, active: list[Request]) -> int:
        """One speculative iteration of the legacy walk over the decoding
        slots: draft per slot, ONE verify call over all ``max_batch`` slots
        (``models.verify_step``, K2), one ``spec_accept`` call and one host
        sync, then one batched ``truncate_block_rows`` call that zeroes
        every slot's rejected tail.  A slot with nothing to draft (no n-gram
        match, a one-token budget) takes a plain one-token step through the
        same pass."""
        K, B = self.spec_k, self.max_batch
        tokens = np.zeros((B, K + 1), np.int32)
        drafts = np.zeros((B, K), np.int32)
        # the draft model's proposal laws; the n-gram drafter's one-hot is
        # built on the device by the sampler
        qprobs = np.zeros((B, K, self.cfg.padded_vocab), np.float32) if self._draft is not None else None
        valid = np.zeros((B, K), bool)
        start = np.zeros((B,), np.int32)
        temps = np.zeros((B,), np.float32)
        top_ks = np.zeros((B,), np.int32)
        window: dict[int, list[int]] = {}
        for r in active:
            s = r.slot
            d, q = self._propose(r)
            window[s] = d
            tokens[s, 0] = r.generated[-1]
            tokens[s, 1 : 1 + len(d)] = d
            drafts[s, : len(d)] = d
            valid[s, : len(d)] = True
            if q is not None and d:
                qprobs[s, : len(d)] = q
            start[s] = self.pos[s]
            temps[s] = r.temperature
            top_ks[s] = r.top_k
        t_decode = self._clock()
        logits, self.cache = self._dispatch(
            "verify", verify_step, self.cfg, self.params, self.cache, self._device_ints(tokens),
            self._device_ints(start), self.cache["tbl"], attn_impl=self.attn_impl,
        )
        self.steps += 1
        self.spec_steps += 1
        t_sample = self._clock() if self._profile else 0.0
        self.dispatches_total += 1  # the spec_accept call below
        dev = lambda a: torch.from_numpy(a).to(self.device)  # noqa: E731
        n_acc, final = self._host_fetch(*spec_accept(
            logits, self._device_ints(drafts), dev(qprobs) if qprobs is not None else None, dev(valid),
            dev(temps), dev(top_ks), self._gen,
        ))
        if self._profile:  # the host fetch is the sync: the sample phase adds none
            self._note_phase("sample", self._clock() - t_sample)
        self._h_decode.observe(self._clock() - t_decode)
        produced = 0
        t_start = np.zeros((B,), np.int32)
        t_end = np.zeros((B,), np.int32)  # end <= start: no rollback for the slot
        for r in active:
            s = r.slot
            na = int(n_acc[s])
            emitted = window[s][:na] + [int(final[s])]
            # stop at the first EOS inside the accepted window, and at the budget
            cut = next((j + 1 for j, t in enumerate(emitted) if t == self.eos), len(emitted))
            cut = min(cut, r.max_new_tokens - len(r.generated))
            base = int(start[s])
            self._commit_verify(r, window[s], na, int(final[s]), cut, base)
            produced += cut
            if r.state != RequestState.ACTIVE:
                continue  # its blocks were truncated and released at its final length
            if cut < K + 1:
                t_start[s], t_end[s] = base + cut, base + K + 1
                self.tracer.instant("rollback", track=slot_track(s), req_id=r.req_id, tokens=K + 1 - cut)
            self._reclaim_window_blocks(r)
        if np.any(t_end > t_start):
            # one call over the whole batch zeroes every slot's rejected tail
            self._dispatch(
                "rollback", truncate_block_rows, self.cache, self._device_ints(self.tbl), self._device_ints(t_start),
                self._device_ints(t_end), span=K + 1,
            )
        return produced

    # ---- fused one-dispatch step -------------------------------------
    def _fused_decode_fn(self, tokens, pos, temps, top_ks, room) -> torch.Tensor:
        """The pure-decode tick's step: ``decode_step`` (bit-identical
        logits to the legacy walk) with sampling folded in.  Returns
        (2, B) int32: the tokens and the done flags."""
        logits, _ = decode_step(self.cfg, self.params, self.cache, tokens, pos, attn_impl=self.attn_impl)
        toks = sample_tokens(logits, temps, top_ks, self._gen)
        done = (toks == self.eos) | (room <= 1)
        return torch.stack([toks.int(), done.int()])

    def _fused_mixed_fn(
        self, tokens, start, widths, tbl, temps, top_ks, sample_lane, room, drafts=None, valid=None, roll_end=None,
        qprobs=None,
    ) -> torch.Tensor:
        """The mixed tick's step: ``unified_step`` over the (R, W) row
        batch, ``fused_sample_accept``, and the committed emission length
        ``cut`` (first EOS in the window, clamped by the remaining budget
        ``room``).  Returns (4, R) int32: final tokens, accept counts, cut
        and done flags.

        A tick with verify rows passes their windows: ``drafts`` (R, W-1),
        ``valid`` (R, W-1, int32 0/1), ``roll_end`` (R,) and, from the draft
        model, ``qprobs`` (R, spec_k, V), padded here to W-1 lanes; its
        rejected tails, lanes ``[start + cut, roll_end)``, are zeroed in the
        same call (``roll_end`` 0: no rollback for the row).  Without them
        every row has an empty window."""
        logits, _ = unified_step(
            self.cfg, self.params, self.cache, tokens, start, widths, tbl, attn_impl=self.attn_impl
        )
        R, W = tokens.shape
        if drafts is None:
            drafts = torch.zeros((R, W - 1), dtype=torch.int32, device=tokens.device)
            valid = torch.zeros((R, W - 1), dtype=torch.int32, device=tokens.device)
        if qprobs is not None:
            qprobs = F.pad(qprobs, (0, 0, 0, W - 1 - qprobs.shape[1]))
        n_acc, final = fused_sample_accept(
            logits, drafts, qprobs, valid.bool(), temps, top_ks, sample_lane, self._gen
        )
        lanes = torch.arange(W, device=tokens.device)
        emitted = torch.where(lanes[None, :] == n_acc[:, None], final[:, None], F.pad(drafts, (0, 1)))
        is_eos = (lanes[None, :] <= n_acc[:, None]) & (emitted == self.eos)
        eos_cut = torch.where(is_eos.any(dim=1), torch.argmax(is_eos.int(), dim=1) + 1, W + 1)
        cut = torch.minimum(torch.minimum(eos_cut, room), n_acc + 1)
        done = (eos_cut <= cut) | (cut >= room)
        if roll_end is not None:
            truncate_block_rows(self.cache, tbl, start + cut, roll_end, span=W)
        return torch.stack([final, n_acc, cut.int(), done.int()])

    def _fused_step(self) -> int:
        """One fused tick: the scheduler emits a ``StepPlan`` of decode and
        prefill-chunk rows, the tick's model work and sampling run as one
        call (one graph replay on the card), and the host reads the tokens
        in one sync.  Pure-decode ticks keep ``decode_step``'s path; mixed
        ticks run every row through the unified chunk path."""
        spec = self.spec_mode != "off"
        plan = self.scheduler.plan(spec=spec)
        self.peak_active = max(self.peak_active, sum(r is not None for r in self.slots))
        if not plan.rows:
            return 0
        if not plan.chunk_rows and not spec:
            return self._fused_decode_tick([pr.req for pr in plan.rows])
        return self._fused_mixed_tick(plan)

    def _fused_decode_tick(self, active: list[Request]) -> int:
        self._sync_tables()
        B = self.max_batch
        tokens = np.zeros((B, 1), np.int32)
        temps = np.zeros((B,), np.float32)
        top_ks = np.zeros((B,), np.int32)
        room = np.ones((B,), np.int32)
        for r in active:
            tokens[r.slot, 0] = r.generated[-1]
            temps[r.slot] = r.temperature
            top_ks[r.slot] = r.top_k
            room[r.slot] = r.max_new_tokens - len(r.generated)
            r.step_work += 1
        inputs = dict(tokens=tokens, pos=self.pos.copy(), temps=temps, top_ks=top_ks, room=room)
        t_decode = self._clock()
        packed = self._dispatch("fused_decode", self._graphs.run, ("decode", B), self._fused_decode_fn, inputs)
        (out,) = self._host_fetch(packed)
        self._h_decode.observe(self._clock() - t_decode)
        self.steps += 1
        for r in active:
            tok = int(out[0, r.slot])
            r.generated.append(tok)
            self.pos[r.slot] += 1
            self.tokens_out += 1
            self._c_tokens.inc()
            if self.on_token is not None:
                self.on_token(r, [tok])
            self._reclaim_window_blocks(r)
            self._finish_if_done(r)
        return len(active)

    def _fused_mixed_tick(self, plan) -> int:
        """Lower a mixed ``StepPlan`` into one unified (R, W) row batch.  R
        is padded to a power of two (pad rows have width 0 and an all-null
        table, so their lanes write only the null block); W is the widest
        row: a power of two from ``binary_chunks``, 1 for a decode row or
        ``spec_k + 1`` for a verify window, so the graphs stay few.  A tick
        with verify rows runs the spec variant of the step, keyed apart,
        and the draft model's variant also stages its (R, spec_k, V)
        proposal laws."""
        K = self.spec_k
        rows = plan.rows
        R = 1 << max(len(rows) - 1, 0).bit_length()
        has_verify = any(pr.kind == "verify" for pr in rows)
        row_width = [1 if pr.kind == "decode" else K + 1 if pr.kind == "verify" else pr.take for pr in rows]
        W = max(max(row_width), 1)
        tokens = np.zeros((R, W), np.int32)
        start = np.zeros((R,), np.int32)
        widths = np.zeros((R,), np.int32)
        tbl = np.zeros((R, self.max_blocks_per_seq), np.int32)  # null-block rows for pad lanes
        temps = np.zeros((R,), np.float32)
        top_ks = np.zeros((R,), np.int32)
        sample_lane = np.zeros((R,), np.int32)
        room = np.full((R,), W + 1, np.int32)  # pad rows: cut never clamps
        spec = {}
        if has_verify:
            spec = dict(
                drafts=np.zeros((R, W - 1), np.int32), valid=np.zeros((R, W - 1), np.int32),
                roll_end=np.zeros((R,), np.int32),  # 0: no rollback for the row
            )
            if self._draft is not None:
                spec["qprobs"] = np.zeros((R, K, self.cfg.padded_vocab), np.float32)
        window: dict[int, list[int]] = {}
        for i, pr in enumerate(rows):
            r = pr.req
            temps[i] = r.temperature
            top_ks[i] = r.top_k
            widths[i] = row_width[i]
            if pr.kind in ("decode", "verify"):
                tokens[i, 0] = r.generated[-1]
                start[i] = self.pos[r.slot]
                tbl[i] = self.tbl[r.slot]
                room[i] = r.max_new_tokens - len(r.generated)
                if pr.kind == "decode":
                    r.step_work += 1
                else:
                    d, q = self._propose(r)
                    window[i] = d
                    tokens[i, 1 : 1 + len(d)] = d
                    spec["drafts"][i, : len(d)] = d
                    spec["valid"][i, : len(d)] = 1
                    if q is not None and d:
                        spec["qprobs"][i, : len(d)] = q
                    spec["roll_end"][i] = start[i] + K + 1
            else:  # prefill chunk
                c = pr.take
                tokens[i, :c] = r.context()[pr.start : pr.start + c]
                start[i] = pr.start
                tbl[i, : len(r.blocks)] = r.blocks
                sample_lane[i] = max(c - 1, 0)
                if pr.final:
                    room[i] = max(r.max_new_tokens - len(r.generated), 1)
        inputs = dict(
            tokens=tokens, start=start, widths=widths, tbl=tbl, temps=temps, top_ks=top_ks,
            sample_lane=sample_lane, room=room, **spec,
        )
        key = ("mixed", R, W)
        if has_verify:
            key += ("draft" if self._draft is not None else "spec",)
        packed = self._dispatch("fused_step", self._graphs.run, key, self._fused_mixed_fn, inputs)
        (out,) = self._host_fetch(packed)
        final, n_acc, cut = out[0], out[1], out[2]
        if any(pr.kind != "chunk" for pr in rows):
            self.steps += 1
        if has_verify:
            self.spec_steps += 1
        produced = 0
        for i, pr in enumerate(rows):
            r = pr.req
            if pr.kind == "decode":
                tok = int(final[i])
                r.generated.append(tok)
                self.pos[r.slot] += 1
                produced += 1
                self.tokens_out += 1
                self._c_tokens.inc()
                if self.on_token is not None:
                    self.on_token(r, [tok])
                self._reclaim_window_blocks(r)
                self._finish_if_done(r)
                continue
            if pr.kind == "verify":
                self._commit_verify(r, window[i], int(n_acc[i]), int(final[i]), int(cut[i]), int(start[i]))
                produced += int(cut[i])
                if r.state == RequestState.ACTIVE:
                    self._reclaim_window_blocks(r)
                continue
            c = pr.take
            r.prefill_pos = pr.start + c
            r.step_work += c
            self.pos[r.slot] = r.prefill_pos
            if c:
                self.prefill_chunks += 1
                self.prefill_tokens += c
                self._c_prefill_tokens.inc(c)
                self.tracer.instant(
                    "prefill_chunk", track=slot_track(r.slot), req_id=r.req_id, pos=pr.start, tokens=c
                )
                if self.prefix is not None:
                    r.reg_block, r.reg_parent = self.prefix.register(
                        r.context(), r.blocks, r.prefill_pos, start_block=r.reg_block, parent=r.reg_parent
                    )
            if pr.final:
                self.scheduler.drop_prefilling(r)
                self.tbl[r.slot] = make_table_row(r.blocks, self.max_blocks_per_seq)
                self._tbl_dirty = True
                self.pos[r.slot] = r.prefill_target
                r.prefilling = False
                if not r.generated:
                    self._note_first_token(r, int(final[i]))
        return produced

    def step(self) -> int:
        """One engine iteration: one scheduling pass (admission with SLO
        preemption, then the chunked-prefill budget), then advance all
        decoding slots by one batched decode step and one sampling call;
        with ``fused``, one fused tick."""
        t0 = self._clock()
        done0 = len(self.done)
        if self._profile:
            self._phase_acc = {}
        self._enforce_deadlines()
        if self.fused:
            produced = self._fused_step()
            self._maybe_defrag()
            self._note_step(t0, done0, produced)
            return produced
        self.scheduler.schedule()
        self.peak_active = max(self.peak_active, sum(r is not None for r in self.slots))
        active = [r for r in self.slots if r is not None and not r.prefilling]
        produced = 0
        if active and self.spec_mode != "off":
            self._sync_tables()
            produced = self._spec_step(active)
        elif active:
            self._sync_tables()
            tokens = np.zeros((self.max_batch, 1), np.int32)
            temps = np.zeros((self.max_batch,), np.float32)
            top_ks = np.zeros((self.max_batch,), np.int32)
            for r in active:
                tokens[r.slot, 0] = r.generated[-1]
                temps[r.slot] = r.temperature
                top_ks[r.slot] = r.top_k
            t_decode = self._clock()
            logits, self.cache = self._dispatch(
                "decode", decode_step, self.cfg, self.params, self.cache, self._device_ints(tokens),
                self._device_ints(self.pos), attn_impl=self.attn_impl,
            )
            self.steps += 1
            # one whole-batch sampling call; the all-greedy batch (the common
            # serving default) skips the sort/multinomial work
            t_sample = self._clock() if self._profile else 0.0
            self.dispatches_total += 1  # the sampling call below
            if all(r.temperature <= 0.0 for r in active):
                (sampled,) = self._host_fetch(torch.argmax(logits, dim=-1))
            else:
                (sampled,) = self._host_fetch(sample_tokens(
                    logits, torch.as_tensor(temps, device=self.device),
                    torch.as_tensor(top_ks, device=self.device), self._gen,
                ))
            if self._profile:  # the host fetch is the sync: the sample phase adds none
                self._note_phase("sample", self._clock() - t_sample)
            self._h_decode.observe(self._clock() - t_decode)
            for r in active:
                tok = int(sampled[r.slot])
                r.generated.append(tok)
                self.pos[r.slot] += 1
                produced += 1
                self.tokens_out += 1
                self._c_tokens.inc()
                r.step_work += 1
                if self.on_token is not None:
                    self.on_token(r, [tok])
                if self.cache_kind == "paged":
                    self._reclaim_window_blocks(r)
                self._finish_if_done(r)
        self._maybe_defrag()
        self._note_step(t0, done0, produced)
        return produced

    def _note_step(self, t0: float, done0: int, produced: int) -> None:
        """Per-step observability tail: step latency + span, gauges, and the
        step's energy split over the requests that did work in it."""
        dt = max(self._clock() - t0, 0.0)
        self._h_step.observe(dt)
        span_args = {"produced": produced}
        if self._profile and self._phase_acc:
            span_args["phases"] = {k: round(v, 6) for k, v in self._phase_acc.items()}
        self.tracer.span("step", t0, end=t0 + dt, track=SCHEDULER_TRACK, **span_args)
        self._g_queue.set(len(self.queue))
        self._g_active.set(sum(r is not None and not r.prefilling for r in self.slots))
        self._g_prefilling.set(len(self._prefilling))
        if self.steps:
            self._g_dispatches.set(self.dispatches_total / self.steps)
            self._g_host_syncs.set(self.host_syncs_total / self.steps)
        if self.allocator is not None:
            self._g_frag.set(self.allocator.fragmentation())
        # requests that computed tokens this step (prefill chunks, decode
        # tokens, verify windows): still in a slot, or finished during it;
        # the step's joules split by tokens computed
        workers = [r for r in self.slots if r is not None and r.step_work > 0]
        workers += [r for r in self.done[done0:] if r.step_work > 0]
        joules = self.energy.record_step(dt, occupancy=min(len(workers) / self.max_batch, 1.0))
        self._c_energy.inc(joules)
        total_work = sum(r.step_work for r in workers)
        for r in workers:
            r.energy_j += joules * r.step_work / total_work
            r.step_work = 0

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
        """Engine counters, as the JAX engine's ``stats()``.  A defensive snapshot: every value is a scalar or a fresh dict,
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
            "fused": self.fused,
            "dispatches_total": self.dispatches_total,
            "host_syncs_total": self.host_syncs_total,
            "dispatches_per_step": self.dispatches_total / self.steps if self.steps else 0.0,
            "host_syncs_per_step": self.host_syncs_total / self.steps if self.steps else 0.0,
            "energy_joules": self.energy.joules,
            "joules_per_token": self.energy.joules / self.tokens_out if self.tokens_out else 0.0,
        }
        if self.cache_kind == "paged":
            s["block_size"] = self.block_size
            s["defrag_triggers"] = self.defrag_triggers
            s["evictions"] = self.allocator.evictions
            s.update({f"alloc_{k}": v for k, v in self.allocator.stats().items()})
        if self._graphs is not None and self._graphs.pool is not None:
            # the card's graphs: captures (with their warm-up runs), replays
            # and the kernel launches the replays ran
            s["graphs_captured"] = self._graphs.captures
            s["capture_s"] = self._graphs.capture_s
            s["graph_replays"] = self._graphs.replays
            s["graph_launches"] = dict(self._graphs.launches)
        if self.spec_mode != "off":
            s["spec_decode"] = self.spec_mode
            s["spec_k"] = self.spec_k
            s["spec_steps"] = self.spec_steps
            s["verify_tokens"] = self.verify_tokens
            s["drafted_tokens"] = self.spec_drafted
            s["accepted_tokens"] = self.spec_accepted
            s["acceptance_rate"] = self.spec_accepted / self.spec_drafted if self.spec_drafted else 0.0
            # tokens emitted per slot and verify pass
            s["accepted_per_step"] = self.spec_emitted / self.spec_slot_steps if self.spec_slot_steps else 0.0
        if self.prefix is not None:
            # prompt tokens only: verify windows accrue to verify_tokens
            served = self.prefix_hit_tokens + self.prefill_tokens
            s["prefix_hits"] = self.prefix_hits
            s["prefix_partial_hits"] = self.prefix_partial_hits
            s["prefix_hit_tokens"] = self.prefix_hit_tokens
            s["prefix_hit_rate"] = self.prefix_hit_tokens / served if served else 0.0
            s.update({f"prefix_{k}": v for k, v in self.prefix.stats().items()})
        if self.spill is not None:
            s["spill_hits"] = self.spill_hits
            s["spill_hit_tokens"] = self.spill_hit_tokens
            s["restores"] = self.restores
            s["restores_cancelled"] = self.restores_cancelled
            s["restores_pending"] = len(self._restore_q)
            s.update({f"spill_{k}": v for k, v in self.spill.stats().items()})
        return s
