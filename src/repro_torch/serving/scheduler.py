"""Scheduler core for the serving engine: SLO policy, admission, preemption.

The paper's access model is a supercomputer operated like a cloud service —
Jupyter, MLOps and web front-ends under continuous interactive load — so the
serving stack's scheduling brain must be a component of its own, shared
between the closed-loop drain path (``InferenceEngine.run_until_drained``)
and the always-on asyncio loop (``serving.async_engine``).  This module is
that brain, extracted from the formerly monolithic ``engine.step()``:

* **Queue ordering (SLO policy)** — ``policy="slo"`` (default) orders the
  waiting queue by ``(priority desc, online first, earliest absolute
  deadline, FCFS)``: a request's ``priority`` is an integer class (higher
  admits first) and ``deadline_s`` is a per-request TTFT target in seconds
  from submit, used as an earliest-deadline-first tiebreak within a
  priority class.  With every knob left at its default the order reduces
  exactly to the historical behaviour (online ahead of offline backfill,
  FCFS within each class), so ``policy="fcfs"`` — which ignores priorities
  and deadlines outright — only differs when SLO knobs are actually used.
* **Admission** — the scheduler walks the queue head-first, placing
  requests into free batch slots through the engine's admission primitives
  (prefix-matched block-budgeted chunked admission, or the blocking
  prefill+graft path).  Admission backpressures head-of-line when the block
  pool can't cover the head request, exactly as before.
* **Preemption** — under pressure (no free slot, or the pool can't cover a
  strictly-higher-priority head request), the SLO policy evicts a victim:
  the lowest-priority running request (offline before online, most recently
  admitted first — least computed work lost).  The engine releases the
  victim's blocks through the prefix index, so the committed context parks
  in the LRU cached pool and the re-admission mostly *recovers* the work as
  a prefix hit; the victim requeues at its policy position and resumes via
  the normal chunked-admission path.  Preemption needs the chunk-resumable
  paged path (dense/moe families); hybrid/dense-cache engines never preempt.
* **Chunked-prefill budgeting** — each step spends ``prefill_budget``
  prompt tokens (0 = drain) on the oldest admitted prompts, FCFS in
  admission order, with the binary chunk decomposition bounding the jitted
  trace count.  Resumed (previously preempted) requests prefill their
  committed context ``prompt + generated[:-1]``; the trailing generated
  token is re-fed by the next decode step, so no first-token is re-emitted.
* **Spec-decode windows** — the per-slot draft window is clamped here
  (never draft past the generation budget), keeping every scheduling
  decision in one place.
* **Fused planning** — ``plan()`` runs the same admission/restore pass as
  ``schedule()`` but returns one ``StepPlan`` of typed ``PlanRow``s
  (``decode`` / ``chunk`` / ``verify``) instead of making imperative model
  calls: the fused engine (``fused=True``) lowers the whole plan into a
  single jitted dispatch and applies the side effects afterwards.

The scheduler drives the engine through a narrow operations surface
(``free_slots`` / ``running`` / ``try_admit`` / ``preempt`` / ``can_preempt``
/ ``chunked`` / ``run_chunk`` / ``finish_prefill``) and owns only host-side
Python state — no device work, no clocks, no metrics of its own — so it is
trivially mesh-invariant and reusable by the async front-end unchanged.
"""

from __future__ import annotations

import math
from bisect import insort
from dataclasses import dataclass, field
from enum import Enum
from typing import Optional


def binary_chunks(n: int) -> list[int]:
    """Split ``n`` tokens into power-of-two chunk sizes, largest first
    (e.g. 52 -> [32, 16, 4]).  Chunk lengths drawn from a log-bounded set
    keep the jitted ``prefill_step`` trace count O(log max_seq) without any
    pad tokens — padding would perturb MoE expert-capacity routing."""
    out = []
    bit = 1 << max(n.bit_length() - 1, 0)
    while n > 0:
        if n >= bit:
            out.append(bit)
            n -= bit
        bit >>= 1
    return out


class RequestState(Enum):
    WAITING = "waiting"
    ACTIVE = "active"
    DONE = "done"


@dataclass
class Request:
    req_id: int
    prompt: list[int]
    max_new_tokens: int = 32
    online: bool = True  # online requests admit before offline ones
    priority: int = 0  # SLO class: higher admits first, can preempt lower
    deadline_s: Optional[float] = None  # TTFT target (seconds from submit); EDF tiebreak
    temperature: float = 0.0
    top_k: int = 0  # 0 = full softmax (only applies when temperature > 0)
    state: RequestState = RequestState.WAITING
    # how the request ended: "eos" / "length", or an abort cause
    # ("aborted", "cancelled", "deadline_exceeded", "migrated", ...)
    finish_reason: Optional[str] = None
    generated: list[int] = field(default_factory=list)
    slot: Optional[int] = None
    blocks: list[int] = field(default_factory=list)  # paged: owned physical blocks
    freed_blocks: int = 0  # paged: leading blocks already reclaimed (sliding window)
    # spill tier: device blocks whose rows are still in flight from the host
    # pool — the request may not prefill or publish until this empties
    pending_restores: set[int] = field(default_factory=set)
    prefill_pos: int = 0  # chunked: context tokens already in the cache
    prefilling: bool = False  # chunked: admitted but context not fully processed
    preemptions: int = 0  # times this request was evicted and requeued
    prefix_hit_tokens: int = 0  # context tokens served from the prefix cache
    reg_block: int = 0  # prefix registration resume point (block index, ...
    reg_parent: int = 0  # ... chain hash) — registration is incremental
    # timestamps come from the engine's injectable clock (metrics.ManualClock
    # in tests), not time.monotonic directly — latencies are assertable
    submit_t: float = 0.0
    admit_t: Optional[float] = None
    first_token_t: Optional[float] = None
    done_t: Optional[float] = None
    energy_j: float = 0.0  # IT-side joules attributed to this request
    step_work: int = 0  # tokens computed this step (energy attribution; reset per step)

    def context(self) -> list[int]:
        """Committed token context: prompt plus everything generated."""
        return self.prompt + self.generated

    @property
    def prefill_target(self) -> int:
        """Context tokens that must be in the cache before decode can run.

        Fresh requests prefill the whole prompt (the first generated token
        is sampled from the final chunk's logits); a resumed request
        prefills ``prompt + generated[:-1]`` — the trailing generated token
        is re-fed by the next decode step, which writes its K/V row and
        samples the continuation, exactly as if it had never left its slot.
        """
        return len(self.prompt) + max(len(self.generated) - 1, 0)

    @property
    def deadline_t(self) -> float:
        """Absolute TTFT deadline on the engine clock (inf when unset)."""
        return math.inf if self.deadline_s is None else self.submit_t + self.deadline_s

    @property
    def ttft(self) -> Optional[float]:
        return None if self.first_token_t is None else self.first_token_t - self.submit_t

    @property
    def queue_wait(self) -> Optional[float]:
        return None if self.admit_t is None else self.admit_t - self.submit_t

    @property
    def tpot(self) -> Optional[float]:
        """Mean inter-token time after the first token (finished requests
        with >= 2 generated tokens)."""
        if self.done_t is None or self.first_token_t is None or len(self.generated) < 2:
            return None
        return (self.done_t - self.first_token_t) / (len(self.generated) - 1)

    @property
    def joules_per_token(self) -> Optional[float]:
        return self.energy_j / len(self.generated) if self.generated else None


POLICIES = ("slo", "fcfs")


@dataclass
class PlanRow:
    """One typed row of a fused step: what the engine feeds, not how.

    ``kind``: ``"decode"`` (one token, published table), ``"chunk"`` (a
    prefill chunk of ``take`` tokens from the request's private table) or
    ``"verify"`` (a spec_k+1 speculative window).  ``start`` is the row's
    absolute cache position (-1 = engine-resolved from its position array —
    decode/verify rows).  ``final`` marks the chunk that completes the
    prompt: its table publishes and (for fresh requests) its last real
    lane's logits yield the first token."""

    kind: str  # "decode" | "chunk" | "verify"
    req: Request
    start: int = -1
    take: int = 1
    final: bool = False


@dataclass
class StepPlan:
    """One scheduler tick's worth of model work as a unified row batch.

    Produced by ``SchedulerCore.plan()`` (the fused engine path) instead of
    the imperative ``schedule()`` walk: the scheduler decides WHAT runs —
    admission, restores, the prefill-budget split into binary chunks, the
    decode/verify row set — and the engine lowers the whole plan into ONE
    jitted dispatch.  ``plan()`` mutates no request state; the engine applies
    positions/bookkeeping after the dispatch returns."""

    rows: list[PlanRow] = field(default_factory=list)

    @property
    def chunk_rows(self) -> list[PlanRow]:
        return [r for r in self.rows if r.kind == "chunk"]

    @property
    def model_rows(self) -> list[PlanRow]:
        return [r for r in self.rows if r.kind != "chunk"]


class SchedulerCore:
    """Admission, SLO ordering, preemption and prefill budgeting.

    ``ops`` is the execution backend (the ``InferenceEngine``), driven
    through a narrow surface:

    ==================  =====================================================
    ``free_slots()``    free batch-slot indices
    ``running()``       requests currently holding a slot (decoding or
                        mid-prefill)
    ``try_admit(r, s)`` place request ``r`` into slot ``s``; False when the
                        block pool can't cover it (backpressure)
    ``can_preempt()``   True when eviction+resume is supported (chunked
                        paged engines)
    ``preempt(r)``      evict ``r``: release its blocks (prefix-indexed
                        content parks in the LRU pool), clear its slot,
                        mark it WAITING
    ``chunked()``       True when prompts stream in budgeted chunks
    ``run_chunk(r, c)`` run one c-token context chunk; returns the logits
    ``finish_prefill``  publish the block table; fresh requests sample
                        their first token, resumed ones re-enter decode
    ==================  =====================================================
    """

    def __init__(
        self,
        ops,
        *,
        policy: str = "slo",
        prefill_budget: int = 0,
        restore_budget: int = 4,
    ):
        if policy not in POLICIES:
            raise ValueError(f"policy={policy!r} (choose from {POLICIES})")
        self.ops = ops
        self.policy = policy
        self.prefill_budget = prefill_budget
        self.restore_budget = restore_budget  # spill swap-ins executed per step
        self.queue: list[Request] = []  # maintained in policy order
        self.prefilling: list[Request] = []  # admission (FCFS) order
        self.preemptions = 0  # eviction decisions taken

    # -- queue ---------------------------------------------------------
    def _key(self, r: Request):
        if self.policy == "fcfs":
            return (not r.online, r.req_id)
        return (-r.priority, not r.online, r.deadline_t, r.req_id)

    def enqueue(self, req: Request) -> None:
        """Insert at the request's policy position (binary search — the
        queue is kept sorted, never re-sorted per admission pass)."""
        insort(self.queue, req, key=self._key)

    def dequeue(self, req: Request) -> bool:
        """Remove a waiting request from the queue (abort path).  Returns
        False when it is not queued (already admitted or finished)."""
        if req in self.queue:
            self.queue.remove(req)
            return True
        return False

    def drop_prefilling(self, req: Request) -> None:
        """Forget a mid-prefill request (preempted before its first token)."""
        if req in self.prefilling:
            self.prefilling.remove(req)

    @property
    def idle(self) -> bool:
        return not self.queue and not self.prefilling

    # -- spec-decode windows -------------------------------------------
    @staticmethod
    def spec_window(req: Request, k: int) -> int:
        """Draft window for one slot: never draft past the generation
        budget — at most ``remaining - 1`` so the verify window's +1
        correction/bonus token stays within ``max_new_tokens``."""
        return min(k, req.max_new_tokens - len(req.generated) - 1)

    # -- admission + preemption ----------------------------------------
    def _preempt_for(self, req: Request) -> bool:
        """Evict one victim to make room for ``req``.  Victim: the
        lowest-priority running request strictly below ``req.priority``
        (offline before online, most recently admitted first — the least
        computed work is lost).  Returns False when nothing is evictable."""
        if self.policy != "slo" or not self.ops.can_preempt():
            return False
        victims = [r for r in self.ops.running() if r.priority < req.priority]
        if not victims:
            return False
        victim = min(victims, key=lambda r: (r.priority, r.online, -(r.admit_t or 0.0)))
        self.ops.preempt(victim)
        self.drop_prefilling(victim)
        self.preemptions += 1
        self.enqueue(victim)
        return True

    def _admit(self) -> None:
        ops = self.ops
        free = ops.free_slots()
        while self.queue:
            req = self.queue[0]
            if not free:
                if not self._preempt_for(req):
                    break  # batch full, nothing evictable
                free = ops.free_slots()
                continue
            if ops.try_admit(req, free[0]):
                self.queue.pop(0)
                free.pop(0)
                continue
            # out of blocks: evict a lower-priority victim and retry, else
            # backpressure head-of-line until finishes free their blocks
            if not self._preempt_for(req):
                break
            free = ops.free_slots()

    def _prefill(self) -> None:
        """Spend this step's prefill token budget on the oldest admitted
        contexts (FCFS).  ``prefill_budget <= 0`` drains every pending
        context (the blocking-throughput configuration); a positive budget
        bounds prefill work per step so decode latency stays flat while
        long prompts stream in."""
        if not self.ops.chunked():
            return
        budget = self.prefill_budget if self.prefill_budget > 0 else math.inf
        restoring = getattr(self.ops, "restoring", None)
        i = 0
        while i < len(self.prefilling) and budget > 0:
            req = self.prefilling[i]
            if restoring is not None and restoring(req):
                # spill swap-ins still in flight: the request's block table
                # points at rows the restore pass has not written yet, so it
                # must not prefill (or publish) this step.  Skip — don't
                # stall the budget behind it — and let younger admitted
                # prompts spend the tokens; FCFS order is preserved among
                # the runnable ones.
                i += 1
                continue
            take = int(min(budget, req.prefill_target - req.prefill_pos))
            logits = None
            for c in binary_chunks(take):
                logits = self.ops.run_chunk(req, c)
            budget -= take
            if req.prefill_pos >= req.prefill_target:
                self.prefilling.pop(i)
                self.ops.finish_prefill(req, logits)
            else:
                i += 1

    def _restore(self) -> None:
        """Execute up to ``restore_budget`` queued spill swap-ins (host ->
        device block-row copies) before prefill, so requests admitted
        against spilled prefix entries become runnable as early as
        possible.  Engines without a spill tier simply lack the op."""
        run = getattr(self.ops, "run_restores", None)
        if run is not None:
            run(self.restore_budget)

    def schedule(self) -> None:
        """One scheduling pass: admission (with preemption under the SLO
        policy), spill restores, then the chunked-prefill budget."""
        self._admit()
        self._restore()
        self._prefill()

    # -- fused planning ------------------------------------------------
    def _plan_prefill(self) -> list[PlanRow]:
        """The ``_prefill`` budget walk re-expressed as rows: same FCFS
        order, same restore skip, same binary-chunk decomposition — but no
        ``run_chunk`` calls and no request mutation.  Several chunks of one
        request become several rows (the fused dispatch scatters each
        layer's K/V before attending, so a later chunk row reads the earlier
        chunk row's same-layer writes exactly as sequential chunking would)."""
        if not self.ops.chunked():
            return []
        budget = self.prefill_budget if self.prefill_budget > 0 else math.inf
        restoring = getattr(self.ops, "restoring", None)
        rows: list[PlanRow] = []
        for req in self.prefilling:
            if budget <= 0:
                break
            if restoring is not None and restoring(req):
                continue  # swap-ins in flight: skip, don't stall the budget
            take = int(min(budget, req.prefill_target - req.prefill_pos))
            pos = req.prefill_pos
            chunks = binary_chunks(take)
            for c in chunks:
                pos += c
                rows.append(
                    PlanRow("chunk", req, pos - c, c, final=pos >= req.prefill_target)
                )
            if not chunks and pos >= req.prefill_target:
                # fully prefix-matched resumed context: nothing to feed, the
                # table just publishes (a zero-width row the engine masks out)
                rows.append(PlanRow("chunk", req, pos, 0, final=True))
            budget -= take
        return rows

    def plan(self, *, spec: bool = False) -> StepPlan:
        """One scheduling pass for the fused engine: admission + restores as
        ``schedule()``, then ONE ``StepPlan`` of typed rows instead of
        imperative per-chunk model calls.  Decoding slots become ``decode``
        rows (or ``verify`` rows when ``spec``); the prefill budget becomes
        ``chunk`` rows.  The engine owns applying the plan's side effects."""
        self._admit()
        self._restore()
        rows = [
            PlanRow("verify" if spec else "decode", r)
            for r in self.ops.running()
            if not r.prefilling
        ]
        rows += self._plan_prefill()
        return StepPlan(rows)
