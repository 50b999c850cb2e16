"""Fault-tolerant multi-replica router with prefix affinity.

One tensor-parallel engine is a single Grace-Hopper node; Isambard-AI
fields 1,362 of them and treats node failure as the baseline operating
condition.  ``Router`` turns N independent ``InferenceEngine`` replicas
(``serving.replica.Replica``: engines on the one card, or tensor-parallel
engines on ranks of their own, driven through ``serving.remote``) into one
service with the JAX package's cluster health model on the serving path:

* **Prefix-affinity routing** — a request is scored against every
  admittable replica's ``PrefixIndex`` (``match_tokens``, a pure peek);
  the replica already holding the most of its prompt wins.  When nothing
  is cached yet (a cold burst of requests sharing a brand-new system
  prompt), a **sticky map** keyed on ``prefix.routing_key`` — the chain
  hash of the prompt's first block — pins the whole burst to one replica
  so the first request's prefill serves the rest.  Everything else
  balances by load (queued + slotted requests).  ``policy="random"`` and
  ``"round_robin"`` exist as the A/B baselines the benchmark degrades to.
* **Health monitoring** — each ``step()`` sweeps heartbeat ages exactly
  like the JAX package's ``Cluster.sweep_heartbeats``: older than
  ``suspect_after`` → SUSPECT (routed around, still admittable as a last
  resort), older than ``fail_after`` → UNHEALTHY + failover.  A ``ReplicaCrashed`` raise
  (real or injected via ``serving.faults.FaultPlan``) fails the replica
  immediately.
* **Failover** — in-flight requests of a failed replica resubmit to a
  healthy one with exponential backoff (``backoff_base_s * 2**attempt``)
  and at most ``max_retries`` moves.  The already-delivered tokens are
  seeded into the fresh engine request, whose chunked admission re-prefills
  ``prompt + generated[:-1]`` — the same committed-context resume contract
  as SLO preemption, so greedy output is token-identical to a no-failure
  run.  Delivery is idempotent: the router forwards only tokens beyond
  what the client already received, so a replay can never duplicate a
  token.  (Non-chunked engines resubmit from scratch; greedy output is
  still identical, the prefix work is just recomputed.)
* **Graceful drain** — ``drain(replica_id)`` stops admission and lets the
  replica finish its work (``migrate=True`` moves it immediately via the
  failover path, without the failure accounting); a drained-clean replica
  RETIREs out of rotation.
* **Degraded mode** — with no admittable replica, ``submit`` raises
  ``ServiceUnavailable`` (HTTP 503) and pending failovers wait under
  backpressure instead of growing a queue nobody will serve; if every
  replica is actually gone they fail fast with ``finish_reason
  ="unavailable"`` so no stream hangs forever.

The router duck-types the engine surface ``AsyncEngine`` drives —
``submit`` / ``step`` / ``abort`` / ``has_work`` / ``eos`` / ``stats`` /
``metrics`` / ``on_token`` / ``on_finish`` — so the asyncio loop and the
HTTP front-end serve a fleet exactly as they serve one engine.

The router steps its replicas one after another on the caller's thread
(under ``AsyncEngine``, its one stepping thread), so on one card two
replicas share the device in turns, not in parallel.  On the card a
failed-over request re-prefills its delivered tokens through chunked
prefill (K2) where its first replica computed them in decode steps (K1),
so its bf16 K/V may differ in the last bits and greedy tokens agree up to
near-ties; on the CPU they are identical.  A copy of the JAX package's
``serving/router.py``.
"""

from __future__ import annotations

import itertools
import random
import time
from dataclasses import dataclass, field
from typing import Callable, Optional

from repro_torch.serving.faults import ReplicaCrashed, ServiceUnavailable
from repro_torch.serving.metrics import MetricsRegistry
from repro_torch.serving.prefix import routing_key
from repro_torch.serving.replica import Replica, ReplicaState
from repro_torch.serving.scheduler import Request
from repro_torch.serving.trace import Tracer, replica_track

ROUTER_TRACK = 0
ROUTING_POLICIES = ("affinity", "random", "round_robin")


def _router_track_label(track: int) -> str:
    return "router" if track == ROUTER_TRACK else f"replica {track - 1}"


@dataclass
class RouterRequest:
    """The router's client-facing request handle.

    ``generated`` holds the tokens actually **delivered** to the client —
    across failovers it is the request's single source of truth (engine-side
    replays are deduplicated against it).  Field names mirror
    ``scheduler.Request`` where the semantics match, so ``AsyncEngine``
    streams router requests unchanged.
    """

    req_id: int
    prompt: list[int]
    kwargs: dict  # submit() knobs, replayed verbatim on failover
    affinity_key: int
    submit_t: float
    generated: list[int] = field(default_factory=list)
    state: str = "active"  # active | done | failed
    finish_reason: Optional[str] = None
    replica_id: Optional[int] = None
    engine_req: Optional[Request] = None
    attempts: int = 1  # submissions tried (first placement included)
    failovers: int = 0  # moves off a failed replica
    retry_at: float = 0.0  # backoff gate while awaiting resubmission
    first_token_t: Optional[float] = None
    done_t: Optional[float] = None

    @property
    def ttft(self) -> Optional[float]:
        return None if self.first_token_t is None else self.first_token_t - self.submit_t

    @property
    def preemptions(self) -> int:
        """Failovers, surfaced under the StreamEvent field of that name."""
        return self.failovers


class Router:
    """Prefix-affinity router over a set of engine replicas."""

    def __init__(
        self,
        replicas: list[Replica],
        *,
        policy: str = "affinity",
        clock: Optional[Callable[[], float]] = None,
        suspect_after: float = 1.0,
        fail_after: float = 5.0,
        max_retries: int = 3,
        backoff_base_s: float = 0.05,
        seed: int = 0,
        metrics: Optional[MetricsRegistry] = None,
        tracer: Optional[Tracer] = None,
        trace_capacity: int = 4096,
    ):
        if not replicas:
            raise ValueError("need at least one replica")
        ids = [r.id for r in replicas]
        if len(set(ids)) != len(ids):
            raise ValueError(f"duplicate replica ids: {ids}")
        if policy not in ROUTING_POLICIES:
            raise ValueError(f"policy={policy!r} (choose from {ROUTING_POLICIES})")
        if not 0 < suspect_after <= fail_after:
            raise ValueError(f"need 0 < suspect_after <= fail_after, got {suspect_after}/{fail_after}")
        if max_retries < 0:
            raise ValueError(f"max_retries={max_retries}")
        self.replicas = list(replicas)
        self.policy = policy
        self._clock = clock if clock is not None else time.monotonic
        self.suspect_after = suspect_after
        self.fail_after = fail_after
        self.max_retries = max_retries
        self.backoff_base_s = backoff_base_s
        self._rng = random.Random(seed)
        self._rr = 0
        self._ids = itertools.count()
        # the first engine's block size keys the sticky map; replicas are
        # homogeneous by construction (one engine configuration per fleet)
        self._bs = getattr(replicas[0].engine, "block_size", 16) or 16
        self._sticky: dict[int, int] = {}  # affinity key -> replica id
        self._by_engine: dict[tuple[int, int], RouterRequest] = {}
        self._pending: list[RouterRequest] = []  # awaiting (re)submission
        self.done: list[RouterRequest] = []
        self.submitted = 0
        # streaming hooks, same contract as the engine's: on_token(req,
        # fresh_tokens) per delivery, on_finish(req) once per request
        self.on_token = None
        self.on_finish = None

        self.metrics = metrics if metrics is not None else MetricsRegistry()
        M = self.metrics
        self._c_requests = M.counter("router_requests_total", "requests accepted by the router")
        self._c_affinity = M.counter("router_affinity_routed_total", "requests routed by prefix affinity (peek or sticky key)")
        self._c_failovers = M.counter("router_failovers_total", "in-flight requests moved off a failed replica")
        self._c_retries = M.counter("router_retries_total", "failover resubmissions actually placed")
        self._c_migrations = M.counter("router_migrations_total", "requests migrated off a draining replica")
        self._c_failed = M.counter("router_requests_failed_total", "requests failed after exhausting retries")
        self._c_unavailable = M.counter("router_unavailable_total", "submissions rejected: no admittable replica")
        self._g_unhealthy = M.gauge("replica_unhealthy", "replicas failed out of rotation (unhealthy or dead)")
        self._g_inflight = M.gauge("router_inflight", "requests placed or awaiting resubmission")
        self.tracer = (
            tracer
            if tracer is not None
            else Tracer(self._clock, trace_capacity, track_label=_router_track_label)
        )
        for rep in self.replicas:
            self._hook(rep)

    # -- engine-hook plumbing ------------------------------------------
    def _hook(self, rep: Replica) -> None:
        rid = rep.id

        def on_token(ereq: Request, toks: list[int]) -> None:
            rreq = self._by_engine.get((rid, ereq.req_id))
            if rreq is None:
                return
            # idempotent delivery: a failed-over request replays its seeded
            # committed tokens through the engine's resume path — forward
            # only what the client has not seen yet
            start = len(ereq.generated) - len(toks)
            fresh = toks[max(len(rreq.generated) - start, 0) :]
            if not fresh:
                return
            if rreq.first_token_t is None:
                rreq.first_token_t = self._clock()
            rreq.generated.extend(fresh)
            if self.on_token is not None:
                self.on_token(rreq, fresh)

        def on_finish(ereq: Request) -> None:
            rreq = self._by_engine.pop((rid, ereq.req_id), None)
            if rreq is None:
                return
            self._finish(rreq, ereq.finish_reason or "length")

        rep.engine.on_token = on_token
        rep.engine.on_finish = on_finish

    def _finish(self, rreq: RouterRequest, reason: str) -> None:
        rreq.state = "failed" if reason in ("failed", "unavailable") else "done"
        rreq.finish_reason = reason
        rreq.done_t = self._clock()
        rreq.engine_req = None
        self.done.append(rreq)
        if self.on_finish is not None:
            self.on_finish(rreq)

    # -- routing --------------------------------------------------------
    @property
    def eos(self) -> int:
        return self.replicas[0].engine.eos

    def _rep(self, replica_id: int) -> Replica:
        for r in self.replicas:
            if r.id == replica_id:
                return r
        raise KeyError(f"no replica {replica_id}")

    def _route(self, prompt: list[int]) -> Replica:
        """Pick a target replica, or raise ``ServiceUnavailable``."""
        cands = [r for r in self.replicas if r.admittable]
        if not cands:
            self._c_unavailable.inc()
            self.tracer.instant("degraded", track=ROUTER_TRACK, replicas=len(self.replicas))
            raise ServiceUnavailable("no admittable replica (degraded mode)")
        # prefer healthy replicas; suspects only when nothing else is left
        healthy = [r for r in cands if r.state == ReplicaState.HEALTHY] or cands
        if self.policy == "random":
            return self._rng.choice(healthy)
        if self.policy == "round_robin":
            rep = healthy[self._rr % len(healthy)]
            self._rr += 1
            return rep
        # affinity: longest cached prefix wins; ties (incl. the all-cold
        # case) fall to the sticky key, then to least load
        key = routing_key(prompt, self._bs)
        scored = [
            (r.engine.prefix.match_tokens(prompt) if r.engine.prefix is not None else 0, r)
            for r in healthy
        ]
        best = max(s for s, _ in scored)
        if best > 0:
            rep = min((r for s, r in scored if s == best), key=lambda r: (r.load, r.id))
            self._c_affinity.inc()
        else:
            sticky = self._sticky.get(key)
            rep = next((r for r in healthy if r.id == sticky), None)
            if rep is not None:
                self._c_affinity.inc()
            else:
                rep = min(healthy, key=lambda r: (r.load, r.id))
        self._sticky[key] = rep.id
        return rep

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
    ) -> RouterRequest:
        """Route and place one request.  Raises ``ServiceUnavailable`` in
        degraded mode; engine validation errors propagate unchanged."""
        prompt = list(prompt)
        rep = self._route(prompt)
        rreq = RouterRequest(
            req_id=next(self._ids),
            prompt=prompt,
            kwargs=dict(
                max_new_tokens=max_new_tokens,
                online=online,
                temperature=temperature,
                top_k=top_k,
                priority=priority,
                deadline_s=deadline_s,
            ),
            affinity_key=routing_key(prompt, self._bs),
            submit_t=self._clock(),
        )
        self._place(rreq, rep)
        self.submitted += 1
        self._c_requests.inc()
        return rreq

    def _place(self, rreq: RouterRequest, rep: Replica) -> None:
        ereq = rep.engine.submit(rreq.prompt, **rreq.kwargs)
        if rreq.generated and rep.engine.chunked():
            # failover resume: seed the delivered tokens so chunked
            # admission re-prefills prompt + generated[:-1] and decode
            # re-feeds the trailing token — the preemption-resume contract,
            # token-identical under greedy sampling
            ereq.generated = list(rreq.generated)
        rreq.engine_req = ereq
        rreq.replica_id = rep.id
        self._by_engine[(rep.id, ereq.req_id)] = rreq
        self.tracer.instant(
            "route",
            track=replica_track(rep.id),
            req_id=rreq.req_id,
            engine_req_id=ereq.req_id,
            resumed_tokens=len(rreq.generated),
        )

    def abort(self, req, reason: str = "aborted") -> bool:
        """Abort a router request (by handle or router req_id) wherever it
        currently lives — on a replica, or parked awaiting resubmission."""
        if isinstance(req, int):
            req = next(
                (
                    r
                    for r in list(self._by_engine.values()) + self._pending
                    if r.req_id == req
                ),
                None,
            )
        if req is None or req.state != "active":
            return False
        if req in self._pending:
            self._pending.remove(req)
            self._finish(req, reason)
            return True
        if req.engine_req is None or req.replica_id is None:
            return False
        rep = self._rep(req.replica_id)
        # the engine's on_finish hook routes back into _finish with the
        # abort reason, completing the router-side bookkeeping
        return rep.engine.abort(req.engine_req, reason)

    # -- failure handling ----------------------------------------------
    def _fail_replica(self, rep: Replica, cause: str) -> None:
        rep.state = ReplicaState.DEAD if cause == "crash" else ReplicaState.UNHEALTHY
        orphan_keys = [k for k in self._by_engine if k[0] == rep.id]
        orphans = [self._by_engine.pop(k) for k in orphan_keys]
        self.tracer.instant(
            "replica_down",
            track=replica_track(rep.id),
            cause=cause,
            inflight=len(orphans),
        )
        now = self._clock()
        for rreq in orphans:
            self._schedule_failover(rreq, now)

    def _schedule_failover(self, rreq: RouterRequest, now: float) -> None:
        rreq.engine_req = None
        rreq.replica_id = None
        if rreq.attempts > self.max_retries:
            self._c_failed.inc()
            self._finish(rreq, "failed")
            return
        rreq.failovers += 1
        rreq.retry_at = now + self.backoff_base_s * (2 ** (rreq.attempts - 1))
        rreq.attempts += 1
        self._pending.append(rreq)
        self._c_failovers.inc()
        self.tracer.instant(
            "failover",
            track=ROUTER_TRACK,
            req_id=rreq.req_id,
            attempt=rreq.attempts,
            delivered=len(rreq.generated),
            retry_at=rreq.retry_at,
        )

    def _resubmit_ready(self, now: float) -> None:
        if not self._pending:
            return
        if not any(r.alive for r in self.replicas):
            # every replica is gone: nothing will ever serve these — fail
            # fast so streams terminate instead of hanging on backpressure
            for rreq in self._pending:
                self._c_failed.inc()
                self._finish(rreq, "unavailable")
            self._pending = []
            return
        still: list[RouterRequest] = []
        for rreq in self._pending:
            if rreq.retry_at > now:
                still.append(rreq)
                continue
            try:
                rep = self._route(rreq.prompt)
            except ServiceUnavailable:
                still.append(rreq)  # degraded: hold under backpressure
                continue
            self._place(rreq, rep)
            rep.failovers_in += 1
            self._c_retries.inc()
        self._pending = still

    def _sweep_health(self, now: float) -> None:
        for rep in self.replicas:
            if not rep.alive or rep.state == ReplicaState.DRAINING:
                continue
            age = rep.heartbeat_age(now)
            if age >= self.fail_after:
                self._fail_replica(rep, "missed_heartbeats")
            elif age >= self.suspect_after:
                if rep.state == ReplicaState.HEALTHY:
                    rep.state = ReplicaState.SUSPECT
                    self.tracer.instant(
                        "replica_suspect", track=replica_track(rep.id), age=age
                    )
            elif rep.state == ReplicaState.SUSPECT:
                rep.state = ReplicaState.HEALTHY
                self.tracer.instant(
                    "replica_recovered", track=replica_track(rep.id), age=age
                )

    # -- drain ----------------------------------------------------------
    def drain(self, replica_id: int, *, migrate: bool = False) -> None:
        """Stop admission to a replica.  ``migrate=False`` lets it finish
        its in-flight work (it keeps stepping, then retires);
        ``migrate=True`` moves the work to peers immediately through the
        failover path, minus the failure accounting."""
        rep = self._rep(replica_id)
        if not rep.alive:
            raise ValueError(f"replica {replica_id} is {rep.state.value}; cannot drain")
        rep.state = ReplicaState.DRAINING
        self.tracer.instant(
            "drain", track=replica_track(rep.id), migrate=migrate, inflight=rep.load
        )
        if not migrate:
            return
        now = self._clock()
        for key in [k for k in self._by_engine if k[0] == rep.id]:
            rreq = self._by_engine.pop(key)
            # engine-side teardown (frees blocks, fires on_finish — which
            # finds no mapping and no-ops); router-side the request goes
            # straight back to the resubmission queue, no backoff
            rep.engine.abort(rreq.engine_req, "migrated")
            rreq.engine_req = None
            rreq.replica_id = None
            rreq.retry_at = now
            self._pending.append(rreq)
            self._c_migrations.inc()

    def _retire(self, rep: Replica) -> None:
        rep.state = ReplicaState.RETIRED
        self.tracer.instant("drain_complete", track=replica_track(rep.id), steps=rep.steps)

    # -- stepping --------------------------------------------------------
    @property
    def has_work(self) -> bool:
        return bool(self._pending) or any(
            r.alive and r.engine.has_work for r in self.replicas
        )

    def step(self) -> int:
        """One fleet iteration: place due resubmissions, step every live
        replica (catching crashes), then sweep heartbeat health."""
        self._resubmit_ready(self._clock())
        produced = 0
        for rep in self.replicas:
            if not rep.alive:
                continue
            if rep.state == ReplicaState.DRAINING and not rep.engine.has_work:
                self._retire(rep)
                continue
            try:
                produced += rep.step()
            except ReplicaCrashed:
                self._fail_replica(rep, "crash")
        self._sweep_health(self._clock())
        self._g_unhealthy.set(
            sum(r.state in (ReplicaState.UNHEALTHY, ReplicaState.DEAD) for r in self.replicas)
        )
        self._g_inflight.set(len(self._by_engine) + len(self._pending))
        return produced

    def run_until_drained(self, max_steps: int = 10_000) -> list[RouterRequest]:
        """Closed-loop drain, the fleet analogue of the engine's."""
        for _ in range(max_steps):
            if not self.has_work:
                break
            self.step()
        return self.done

    # -- introspection ---------------------------------------------------
    def stats(self) -> dict:
        """Fleet-level aggregates plus per-replica engine stats."""
        engines = [r.engine for r in self.replicas]
        hit = sum(getattr(e, "prefix_hit_tokens", 0) for e in engines)
        prefill = sum(e.prefill_tokens for e in engines)
        served = hit + prefill
        return {
            "routing_policy": self.policy,
            "replicas": len(self.replicas),
            "replicas_admittable": sum(r.admittable for r in self.replicas),
            "requests_submitted": self.submitted,
            "requests_done": sum(r.state == "done" for r in self.done),
            "requests_failed": sum(r.state == "failed" for r in self.done),
            "requests_inflight": len(self._by_engine) + len(self._pending),
            "failovers": self._c_failovers.value,
            "retries": self._c_retries.value,
            "migrations": self._c_migrations.value,
            "tokens_out": sum(e.tokens_out for e in engines),
            "prefill_tokens": prefill,
            "prefix_hit_tokens": hit,
            "prefix_hit_rate": hit / served if served else 0.0,
            "replica_states": {r.id: r.state.value for r in self.replicas},
            "per_replica": {r.id: r.engine.stats() for r in self.replicas},
        }
