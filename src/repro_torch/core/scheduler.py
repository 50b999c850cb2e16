"""QoS-class scheduler: the paper's four AI usage patterns, made executable.

Paper §IV.F identifies four patterns the resource manager must serve —

* **experimentation** — short, large-capacity, interactive (fast start)
* **training**        — days-to-months, large capacity
* **fine-tuning**     — short, low capacity
* **inference**       — online/offline serving pipelines (latency-sensitive)

— and two scheduling modes borrowed from Google's AI-hypercomputer model:

* **Flex Start with guaranteed completion**: batch jobs that may be
  preempted/interrupted but are ALWAYS resumed from their periodic
  checkpoint until they complete (modes 2 & 4 in the paper).
* **Calendar**: reserved start/stop windows with automated start (1, 3, 4).

This module implements both on top of ``core.cluster.Cluster`` with
conservative backfill, per-QoS priorities/preemption and placement that
prefers keeping a job inside one pod (the paper's tightly-integrated-fabric
argument).  It is a deterministic discrete-time simulator: production would
drive ``tick`` from a wall clock, tests drive it manually.

A copy of the JAX package's ``core/scheduler.py`` (it holds no JAX).
"""

from __future__ import annotations

import enum
import itertools
from dataclasses import dataclass, field
from typing import Optional

from repro_torch.core.cluster import CHIPS_PER_NODE, Cluster, Node, NodeState


class QoS(enum.Enum):
    EXPERIMENTATION = "experimentation"
    TRAINING = "training"
    FINE_TUNING = "fine_tuning"
    INFERENCE = "inference"


# priority: inference serving first (latency), interactive next, batch last
PRIORITY = {QoS.INFERENCE: 0, QoS.EXPERIMENTATION: 1, QoS.FINE_TUNING: 2, QoS.TRAINING: 3}

# preemption: lower-priority-value jobs may preempt higher-value ones
PREEMPTIBLE_BY_DEFAULT = {QoS.TRAINING: True, QoS.FINE_TUNING: True, QoS.EXPERIMENTATION: False, QoS.INFERENCE: False}


class JobState(enum.Enum):
    PENDING = "pending"
    RUNNING = "running"
    PREEMPTED = "preempted"  # will flex-restart from checkpoint
    INTERRUPTED = "interrupted"  # node failure; awaiting restart
    COMPLETED = "completed"
    FAILED = "failed"  # exceeded restart budget


@dataclass
class Job:
    job_id: str
    tenant: str
    qos: QoS
    chips: int  # requested chips (rounded up to whole nodes)
    duration: float  # estimated remaining runtime (sim seconds)
    submit_time: float = 0.0
    preemptible: Optional[bool] = None
    checkpoint_interval: float = 60.0  # flex-start periodic checkpoint cadence
    # elasticity: the job can run on any chip count in [min_chips, chips]
    min_chips: Optional[int] = None
    state: JobState = JobState.PENDING
    nodes: list[int] = field(default_factory=list)
    start_time: float = -1.0
    progress: float = 0.0  # completed work (sim seconds at full capacity)
    last_checkpoint: float = 0.0  # progress value at the last checkpoint
    restarts: int = 0
    max_restarts: int = 16
    preemptions: int = 0

    def __post_init__(self):
        if self.preemptible is None:
            self.preemptible = PREEMPTIBLE_BY_DEFAULT[self.qos]
        if self.min_chips is None:
            self.min_chips = self.chips

    @property
    def nodes_needed(self) -> int:
        return -(-self.chips // CHIPS_PER_NODE)

    @property
    def remaining(self) -> float:
        return max(self.duration - self.progress, 0.0)


@dataclass
class Reservation:
    """Calendar mode: a guaranteed capacity window with automated start."""

    res_id: str
    tenant: str
    chips: int
    start: float
    end: float
    job: Optional[Job] = None  # job auto-started inside the window

    @property
    def nodes_needed(self) -> int:
        return -(-self.chips // CHIPS_PER_NODE)


class Scheduler:
    def __init__(self, cluster: Cluster):
        self.cluster = cluster
        self.queue: list[Job] = []
        self.running: dict[str, Job] = {}
        self.done: dict[str, Job] = {}
        self.reservations: list[Reservation] = []
        self.log: list[tuple[float, str, str]] = []  # (time, event, job/res id)
        cluster.on_event(self._cluster_event)
        self._now = 0.0

    # ------------------------------------------------------------------
    def submit(self, job: Job) -> Job:
        job.submit_time = self._now
        self.queue.append(job)
        self._log("submit", job.job_id)
        return job

    def reserve(self, res: Reservation) -> Reservation:
        self.reservations.append(res)
        self._log("reserve", res.res_id)
        return res

    def _log(self, event: str, ident: str) -> None:
        self.log.append((self._now, event, ident))

    # ------------------------------------------------------------------
    # placement
    # ------------------------------------------------------------------

    def _reserved_nodes_now(self, horizon: float = 0.0) -> int:
        """Nodes that must stay free for reservations active at now+horizon."""
        t = self._now + horizon
        return sum(
            r.nodes_needed
            for r in self.reservations
            if r.start <= t < r.end and r.job is None
        )

    def _pick_nodes(self, job: Job) -> Optional[list[int]]:
        """Prefer a single pod (tight fabric); spill across pods only if the
        job itself is bigger than a pod."""
        need = job.nodes_needed
        pods = sorted({n.pod for n in self.cluster.nodes.values()})
        # single-pod placement
        for pod in pods:
            free = self.cluster.free_nodes(pod)
            if len(free) >= need:
                return [n.node_id for n in free[:need]]
        # multi-pod spill: largest-free-first
        free_all = sorted(self.cluster.free_nodes(), key=lambda n: n.pod)
        if len(free_all) >= need:
            return [n.node_id for n in free_all[:need]]
        return None

    def _start(self, job: Job, nodes: list[int]) -> None:
        self.cluster.allocate(nodes, job.job_id, job.tenant)
        job.nodes = nodes
        job.state = JobState.RUNNING
        job.start_time = self._now
        self.running[job.job_id] = job
        self._log("start", job.job_id)

    def _stop(self, job: Job, state: JobState, *, rollback: bool) -> None:
        self.cluster.release(job.job_id)
        job.nodes = []
        job.state = state
        self.running.pop(job.job_id, None)
        if rollback:
            # flex-start semantics: lose work since the last checkpoint
            job.progress = job.last_checkpoint
        if state in (JobState.COMPLETED, JobState.FAILED):
            self.done[job.job_id] = job
        self._log(state.value, job.job_id)

    # ------------------------------------------------------------------
    # the clock
    # ------------------------------------------------------------------

    def tick(self, now: float) -> None:
        """Advance simulated time to ``now``: progress work, checkpoint,
        complete, start reservations, schedule the queue (with backfill)."""
        dt = now - self._now
        assert dt >= 0, "time went backwards"
        self._now = now

        # 1. progress running jobs; take periodic checkpoints; complete
        for job in list(self.running.values()):
            job.progress += dt
            while job.progress - job.last_checkpoint >= job.checkpoint_interval:
                job.last_checkpoint += job.checkpoint_interval
                self._log("checkpoint", job.job_id)
            if job.progress >= job.duration:
                self._stop(job, JobState.COMPLETED, rollback=False)

        # 2. calendar reservations: auto-start at window open, stop at close
        for res in self.reservations:
            if res.job is not None and res.job.state == JobState.RUNNING and now >= res.end:
                self._stop(res.job, JobState.COMPLETED, rollback=False)
            if res.job is None and res.start <= now < res.end:
                job = Job(
                    job_id=f"res:{res.res_id}",
                    tenant=res.tenant,
                    qos=QoS.TRAINING,
                    chips=res.chips,
                    duration=res.end - res.start,
                    preemptible=False,
                )
                nodes = self._pick_nodes(job)
                if nodes is None:
                    nodes = self._evict_for(job)
                if nodes is not None:
                    res.job = job
                    self._start(job, nodes)

        # 3. schedule the queue by priority, then backfill
        self._schedule_queue()

    def _schedule_queue(self) -> None:
        self.queue.sort(key=lambda j: (PRIORITY[j.qos], j.submit_time))
        scheduled = []
        reserved = self._reserved_nodes_now(horizon=0.0)
        for job in self.queue:
            free = len(self.cluster.free_nodes()) - reserved
            need = job.nodes_needed
            nodes = self._pick_nodes(job) if free >= need else None
            if nodes is not None:
                self._start(job, nodes)
                scheduled.append(job)
                continue
            # elastic shrink: flex jobs can start on fewer chips
            if job.min_chips < job.chips and free * CHIPS_PER_NODE >= job.min_chips:
                shrunk = Job(**{**job.__dict__, "chips": free * CHIPS_PER_NODE})
                nodes = self._pick_nodes(shrunk)
                if nodes is not None:
                    job.chips = shrunk.chips
                    self._start(job, nodes)
                    scheduled.append(job)
                    self._log("elastic_shrink_start", job.job_id)
                    continue
            # preemption: inference/experimentation may evict flex batch jobs
            if PRIORITY[job.qos] <= PRIORITY[QoS.EXPERIMENTATION]:
                nodes = self._evict_for(job)
                if nodes is not None:
                    self._start(job, nodes)
                    scheduled.append(job)
        for job in scheduled:
            self.queue.remove(job)

    def _evict_for(self, job: Job) -> Optional[list[int]]:
        """Preempt lowest-priority preemptible jobs until ``job`` fits."""
        victims = sorted(
            (j for j in self.running.values() if j.preemptible),
            key=lambda j: -PRIORITY[j.qos],
        )
        freed = len(self.cluster.free_nodes())
        plan = []
        for v in victims:
            if freed >= job.nodes_needed:
                break
            freed += len(v.nodes)
            plan.append(v)
        if freed < job.nodes_needed:
            return None
        for v in plan:
            v.preemptions += 1
            self._stop(v, JobState.PREEMPTED, rollback=True)
            self.queue.append(v)  # flex-start: guaranteed completion
            v.state = JobState.PENDING
        return self._pick_nodes(job)

    # ------------------------------------------------------------------
    # fault events (wired by core.fault.FaultTolerantRunner as well)
    # ------------------------------------------------------------------

    def _cluster_event(self, event: str, node: Node) -> None:
        if event != "failed" or node.job is None:
            return
        job = self.running.get(node.job)
        if job is None:
            return
        job.restarts += 1
        if job.restarts > job.max_restarts:
            self._stop(job, JobState.FAILED, rollback=True)
            return
        # flex-start: roll back to checkpoint and requeue (guaranteed completion)
        self._stop(job, JobState.INTERRUPTED, rollback=True)
        job.state = JobState.PENDING
        self.queue.append(job)
        self._log("restart_queued", job.job_id)

    # ------------------------------------------------------------------
    def utilization(self) -> float:
        busy = sum(len(j.nodes) for j in self.running.values())
        total = len([n for n in self.cluster.nodes.values() if n.state == NodeState.HEALTHY]) or 1
        return busy / total
