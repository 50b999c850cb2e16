"""One serving replica: an ``InferenceEngine`` plus health/fault state.

A replica is the router's unit of capacity and of failure, mirroring one
Grace-Hopper node of the paper's 1,362.  Every replica's engine lives on
the one card: replicas share the weights (one params dict, kept by
reference), each holds its own K/V pools and, with ``fused=True``, its own
CUDA graphs and their memory pool.  One engine may span several ranks
(``InferenceEngine(mesh=)``); replicas of such engines each own their
ranks (``launch.mesh.make_replica_meshes``), and a replica led from
another process than the router's is a ``serving.remote.RemoteEngine``.
The wrapper owns exactly the
state the JAX package's cluster model (``core/cluster.py`` there) keeps per
node, translated to serving:

* a **heartbeat timestamp**, refreshed after every successfully executed
  step; the router's sweep turns heartbeat age into SUSPECT (routed around)
  or UNHEALTHY (failed over) exactly like ``Cluster.sweep_heartbeats``
  turns it into SUSPECT/FAILED;
* a **lifecycle state** — HEALTHY → SUSPECT ⇄ HEALTHY, DRAINING (admission
  stopped, work finishing or migrating), UNHEALTHY/DEAD (failed over),
  RETIRED (drained clean and removed from rotation);
* a **fault plan** (``serving.faults.FaultPlan``) evaluated on the
  replica's own step counter, so chaos runs replay deterministically.

``step()`` is the only execution entry: a crash step raises
``ReplicaCrashed`` *before* touching the engine (no partial-step tokens —
the router's committed-token failover accounting stays exact), a hang step
does nothing and skips the heartbeat, and a slow window heartbeats only
every ``slow_every``-th step so the router sees a straggler, not a corpse.

The kernels' launch counters (``kernels.paged_attention.LAUNCHES``) are
process-wide, so ``launches`` keeps this replica's share: the counters'
growth over each of its steps (eager calls; a fused engine's graph replays
count in its ``stats()["graph_launches"]``), read in the process that
steps the engine (``engine.launch_counts()``: a ``RemoteEngine``'s are its lead's).
A copy of the JAX package's ``serving/replica.py`` but for that counter.
"""

from __future__ import annotations

import time
from enum import Enum
from typing import Callable, Optional

from repro_torch.kernels import paged_attention
from repro_torch.serving.engine import InferenceEngine
from repro_torch.serving.faults import FaultPlan, ReplicaCrashed


class ReplicaState(Enum):
    HEALTHY = "healthy"
    SUSPECT = "suspect"  # heartbeat stale: routed around, not failed over
    DRAINING = "draining"  # admission stopped; finishing or migrating work
    UNHEALTHY = "unhealthy"  # heartbeat dead: failed over
    DEAD = "dead"  # crashed: failed over
    RETIRED = "retired"  # drained clean and removed from rotation


#: states a replica can still execute steps in
LIVE_STATES = (ReplicaState.HEALTHY, ReplicaState.SUSPECT, ReplicaState.DRAINING)


class Replica:
    """One engine behind the router, with heartbeat + fault bookkeeping."""

    def __init__(
        self,
        replica_id: int,
        engine: InferenceEngine,
        *,
        clock: Optional[Callable[[], float]] = None,
        fault_plan: Optional[FaultPlan] = None,
    ):
        if replica_id < 0:
            raise ValueError(f"replica_id={replica_id} (need >= 0)")
        self.id = replica_id
        self.engine = engine
        self.fault = fault_plan if fault_plan is not None else FaultPlan()
        self._clock = clock if clock is not None else time.monotonic
        self.state = ReplicaState.HEALTHY
        self.steps = 0
        self.last_heartbeat = self._clock()
        self.failovers_in = 0  # requests adopted from failed peers
        self.launches = {name: 0 for name in paged_attention.LAUNCHES}  # eager kernel launches of its steps

    # -- routing predicates --------------------------------------------
    @property
    def alive(self) -> bool:
        """Can still execute steps (healthy, suspect or draining)."""
        return self.state in LIVE_STATES

    @property
    def admittable(self) -> bool:
        """Can accept new or failed-over requests.  SUSPECT stays
        admittable as a last resort — the router prefers HEALTHY peers but
        a straggler beats a 503."""
        return self.state in (ReplicaState.HEALTHY, ReplicaState.SUSPECT)

    def heartbeat_age(self, now: float) -> float:
        return now - self.last_heartbeat

    @property
    def load(self) -> int:
        """Queued + slotted requests — the router's load-balance score."""
        eng = self.engine
        return len(eng.queue) + sum(r is not None for r in eng.slots)

    # -- execution ------------------------------------------------------
    def step(self) -> int:
        """Run one engine step under the fault plan; returns tokens
        produced.  Raises ``ReplicaCrashed`` on a crash step (state moves
        to DEAD first, so the raise is observable but the replica is
        already out of rotation)."""
        k = self.steps
        self.steps += 1
        if self.fault.crashes_at(k):
            self.state = ReplicaState.DEAD
            raise ReplicaCrashed(f"replica {self.id} crashed at step {k} (injected)")
        if self.fault.hangs_at(k):
            return 0  # wedged: no work, no heartbeat — the sweep notices
        before = self.engine.launch_counts()
        produced = self.engine.step()
        for name, n in self.engine.launch_counts().items():
            self.launches[name] += n - before[name]
        if not self.fault.slow_at(k) or k % self.fault.slow_every == 0:
            self.last_heartbeat = self._clock()
        return produced

    def __repr__(self) -> str:
        return (
            f"Replica(id={self.id}, state={self.state.value}, "
            f"steps={self.steps}, load={self.load})"
        )
