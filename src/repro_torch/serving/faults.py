"""Deterministic fault injection for multi-replica serving.

Isambard-AI fields 1,362 Grace-Hopper nodes; at that scale node failure is
the baseline operating condition, not an anomaly, so the serving stack's
failure handling must be *testable* — a fault that only reproduces on real
flaky hardware cannot gate CI.  This module gives each ``serving.replica``
a ``FaultPlan``: a frozen schedule keyed on the replica's **own step
counter**, so a chaos run replays bit-identically (the router benchmark's
mid-run kill arm asserts token-identical failover against a no-fault run).

Three fault shapes, mirroring the JAX package's cluster model
(``core/cluster.py`` there drives HEALTHY → SUSPECT → FAILED off heartbeat
age; ``core/fault.py`` replays crashes at fixed steps):

* **crash** — from ``crash_at_step`` on, ``Replica.step`` raises
  ``ReplicaCrashed`` *instead of* executing the step: no partial-step
  tokens are ever emitted, so failover's committed-token accounting is
  exact.  Models a process/node loss.
* **hang** — from ``hang_from_step`` on, steps do nothing and stop
  heartbeating; the router's missed-deadline sweep detects the silence
  (SUSPECT after ``suspect_after``, UNHEALTHY + failover after
  ``fail_after``).  Models a wedged process the OS never reaps.
* **slow** — inside ``[slow_from_step, slow_until_step)`` the replica does
  full work but heartbeats only every ``slow_every``-th step, so its
  heartbeat age oscillates into SUSPECT territory: the router routes new
  requests around it without failing over in-flight ones.  Models a
  straggler (thermal throttle, noisy neighbour).

``ReplicaCrashed`` and ``ServiceUnavailable`` are the shared error
vocabulary: the router raises ``ServiceUnavailable`` when no replica is
admittable (degraded mode), ``AsyncEngine`` raises it while draining, and
the HTTP front-end maps it to a 503.  A copy of the JAX package's
``serving/faults.py``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional


class ReplicaCrashed(RuntimeError):
    """An injected (or real) replica loss: the engine behind it is gone."""


class ServiceUnavailable(RuntimeError):
    """No replica can accept work (degraded mode / draining) — HTTP 503."""


@dataclass(frozen=True)
class FaultPlan:
    """Deterministic per-replica fault schedule (steps are the replica's
    own counter, starting at 0)."""

    crash_at_step: Optional[int] = None  # raise instead of executing step >= this
    hang_from_step: Optional[int] = None  # no work, no heartbeat from this step on
    slow_from_step: Optional[int] = None  # straggle window start ...
    slow_until_step: Optional[int] = None  # ... and end (None = forever)
    slow_every: int = 4  # while slow, heartbeat every k-th step only

    def __post_init__(self):
        if self.slow_every < 1:
            raise ValueError(f"slow_every={self.slow_every} (need >= 1)")

    def crashes_at(self, step: int) -> bool:
        return self.crash_at_step is not None and step >= self.crash_at_step

    def hangs_at(self, step: int) -> bool:
        return self.hang_from_step is not None and step >= self.hang_from_step

    def slow_at(self, step: int) -> bool:
        if self.slow_from_step is None or step < self.slow_from_step:
            return False
        return self.slow_until_step is None or step < self.slow_until_step

    @property
    def benign(self) -> bool:
        """True when this plan injects nothing (the default plan)."""
        return (
            self.crash_at_step is None
            and self.hang_from_step is None
            and self.slow_from_step is None
        )
