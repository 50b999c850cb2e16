"""Fault-tolerant training runner: heartbeats -> detection -> restore -> resume.

This is the executable version of the paper's "Flex Start with guaranteed
completion": a REAL training loop (CPU-executed on reduced configs in tests)
wrapped with the failure machinery a 1,320-node system needs:

* per-node heartbeats into ``core.cluster``; missed beats -> suspect -> failed
* hard failure injection (chaos schedule) at arbitrary steps
* on failure: roll back to the newest checkpoint, replay deterministically
  (the data pipeline is step-keyed, so recovery is *bit-exact* — asserted in
  tests/test_fault_tolerance.py)
* optional elastic recovery: shrink to the surviving nodes at a checkpoint
  boundary instead of waiting for a replacement (core.elastic)
* straggler observations feed ``core.straggler`` and can drain slow nodes.

The JAX package's ``core/fault.py`` on the port's train step.  Neither
runner calls ``core.elastic`` itself (in neither package): a caller
shrinks a sharded job with ``plan_resize``, ``make_elastic_mesh`` and
``reshard_state``.  One timing differs: a
step's ``wall`` is taken after ``float(loss)`` has brought the loss to the
host, where the reference takes it before.  Under JAX the reference's
reading is the dispatch time; in eager PyTorch a host clock before the
sync reads neither dispatch nor device time.  After the sync it reads the
step's real time, which the energy ledger and the straggler detector
integrate.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Callable, Optional

from repro_torch.checkpoint import CheckpointManager
from repro_torch.core.cluster import Cluster, NodeState
from repro_torch.core.straggler import StragglerDetector
from repro_torch.core.telemetry import EnergyLedger


@dataclass
class RunReport:
    steps_run: int = 0
    failures: int = 0
    restores: int = 0
    rollback_steps: int = 0  # work re-executed after rollbacks
    losses: dict = field(default_factory=dict)  # step -> loss
    events: list = field(default_factory=list)


class FaultTolerantRunner:
    def __init__(
        self,
        *,
        step_fn: Callable,  # (state, batch) -> (state, metrics)
        init_state,
        batch_fn: Callable,  # step -> batch (deterministic => bit-exact replay)
        cluster: Cluster,
        ckpt: CheckpointManager,
        job_id: str = "train-job",
        checkpoint_every: int = 10,
        heartbeat_timeout: tuple[float, float] = (2.0, 4.0),  # (suspect, fail)
        ledger: Optional[EnergyLedger] = None,
        straggler: Optional[StragglerDetector] = None,
    ):
        self.step_fn = step_fn
        self.state = init_state
        self.batch_fn = batch_fn
        self.cluster = cluster
        self.ckpt = ckpt
        self.job_id = job_id
        self.checkpoint_every = checkpoint_every
        self.suspect_after, self.fail_after = heartbeat_timeout
        self.ledger = ledger or EnergyLedger()
        self.straggler = straggler or StragglerDetector()
        self.report = RunReport()
        self._step = 0

    # ------------------------------------------------------------------
    def _heartbeat_all(self, now: float, dead: set[int]) -> None:
        for n in self.cluster.job_nodes(self.job_id):
            if n.node_id not in dead and n.state == NodeState.HEALTHY:
                self.cluster.heartbeat(n.node_id, now)

    def _detect_failures(self, now: float) -> list[int]:
        failed = self.cluster.sweep_heartbeats(
            now, suspect_after=self.suspect_after, fail_after=self.fail_after
        )
        return [n.node_id for n in failed if n.job == self.job_id]

    # ------------------------------------------------------------------
    def _restore(self) -> None:
        """Roll back to the newest checkpoint (or step 0 state)."""
        step = self.ckpt.latest_step()
        if step is None:
            raise RuntimeError("no checkpoint to restore from")
        self.state, extra = self.ckpt.restore(self.state, step=step)
        self.report.rollback_steps += self._step - step
        self._step = step
        self.report.restores += 1
        self.report.events.append(("restore", step))

    def _maybe_checkpoint(self) -> None:
        if self._step % self.checkpoint_every == 0 and self._step > 0:
            self.ckpt.save(self.state, step=self._step, block=True)
            self.report.events.append(("checkpoint", self._step))

    # ------------------------------------------------------------------
    def run(
        self,
        num_steps: int,
        *,
        failure_schedule: dict[int, int] | None = None,  # step -> node_id to kill
        repair_after_steps: int = 2,
        now_fn: Callable[[], float] | None = None,
    ) -> RunReport:
        """Run to ``num_steps`` TOTAL steps, surviving the failure schedule."""
        failure_schedule = dict(failure_schedule or {})
        sim_now = [0.0]

        def now() -> float:
            sim_now[0] += 1.0
            return sim_now[0]

        now_fn = now_fn or now
        dead: dict[int, int] = {}  # node -> steps until repair
        # capture the job's node set up front: a co-attached Scheduler may
        # release node->job bindings on failure events, but the runner owns
        # the training loop and re-attaches the same nodes after repair
        my_nodes = [n.node_id for n in self.cluster.job_nodes(self.job_id)]

        # initial checkpoint so any early failure has a restore point
        self.ckpt.save(self.state, step=0, block=True)

        while self._step < num_steps:
            t = now_fn()
            # chaos injection scheduled for this step
            if self._step in failure_schedule:
                nid = failure_schedule.pop(self._step)
                self.cluster.fail_node(nid)
                dead[nid] = repair_after_steps
                self.report.failures += 1
                self.report.events.append(("failure", self._step, nid))

            for nid in my_nodes:
                if nid not in dead and self.cluster.nodes[nid].state == NodeState.HEALTHY:
                    self.cluster.heartbeat(nid, t)
            lost = self._detect_failures(t)
            failed_now = [
                nid for nid in my_nodes if self.cluster.nodes[nid].state == NodeState.FAILED
            ]
            if lost or failed_now or dead:
                # wait for repair (simulated), then restore and resume
                for nid in list(dead):
                    dead[nid] -= 1
                    if dead[nid] <= 0:
                        self.cluster.repair_node(nid, t)
                        del dead[nid]
                if dead:
                    continue  # still waiting for spare capacity
                # re-attach the full node set to the job and resume
                for nid in my_nodes:
                    self.cluster.nodes[nid].job = self.job_id
                self._restore()
                continue

            t0 = time.monotonic()
            batch = self.batch_fn(self._step)
            self.state, metrics = self.step_fn(self.state, batch)
            loss = float(metrics["loss"])  # waits for the step
            wall = time.monotonic() - t0
            self._step += 1
            self.report.steps_run += 1
            self.report.losses[self._step] = loss
            for n in self.cluster.job_nodes(self.job_id):
                self.straggler.observe(n.node_id, wall)
            self.ledger.record(
                self.job_id,
                chips=sum(n.chips for n in self.cluster.job_nodes(self.job_id)),
                seconds=wall,
                utilization=0.5,
            )
            self._maybe_checkpoint()

        self.ckpt.save(self.state, step=self._step, block=True)
        return self.report
