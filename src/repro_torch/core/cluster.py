"""Cluster model: nodes, superchips, topology, health — the facility layer.

Mirrors the paper's Table I: a node is 4 superchips (4x GH200 on
Isambard-AI), nodes aggregate into pods, pods into the facility.  Phase 1 = 42 nodes / 168 chips; phase 2 =
1,320 nodes / 5,280 chips — both are presets below, and the runtime simulates
thousands of nodes without allocating anything per-chip.

The cluster is the substrate the scheduler (QoS classes), tenancy (TAPMS) and
fault-tolerance layers operate on.  Health transitions are event-driven so
tests can inject blade failures exactly like the serviceability story in
paper §IV.D (quick-connect blades, service without full-system shutdown).

A copy of the JAX package's ``core/cluster.py`` (it holds no JAX).  The
port runs one job on one card; the cluster it reasons about is simulated.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass, field
from typing import Iterable, Optional


class NodeState(enum.Enum):
    HEALTHY = "healthy"
    SUSPECT = "suspect"  # missed heartbeats, not yet evicted
    FAILED = "failed"
    DRAINING = "draining"  # administratively removed (blade service)
    REPAIRING = "repairing"


CHIPS_PER_NODE = 4  # 4 superchips per node (paper Fig. 4)


@dataclass
class Node:
    node_id: int
    pod: int
    state: NodeState = NodeState.HEALTHY
    # facility telemetry (DCIM): watts drawn, last heartbeat timestamp
    power_w: float = 0.0
    last_heartbeat: float = 0.0
    tenant: Optional[str] = None
    job: Optional[str] = None

    @property
    def chips(self) -> int:
        return CHIPS_PER_NODE


@dataclass
class ClusterSpec:
    name: str
    nodes_per_pod: int
    num_pods: int

    @property
    def total_nodes(self) -> int:
        return self.nodes_per_pod * self.num_pods

    @property
    def total_chips(self) -> int:
        return self.total_nodes * CHIPS_PER_NODE


# presets mirroring the paper + the assignment's dry-run mesh
PHASE1 = ClusterSpec("isambard-ai-phase1", nodes_per_pod=42, num_pods=1)  # 168 chips
PHASE2 = ClusterSpec("isambard-ai-phase2", nodes_per_pod=110, num_pods=12)  # 5,280 chips
DRYRUN_SINGLE = ClusterSpec("dryrun-single-pod", nodes_per_pod=64, num_pods=1)  # 256 chips
DRYRUN_MULTI = ClusterSpec("dryrun-multi-pod", nodes_per_pod=64, num_pods=2)  # 512 chips


class Cluster:
    """In-memory facility state. Time is injected (simulation-friendly)."""

    def __init__(self, spec: ClusterSpec):
        self.spec = spec
        self.nodes: dict[int, Node] = {}
        nid = 0
        for pod in range(spec.num_pods):
            for _ in range(spec.nodes_per_pod):
                self.nodes[nid] = Node(node_id=nid, pod=pod)
                nid += 1
        self._listeners = []

    # ------------------------------------------------------------------
    def on_event(self, fn) -> None:
        """fn(event: str, node: Node) — scheduler/FT layers subscribe."""
        self._listeners.append(fn)

    def _emit(self, event: str, node: Node) -> None:
        for fn in self._listeners:
            fn(event, node)

    # ------------------------------------------------------------------
    def healthy_nodes(self, pod: int | None = None) -> list[Node]:
        return [
            n
            for n in self.nodes.values()
            if n.state == NodeState.HEALTHY and (pod is None or n.pod == pod)
        ]

    def free_nodes(self, pod: int | None = None) -> list[Node]:
        return [n for n in self.healthy_nodes(pod) if n.job is None]

    def free_chips(self, pod: int | None = None) -> int:
        return sum(n.chips for n in self.free_nodes(pod))

    # ------------------------------------------------------------------
    def heartbeat(self, node_id: int, now: float) -> None:
        n = self.nodes[node_id]
        n.last_heartbeat = now
        if n.state == NodeState.SUSPECT:
            n.state = NodeState.HEALTHY
            self._emit("recovered", n)

    def sweep_heartbeats(self, now: float, *, suspect_after: float, fail_after: float) -> list[Node]:
        """Mark nodes suspect/failed by heartbeat age. Returns newly failed."""
        failed = []
        for n in self.nodes.values():
            if n.state not in (NodeState.HEALTHY, NodeState.SUSPECT):
                continue
            age = now - n.last_heartbeat
            if age >= fail_after:
                n.state = NodeState.FAILED
                failed.append(n)
                self._emit("failed", n)
            elif age >= suspect_after and n.state == NodeState.HEALTHY:
                n.state = NodeState.SUSPECT
                self._emit("suspect", n)
        return failed

    def fail_node(self, node_id: int) -> Node:
        """Hard failure injection (tests / chaos engineering)."""
        n = self.nodes[node_id]
        n.state = NodeState.FAILED
        self._emit("failed", n)
        return n

    def repair_node(self, node_id: int, now: float = 0.0) -> Node:
        n = self.nodes[node_id]
        n.state = NodeState.HEALTHY
        n.last_heartbeat = now
        n.job = None
        self._emit("repaired", n)
        return n

    def drain_node(self, node_id: int) -> Node:
        n = self.nodes[node_id]
        n.state = NodeState.DRAINING
        self._emit("draining", n)
        return n

    # ------------------------------------------------------------------
    def allocate(self, node_ids: Iterable[int], job: str, tenant: str | None = None) -> None:
        for nid in node_ids:
            n = self.nodes[nid]
            if n.state != NodeState.HEALTHY or n.job is not None:
                raise RuntimeError(f"node {nid} not allocatable (state={n.state}, job={n.job})")
            n.job = job
            if tenant is not None:
                n.tenant = tenant

    def release(self, job: str) -> list[int]:
        freed = []
        for n in self.nodes.values():
            if n.job == job:
                n.job = None
                freed.append(n.node_id)
        return freed

    def job_nodes(self, job: str) -> list[Node]:
        return [n for n in self.nodes.values() if n.job == job]
