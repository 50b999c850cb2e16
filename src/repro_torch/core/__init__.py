"""The paper's contribution: an AI-platform runtime for a leadership-class
facility — QoS scheduling, tenancy, elasticity, fault tolerance,
telemetry: the JAX package's ``core/``."""

from repro_torch.core.cluster import (
    CHIPS_PER_NODE,
    DRYRUN_MULTI,
    DRYRUN_SINGLE,
    PHASE1,
    PHASE2,
    Cluster,
    ClusterSpec,
    Node,
    NodeState,
)
from repro_torch.core.elastic import ElasticPlan, make_elastic_mesh, plan_resize, reshard_state, resize_batch
from repro_torch.core.fault import FaultTolerantRunner, RunReport
from repro_torch.core.federation import IAM, Identity, Role
from repro_torch.core.scheduler import Job, JobState, QoS, Reservation, Scheduler
from repro_torch.core.straggler import StragglerDetector
from repro_torch.core.telemetry import EnergyLedger, effective_pue, mw_check
from repro_torch.core.tenancy import Tenant, TenantManager

__all__ = [
    "CHIPS_PER_NODE",
    "Cluster",
    "ClusterSpec",
    "Node",
    "NodeState",
    "DRYRUN_MULTI",
    "DRYRUN_SINGLE",
    "PHASE1",
    "PHASE2",
    "ElasticPlan",
    "make_elastic_mesh",
    "plan_resize",
    "reshard_state",
    "resize_batch",
    "FaultTolerantRunner",
    "RunReport",
    "IAM",
    "Identity",
    "Role",
    "Job",
    "JobState",
    "QoS",
    "Reservation",
    "Scheduler",
    "StragglerDetector",
    "EnergyLedger",
    "effective_pue",
    "mw_check",
    "Tenant",
    "TenantManager",
]
