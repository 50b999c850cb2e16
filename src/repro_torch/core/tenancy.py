"""TAPMS-style multi-tenancy: tenant partitions over the device grid.

Paper §IV.F: CSM's Tenant and Partition Management System (TAPMS) assigns
*bare-metal nodes* to tenants; tenant admins get a "repurposed compute node"
(rCN) as their login/JupyterHub frontend.  A tenant owns a share of the
chips; ``tenant_submesh_shape`` gives its (data, model) shape.

``TenantManager`` enforces: capacity quotas, node exclusivity, rCN
assignment, and RBAC via ``core.federation`` (tenant-admin vs infra-admin
personas, limited-duration tokens).

A copy of the JAX package's ``core/tenancy.py``.  ``make_tenant_mesh``
carves a ``jax.sharding.Mesh`` out of ``jax.devices()`` there; here it
carves a ``(data, model)`` device mesh out of the ranks of the initialized
``torch.distributed`` world (``launch.mesh.make_submesh``), the mesh a
tenant's sharded training runs on.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

from repro_torch.core.cluster import CHIPS_PER_NODE, Cluster
from repro_torch.core.federation import IAM, Role


@dataclass
class Tenant:
    name: str
    quota_nodes: int
    nodes: list[int] = field(default_factory=list)
    rcn: Optional[int] = None  # repurposed compute node (login frontend)
    admins: list[str] = field(default_factory=list)

    @property
    def chips(self) -> int:
        return len(self.nodes) * CHIPS_PER_NODE


class TenantManager:
    def __init__(self, cluster: Cluster, iam: IAM | None = None):
        self.cluster = cluster
        self.iam = iam or IAM()
        self.tenants: dict[str, Tenant] = {}

    # ------------------------------------------------------------------
    def create_tenant(self, name: str, quota_nodes: int, admin: str, *, token: str) -> Tenant:
        self.iam.require(token, Role.INFRA_ADMIN)
        if name in self.tenants:
            raise ValueError(f"tenant {name!r} exists")
        t = Tenant(name=name, quota_nodes=quota_nodes, admins=[admin])
        self.tenants[name] = t
        self.iam.grant(admin, Role.TENANT_ADMIN, scope=name)
        return t

    def grow_tenant(self, name: str, n_nodes: int, *, token: str) -> Tenant:
        """Assign n_nodes free healthy nodes to the tenant (pod-local first)."""
        t = self.tenants[name]
        self.iam.require(token, Role.INFRA_ADMIN)
        if len(t.nodes) + n_nodes > t.quota_nodes:
            raise PermissionError(f"tenant {name!r} quota exceeded")
        free = [n for n in self.cluster.free_nodes() if n.tenant is None]
        free.sort(key=lambda n: n.pod)
        if len(free) < n_nodes:
            raise RuntimeError("insufficient free nodes")
        for n in free[:n_nodes]:
            n.tenant = name
            t.nodes.append(n.node_id)
        if t.rcn is None and t.nodes:
            # first node becomes the tenant's login frontend (rCN)
            t.rcn = t.nodes[0]
        return t

    def shrink_tenant(self, name: str, n_nodes: int, *, token: str) -> Tenant:
        t = self.tenants[name]
        self.iam.require(token, Role.INFRA_ADMIN)
        removable = [nid for nid in t.nodes if self.cluster.nodes[nid].job is None and nid != t.rcn]
        if len(removable) < n_nodes:
            raise RuntimeError("nodes busy; drain jobs first")
        for nid in removable[:n_nodes]:
            t.nodes.remove(nid)
            self.cluster.nodes[nid].tenant = None
        return t

    # ------------------------------------------------------------------
    def tenant_submesh_shape(self, name: str, model_parallel: int = 1) -> tuple[int, int]:
        """(data, model) sub-mesh shape over the tenant's chips."""
        t = self.tenants[name]
        chips = t.chips
        if chips % model_parallel != 0:
            raise ValueError(f"{chips} chips not divisible by model={model_parallel}")
        return (chips // model_parallel, model_parallel)

    def make_tenant_mesh(self, name: str, model_parallel: int = 1):
        """A ``(data, model)`` mesh over the tenant's share of the world's
        ranks.

        As the JAX package carves the tenant's proportional slice of
        ``jax.devices()``: the world's ranks times the tenant's share of
        the nodes, rounded down to a multiple of ``model_parallel`` (at
        least one group), the first ranks of the world reshaped to
        ``(share // model_parallel, model_parallel)``.  Every rank of the
        world calls it (a device mesh makes its groups collectively); a
        rank outside the share gets None.  A world with fewer ranks than
        one model group raises ``ValueError``, where the JAX package's
        reshape fails."""
        import torch.distributed as dist

        from repro_torch.launch.mesh import make_submesh

        t = self.tenants[name]
        if not dist.is_initialized():
            raise RuntimeError("no process group: a tenant mesh spans the ranks of an initialized world")
        total_nodes = len(self.cluster.nodes)
        world = dist.get_world_size()
        share = max(1, world * len(t.nodes) // max(total_nodes, 1))
        share = (share // model_parallel) * model_parallel or model_parallel
        if share > world:
            raise ValueError(f"tenant {name!r}: model_parallel={model_parallel} needs {share} ranks, the world has {world}")
        return make_submesh(share // model_parallel, model_parallel)

    # ------------------------------------------------------------------
    def check_isolation(self) -> list[str]:
        """Invariant: no node is owned by two tenants / no job crosses
        tenant boundaries. Returns violations (tests assert empty)."""
        owner: dict[int, str] = {}
        bad = []
        for t in self.tenants.values():
            for nid in t.nodes:
                if nid in owner:
                    bad.append(f"node {nid} in tenants {owner[nid]} and {t.name}")
                owner[nid] = t.name
        for n in self.cluster.nodes.values():
            if n.job is not None and n.tenant is not None:
                jt = [x for x in self.cluster.job_nodes(n.job) if x.tenant != n.tenant]
                bad.extend(f"job {n.job} crosses tenants via node {x.node_id}" for x in jt)
        return bad
