"""Storage-tier models: the paper's three-tier AI storage architecture.

Paper §III.E/IV.E — Isambard-AI provisions *heterogeneous* storage because AI
I/O differs from HPC simulation I/O:

* ``lustre`` — all-flash ClusterStor E1000: 20.3 PiB, up to 1,980 GB/s write /
  2,500 GB/s read aggregate, 35 M read IOPS (training datasets + checkpoints)
* ``vast``   — VAST SDS: 3.56 PB native, multi-protocol QoS tier (inference
  model serving, sensitive multi-tenant data; read-optimized, dedup 1.6:1)
* ``local``  — 3.84 TB node-local NVMe (scratch, small/sensitive payloads)

plus DMF-style movers to ``tape`` and ``cloud`` object storage.  The tier
objects model transfer times + capacity so the checkpoint manager and the
scheduler can reason about checkpoint cadence cost (flex-start guarantee) —
and tests can assert e.g. that a 480 B-param checkpoint on Lustre stays
inside the paper's write envelope.

A copy of the JAX package's ``checkpoint/storage.py`` (it holds no JAX).
These are the facility's tiers, from the paper; a save on the card's host
writes to its local disk, which is none of them.
"""

from __future__ import annotations

from dataclasses import dataclass, field


@dataclass(frozen=True)
class StorageTier:
    name: str
    write_bw: float  # aggregate bytes/s
    read_bw: float
    write_iops: float
    read_iops: float
    capacity: float  # bytes
    scope: str  # "global" | "node"
    data_reduction: float = 1.0  # VAST similarity dedup (logical/physical)

    def write_seconds(self, nbytes: float, files: int = 1) -> float:
        return nbytes / self.data_reduction / self.write_bw + files / self.write_iops

    def read_seconds(self, nbytes: float, files: int = 1) -> float:
        return nbytes / self.data_reduction / self.read_bw + files / self.read_iops


TIB = 1024**4
PIB = 1024**5

TIERS: dict[str, StorageTier] = {
    "lustre": StorageTier(
        name="lustre",
        write_bw=1_980e9,
        read_bw=2_500e9,
        write_iops=3.7e6,
        read_iops=35e6,
        capacity=20.3 * PIB,
        scope="global",
    ),
    "vast": StorageTier(
        name="vast",
        write_bw=80e9,  # C-node bound; read-optimized tier
        read_bw=400e9,
        write_iops=1e6,
        read_iops=10e6,
        capacity=3.56e15,
        data_reduction=1.6,
        scope="global",
    ),
    "local": StorageTier(
        name="local",
        write_bw=3.0e9,  # per-node NVMe
        read_bw=6.0e9,
        write_iops=500e3,
        read_iops=1e6,
        capacity=3.84e12,
        scope="node",
    ),
    "tape": StorageTier(
        name="tape",
        write_bw=1.2e9,
        read_bw=1.2e9,
        write_iops=10,
        read_iops=10,
        capacity=500 * PIB,
        scope="archive",
    ),
    "cloud": StorageTier(
        name="cloud",
        write_bw=10e9,
        read_bw=10e9,
        write_iops=3e3,
        read_iops=3e3,
        capacity=float("inf"),
        scope="archive",
    ),
}

# QoS-class -> default checkpoint tier (paper: training writes to Lustre at
# full bandwidth; inference reads models from the VAST QoS tier; scratch on
# node-local NVMe)
QOS_TIER = {
    "training": "lustre",
    "fine_tuning": "vast",
    "experimentation": "local",
    "inference": "vast",
}


@dataclass
class DataMover:
    """DMF-style policy-driven data motion between tiers (paper §IV.E)."""

    log: list = field(default_factory=list)

    def move_seconds(self, nbytes: float, src: str, dst: str, files: int = 1) -> float:
        s, d = TIERS[src], TIERS[dst]
        t = max(s.read_seconds(nbytes, files), d.write_seconds(nbytes, files))
        self.log.append({"bytes": nbytes, "src": src, "dst": dst, "seconds": t})
        return t

    def archive_policy(self, age_days: float, accessed_days: float) -> str | None:
        """HSM policy: cold data tiers down (lustre -> vast -> tape)."""
        if accessed_days > 180:
            return "tape"
        if accessed_days > 30:
            return "vast"
        return None
