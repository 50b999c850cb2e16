"""DCIM-style sustainability telemetry: energy, PUE, scope-2 emissions.

Paper §IV.A: the MDC integrates a DCIM that correlates facility data (power,
cooling) with IT-side provisioning; the facility targets PUE < 1.1 with
free-air cooling >95% of operations, ~90% of lifecycle emissions scope-2, a
5 MW envelope.  This module reproduces that accounting for one NVIDIA H100
card: per-job energy integrates card-seconds x board power from a
utilization, facility overhead applies the PUE model, and the report
mirrors the paper's sustainability tables.  A copy of the JAX package's
``core/telemetry.py`` with the card's power in place of the TPU's.

Board power is linear in utilization between the card's idle draw and its
power limit.  ``CHIP_PEAK_W`` is the limit ``nvidia-smi --query-gpu=
name,power.limit --format=csv,noheader`` reads on an NVIDIA H100 80GB HBM3
(700 W); ``CHIP_IDLE_W`` the ``power.draw`` that ``nvidia-smi`` reads on the
same card with no process on it (``chip_smoke.py``'s ``card`` line reads it
again on every run).  Nothing on that machine reads host
power, so ``HOST_OVERHEAD_W`` is 0: the joules charged are the card's
alone, not the node's.  The PUE and grid constants are the facility's,
from the paper, as in the JAX package.
"""

from __future__ import annotations

from dataclasses import dataclass, field

CHIP_PEAK_W = 700.0  # NVIDIA H100 80GB HBM3: power.limit
CHIP_IDLE_W = 72.9  # the same card idle: power.draw, median of 20 readings (72.8-73.0 W)
HOST_OVERHEAD_W = 0.0  # not measured on the card's host: left out
PUE_FREE_COOLING = 1.08  # paper: < 1.1 in free-cooling operation
PUE_CHILLER = 1.25  # the ~2% of hours chillers engage
FREE_COOLING_FRACTION = 0.98  # paper §IV.D: chillers unneeded ~98% of ops
GRID_KGCO2_PER_KWH = 0.207  # UK grid intensity (2023 avg), scope 2
CHIPS_PER_NODE = 4  # Isambard-AI: four GH200 superchips per node


def effective_pue() -> float:
    return FREE_COOLING_FRACTION * PUE_FREE_COOLING + (1 - FREE_COOLING_FRACTION) * PUE_CHILLER


def chip_power(utilization: float) -> float:
    """Linear activity model between idle and peak board power."""
    u = min(max(utilization, 0.0), 1.0)
    return CHIP_IDLE_W + u * (CHIP_PEAK_W - CHIP_IDLE_W)


@dataclass
class EnergyLedger:
    """Accumulates per-job and facility energy like a DCIM historian."""

    job_joules: dict[str, float] = field(default_factory=dict)
    job_chipseconds: dict[str, float] = field(default_factory=dict)
    facility_joules: float = 0.0

    def record(self, job_id: str, *, chips: int, seconds: float, utilization: float) -> float:
        """Integrate one interval; returns IT-side joules charged to the job."""
        nodes = -(-chips // CHIPS_PER_NODE)
        it_watts = chips * chip_power(utilization) + nodes * HOST_OVERHEAD_W
        joules = it_watts * seconds
        self.job_joules[job_id] = self.job_joules.get(job_id, 0.0) + joules
        self.job_chipseconds[job_id] = self.job_chipseconds.get(job_id, 0.0) + chips * seconds
        self.facility_joules += joules * effective_pue()
        return joules

    # ------------------------------------------------------------------
    def job_kwh(self, job_id: str) -> float:
        return self.job_joules.get(job_id, 0.0) / 3.6e6

    def facility_kwh(self) -> float:
        return self.facility_joules / 3.6e6

    def scope2_kgco2(self) -> float:
        return self.facility_kwh() * GRID_KGCO2_PER_KWH

    def report(self) -> dict:
        it_kwh = sum(self.job_joules.values()) / 3.6e6
        fac = self.facility_kwh()
        return {
            "it_kwh": round(it_kwh, 3),
            "facility_kwh": round(fac, 3),
            "effective_pue": round(effective_pue(), 4),
            "scope2_kgco2": round(self.scope2_kgco2(), 3),
            "jobs": {k: round(v / 3.6e6, 4) for k, v in self.job_joules.items()},
        }


def train_step_utilization(roofline_terms: dict) -> float:
    """Map roofline terms to a utilization proxy: compute share of the
    bottleneck time (what fraction of the step the card computes)."""
    bound = max(roofline_terms.values())
    return 0.0 if bound <= 0 else roofline_terms["compute_s"] / bound


def mw_check(chips: int, utilization: float = 1.0) -> float:
    """Facility MW at the given utilization (paper: 5 MW envelope)."""
    nodes = -(-chips // CHIPS_PER_NODE)
    watts = (chips * chip_power(utilization) + nodes * HOST_OVERHEAD_W) * effective_pue()
    return watts / 1e6
