"""Straggler detection & mitigation from step-time telemetry.

At 1,000+ nodes, tail latency from a single slow blade gates every
synchronous collective (the paper's tightly-coupled fabric makes the whole
step wait).  The detector keeps per-node EWMA step times, flags nodes whose
EWMA exceeds the healthy median by a configurable factor, and recommends the
standard mitigation ladder: (1) observe, (2) drain+replace at the next
checkpoint boundary, (3) hard-evict (triggering flex-restart).

A copy of the JAX package's ``core/straggler.py`` (it holds no JAX).
"""

from __future__ import annotations

from dataclasses import dataclass, field


@dataclass
class StragglerDetector:
    alpha: float = 0.3  # EWMA coefficient
    slow_factor: float = 1.5  # flag if ewma > factor * median
    evict_factor: float = 3.0  # hard-evict threshold
    min_samples: int = 3
    ewma: dict[int, float] = field(default_factory=dict)
    samples: dict[int, int] = field(default_factory=dict)

    def observe(self, node_id: int, step_time: float) -> None:
        prev = self.ewma.get(node_id)
        self.ewma[node_id] = step_time if prev is None else (1 - self.alpha) * prev + self.alpha * step_time
        self.samples[node_id] = self.samples.get(node_id, 0) + 1

    def _median(self) -> float:
        vals = sorted(v for k, v in self.ewma.items() if self.samples.get(k, 0) >= self.min_samples)
        if not vals:
            return 0.0
        return vals[len(vals) // 2]

    def stragglers(self) -> dict[int, str]:
        """node_id -> recommended action ("drain" | "evict")."""
        med = self._median()
        if med <= 0:
            return {}
        out = {}
        for nid, v in self.ewma.items():
            if self.samples.get(nid, 0) < self.min_samples:
                continue
            if v > self.evict_factor * med:
                out[nid] = "evict"
            elif v > self.slow_factor * med:
                out[nid] = "drain"
        return out

    def step_slowdown(self) -> float:
        """Synchronous-step slowdown = max(ewma)/median (1.0 = no straggler)."""
        med = self._median()
        if med <= 0:
            return 1.0
        worst = max(
            (v for k, v in self.ewma.items() if self.samples.get(k, 0) >= self.min_samples),
            default=med,
        )
        return worst / med
