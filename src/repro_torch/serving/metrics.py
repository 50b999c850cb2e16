"""Serving metrics: a dependency-free registry of counters, gauges and
fixed-bucket latency histograms.

The paper operates Isambard-AI like a cloud AI service — Jupyter/MLOps
front-ends under continuous load with a DCIM correlating facility power and
IT-side activity (§IV.A).  Peer systems treat service-level monitoring as
baseline infrastructure; this module is that substrate for the paged
serving engine: every latency-shaped quantity (queue wait, TTFT, TPOT,
per-step and per-chunk latency) lands in a histogram whose percentiles the
benchmarks and the async/SLO roadmap items assert against, and every
throughput-shaped quantity (tokens, admissions, prefix hits, speculative
acceptance, evictions) lands in a counter.

Design constraints, in order:

* **Dependency-free and host-only** — plain Python ints/floats, no
  prometheus_client, no numpy on the hot path.  An ``observe()`` is one
  ``bisect`` plus four scalar updates, so the engine can publish from every
  step without perturbing what it measures.
* **Injectable clock** — every engine timestamp routes through one
  ``clock()`` callable (default ``time.monotonic``).  ``ManualClock`` lets
  tests pin the clock and assert *exact* latencies instead of sleeping.
* **Two exports** — ``render_text()`` emits the Prometheus text exposition
  format (scrape-ready, ``le``-labelled cumulative buckets) and
  ``snapshot()`` emits a JSON-serializable dict with p50/p90/p99 already
  derived (what ``--metrics-json`` and the benchmark JSON consume).

Histogram percentiles interpolate linearly inside the owning bucket (the
``histogram_quantile`` rule) and clamp to the observed min/max, so the
error is bounded by one bucket's width — the default buckets are a
factor-of-2 geometric ladder over 10 µs … ~84 s, tested against a numpy
oracle in ``tests/test_metrics.py``.  (This is a copy of the JAX package's
``serving/metrics.py`` without its ``EnergyBridge``, whose power model is
the TPU's.)
"""

from __future__ import annotations

import json
import math
from bisect import bisect_left
from typing import Iterable, Optional, Sequence



class ManualClock:
    """Deterministic monotonic clock for tests.

    ``tick`` > 0 advances the clock by that much on every read (strictly
    increasing timestamps without wall time); ``advance`` jumps it
    explicitly.  Passing an instance as the engine's ``clock=`` makes every
    recorded latency an exact, assertable number.
    """

    def __init__(self, start: float = 0.0, tick: float = 0.0):
        self._t = float(start)
        self.tick = float(tick)

    def __call__(self) -> float:
        t = self._t
        self._t += self.tick
        return t

    @property
    def now(self) -> float:
        return self._t

    def advance(self, dt: float) -> None:
        if dt < 0:
            raise ValueError(f"clock must be monotonic: advance({dt})")
        self._t += dt


def exponential_buckets(start: float, factor: float, count: int) -> list[float]:
    """``count`` geometric bucket upper bounds: start, start*factor, ..."""
    if start <= 0 or factor <= 1 or count < 1:
        raise ValueError(f"exponential_buckets({start}, {factor}, {count})")
    return [start * factor**i for i in range(count)]


# 10 us .. ~84 s at x2 resolution: covers a single jitted dispatch on real
# hardware up to a CPU-smoke drained run, with <= 2x percentile error
DEFAULT_TIME_BUCKETS = exponential_buckets(1e-5, 2.0, 24)


def _fmt(v: float) -> str:
    return format(float(v), ".10g")


class Counter:
    """Monotonically increasing float counter."""

    kind = "counter"

    def __init__(self, name: str, help: str = ""):
        self.name = name
        self.help = help
        self.value = 0.0

    def inc(self, v: float = 1.0) -> None:
        if v < 0:
            raise ValueError(f"counter {self.name} can only increase (inc({v}))")
        self.value += v

    def render(self) -> list[str]:
        return [f"{self.name} {_fmt(self.value)}"]

    def snapshot(self) -> dict:
        return {"value": self.value}


class Gauge:
    """Instantaneous value (set, not accumulated)."""

    kind = "gauge"

    def __init__(self, name: str, help: str = ""):
        self.name = name
        self.help = help
        self.value = 0.0

    def set(self, v: float) -> None:
        self.value = float(v)

    def render(self) -> list[str]:
        return [f"{self.name} {_fmt(self.value)}"]

    def snapshot(self) -> dict:
        return {"value": self.value}


class Histogram:
    """Fixed-bucket histogram with Prometheus semantics.

    ``bounds`` are ascending finite upper bounds; an implicit +Inf bucket
    catches overflow.  ``percentile`` interpolates linearly inside the
    owning bucket and clamps to the observed [min, max], so the returned
    value is within one bucket width of the true order statistic.
    """

    kind = "histogram"

    def __init__(self, name: str, help: str = "", buckets: Optional[Sequence[float]] = None):
        self.name = name
        self.help = help
        self.bounds = [float(b) for b in (buckets if buckets is not None else DEFAULT_TIME_BUCKETS)]
        if self.bounds != sorted(self.bounds) or len(set(self.bounds)) != len(self.bounds):
            raise ValueError(f"histogram {name}: buckets must be strictly ascending")
        self.counts = [0] * (len(self.bounds) + 1)  # [-1] = overflow (+Inf)
        self.count = 0
        self.sum = 0.0
        self.min = math.inf
        self.max = -math.inf

    def observe(self, v: float) -> None:
        v = float(v)
        self.counts[bisect_left(self.bounds, v)] += 1
        self.count += 1
        self.sum += v
        self.min = min(self.min, v)
        self.max = max(self.max, v)

    def percentile(self, pct: float) -> Optional[float]:
        """The pct-th percentile (0 < pct <= 100), or None when empty."""
        if self.count == 0:
            return None
        if not 0 < pct <= 100:
            raise ValueError(f"percentile({pct})")
        rank = pct / 100.0 * self.count
        cum = 0
        for i, c in enumerate(self.counts):
            if cum + c >= rank and c > 0:
                if i == len(self.bounds):  # overflow bucket: no upper edge
                    return self.max
                lo = self.bounds[i - 1] if i > 0 else 0.0
                hi = self.bounds[i]
                val = lo + (rank - cum) / c * (hi - lo)
                return min(max(val, self.min), self.max)
            cum += c
        return self.max  # unreachable: cum == count by the last bucket

    @property
    def mean(self) -> Optional[float]:
        return self.sum / self.count if self.count else None

    def render(self) -> list[str]:
        lines = []
        cum = 0
        for b, c in zip(self.bounds, self.counts):
            cum += c
            lines.append(f'{self.name}_bucket{{le="{_fmt(b)}"}} {cum}')
        lines.append(f'{self.name}_bucket{{le="+Inf"}} {self.count}')
        lines.append(f"{self.name}_sum {_fmt(self.sum)}")
        lines.append(f"{self.name}_count {self.count}")
        return lines

    def snapshot(self) -> dict:
        cum, buckets = 0, []
        for b, c in zip(self.bounds, self.counts):
            cum += c
            buckets.append({"le": b, "count": cum})
        buckets.append({"le": "+Inf", "count": self.count})
        return {
            "count": self.count,
            "sum": self.sum,
            "min": self.min if self.count else None,
            "max": self.max if self.count else None,
            "mean": self.mean,
            "p50": self.percentile(50),
            "p90": self.percentile(90),
            "p99": self.percentile(99),
            "buckets": buckets,
        }


class MetricsRegistry:
    """Named instruments, get-or-create; one registry per engine.

    Registration is idempotent — asking for an existing name returns the
    existing instrument (help text of the first registration wins), so the
    engine, allocator, prefix index and drafters can all publish into one
    registry without coordination.  Asking for an existing name as a
    *different* kind raises.
    """

    def __init__(self):
        self._metrics: dict[str, Counter | Gauge | Histogram] = {}

    def _get_or_create(self, cls, name: str, help: str, **kw):
        m = self._metrics.get(name)
        if m is None:
            m = self._metrics[name] = cls(name, help, **kw)
        elif not isinstance(m, cls):
            raise ValueError(f"metric {name!r} is a {m.kind}, not a {cls.kind}")
        return m

    def counter(self, name: str, help: str = "") -> Counter:
        return self._get_or_create(Counter, name, help)

    def gauge(self, name: str, help: str = "") -> Gauge:
        return self._get_or_create(Gauge, name, help)

    def histogram(
        self, name: str, help: str = "", buckets: Optional[Sequence[float]] = None
    ) -> Histogram:
        return self._get_or_create(Histogram, name, help, buckets=buckets)

    def get(self, name: str):
        return self._metrics.get(name)

    def __contains__(self, name: str) -> bool:
        return name in self._metrics

    def names(self) -> list[str]:
        return list(self._metrics)

    def percentiles(self, name: str, pcts: Iterable[float] = (50, 90, 99)) -> dict:
        """p-th percentiles of a histogram; all-None when absent/empty."""
        h = self._metrics.get(name)
        if not isinstance(h, Histogram):
            return {p: None for p in pcts}
        return {p: h.percentile(p) for p in pcts}

    def render_text(self, prefix: str = "") -> str:
        """Prometheus text exposition (scrape-ready).

        ``prefix`` prepends every metric name — the multi-replica router
        renders each replica engine's registry as ``replica<N>_...`` so one
        ``/metrics`` scrape carries the whole fleet without name collisions.
        """
        lines = []
        for name, m in self._metrics.items():
            pname = prefix + name
            if m.help:
                lines.append(f"# HELP {pname} {m.help}")
            lines.append(f"# TYPE {pname} {m.kind}")
            lines.extend(
                prefix + ln if prefix else ln for ln in m.render()
            )
        return "\n".join(lines) + ("\n" if lines else "")

    def snapshot(self) -> dict:
        """JSON-serializable view grouped by kind, percentiles derived."""
        out: dict = {"counters": {}, "gauges": {}, "histograms": {}}
        for name, m in self._metrics.items():
            out[m.kind + "s"][name] = m.snapshot()
        return out

    def write_json(self, path) -> None:
        with open(path, "w") as f:
            json.dump(self.snapshot(), f, indent=1)
