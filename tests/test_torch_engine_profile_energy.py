"""The engine's ``profile=`` and ``energy=`` on the CPU, as the JAX
package's ``tests/test_metrics.py`` holds its engine's.

``profile=False`` never reaches the ``_block_until_ready`` seam and
registers no ``engine_profile_*`` metric; ``profile=True`` fills the
per-phase histograms and each step span's ``phases`` and leaves the tokens
as they were, on both cache layouts and in the fused and speculative
walks.  Each step's joules split exactly over the requests that did work.
Against the JAX engine on the same weights and prompts, in every walk:
each step's slot occupancy (the power proxy the bridge is charged at), each
request's share of the step joules, and the set of profiled phases.  The
port's ``EnergyLedger``, given the JAX module's constants, charges the
joules of ``repro.core.telemetry.EnergyLedger``; with its own it charges
the H100's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core.telemetry as jax_telemetry
import repro_torch.core.telemetry as telemetry
from repro.config.model import reduce_for_smoke as jax_reduce
from repro.configs import get_config as jax_get_config
from repro.models import init_params as jax_init_params
from repro.serving import InferenceEngine as JaxEngine
from repro.serving.metrics import EnergyBridge as JaxEnergyBridge
from repro_torch.bridge import params_from_jax
from repro_torch.config import reduce_for_smoke
from repro_torch.configs import get_config
from repro_torch.models import init_params
from repro_torch.serving import engine as engine_mod
from repro_torch.serving import InferenceEngine
from repro_torch.serving.metrics import EnergyBridge, ManualClock

torch.set_num_threads(2)

# (cache_kind, extra engine options): the walks a profiled phase can come from
WALKS = {
    "dense": ("dense", {}),
    "paged": ("paged", dict(prefill_budget=8)),
    "fused": ("paged", dict(prefill_budget=8, fused=True)),
    "spec": ("paged", dict(spec_decode="ngram", spec_k=2)),
    "fused_spec": ("paged", dict(prefill_budget=8, fused=True, spec_decode="ngram", spec_k=2)),
}
PHASES = {"dense": {"prefill", "decode", "sample"}, "paged": {"prefill_chunk", "decode", "sample"},
          "fused": {"fused_step", "fused_decode"}, "spec": {"prefill_chunk", "verify", "sample"},
          "fused_spec": {"fused_step"}}


@pytest.fixture(scope="module")
def setup():
    cfg = reduce_for_smoke(get_config("olmo-1b"))
    return cfg, init_params(cfg, 0, device="cpu")


def _engine(setup, walk, **kw):
    cfg, params = setup
    kind, extra = WALKS[walk]
    return InferenceEngine(cfg, params, max_batch=2, max_seq=64, block_size=8, cache_kind=kind,
                           eos_token=1 << 20, device="cpu", **extra, **kw)


def _serve(eng, prompts=([5, 6, 7], [8, 9, 10, 11, 12, 13, 14, 15, 16, 17], [4, 4, 4, 4])):
    reqs = [eng.submit(list(p), max_new_tokens=5) for p in prompts]
    eng.run_until_drained()
    return reqs


@pytest.mark.parametrize("walk", list(WALKS))
def test_profiling_off_means_zero_syncs(setup, walk, monkeypatch):
    calls = {"n": 0}
    real = engine_mod._block_until_ready

    def counting(device):
        calls["n"] += 1
        return real(device)

    monkeypatch.setattr(engine_mod, "_block_until_ready", counting)
    eng = _engine(setup, walk)
    plain = _serve(eng)
    assert calls["n"] == 0, "profile=False must never reach _block_until_ready"
    assert not any(n.startswith("engine_profile_") for n in eng.metrics.names())

    prof = _engine(setup, walk, profile=True)
    reqs = _serve(prof)
    assert [r.generated for r in reqs] == [r.generated for r in plain]
    assert calls["n"] > 0
    # one counted host sync per profiled dispatch, on top of the plain run's
    assert prof.host_syncs_total - eng.host_syncs_total == calls["n"]
    seen = {n[len("engine_profile_"):-len("_seconds")] for n in prof.metrics.names()
            if n.startswith("engine_profile_")}
    assert PHASES[walk] <= seen, seen
    for phase in seen:
        assert prof.metrics.get(f"engine_profile_{phase}_seconds").count > 0
    phases = [e.args.get("phases") for e in prof.tracer.events if e.name == "step"]
    assert all(p for p in phases) and PHASES[walk] <= set().union(*phases)


class _StepLog:
    """Stands in for a bridge's ``record_step``: logs each step's occupancy
    and charges 1 J a step, so the requests' shares depend only on the
    engine's work accounting, not on its clock."""

    def __init__(self):
        self.occupancy = []

    def __call__(self, seconds, *, occupancy):
        self.occupancy.append(occupancy)
        return 1.0


@pytest.fixture(scope="module")
def bridged():
    jcfg, tcfg = jax_reduce(jax_get_config("olmo-1b")), reduce_for_smoke(get_config("olmo-1b"))
    jparams = jax_init_params(jcfg, jax.random.PRNGKey(0), jnp.float32)
    return jcfg, tcfg, jparams, params_from_jax(tcfg, jax.tree.map(np.asarray, jparams), device="cpu")


def _logged(side, bridged, walk, **kw):
    """An fp32 engine of ``side`` ("jax" or "torch") whose bridge logs."""
    jcfg, tcfg, jparams, tparams = bridged
    kind, extra = WALKS[walk]
    log = _StepLog()
    if side == "jax":
        bridge = JaxEnergyBridge(chips=1)
        cls, cfg, params, dev = JaxEngine, jcfg, jparams, dict(cache_dtype=jnp.float32)
    else:
        bridge = EnergyBridge(chips=1)
        cls, cfg, params, dev = InferenceEngine, tcfg, tparams, dict(cache_dtype=torch.float32, device="cpu")
    bridge.record_step = log
    eng = cls(cfg, params, max_batch=2, max_seq=64, block_size=8, cache_kind=kind, eos_token=1 << 20,
              energy=bridge, **dev, **extra, **kw)
    return eng, log


def _profiled_phases(eng) -> set:
    return {n for n in eng.metrics.names() if n.startswith("engine_profile_")}


@pytest.mark.parametrize("walk", list(WALKS))
def test_energy_split_and_phases_match_jax_engine(bridged, walk):
    """Step for step the same occupancy as the JAX engine, and each
    request's joules the same float sum of the same shares; profiled, the
    same ``engine_profile_*`` histograms."""
    out = {}
    for side in ("jax", "torch"):
        for profile in (False, True):
            eng, log = _logged(side, bridged, walk, profile=profile)
            reqs = _serve(eng)
            out[side, profile] = ([list(r.generated) for r in reqs], log.occupancy, [r.energy_j for r in reqs],
                                  _profiled_phases(eng))
    tokens, occupancy, joules, _ = out["jax", False]
    assert len(occupancy) > 3 and 0 < min(occupancy) and max(occupancy) == 1.0
    assert sum(joules) == pytest.approx(len(occupancy))  # every step did work
    for key, (t, occ, j, phases) in out.items():
        assert (t, occ, j) == (tokens, occupancy, joules), key
    assert out["torch", False][3] == out["jax", False][3] == set()
    assert out["torch", True][3] == out["jax", True][3] and out["jax", True][3]


def test_stats_defensive_snapshot_and_guards(setup):
    eng = _engine(setup, "spec")
    s = eng.stats()  # empty: every derived rate guards, none raises
    assert s["mean_ttft_s"] is None and s["ttft_p50_s"] is None
    assert s["acceptance_rate"] == 0.0 and s["accepted_per_step"] == 0.0
    assert s["prefix_hit_rate"] == 0.0 and s["joules_per_token"] == 0.0 and s["energy_joules"] == 0.0
    s["tokens_out"] = 999999
    s.clear()
    s2 = eng.stats()
    assert s2["tokens_out"] == 0 and "cache_kind" in s2


@pytest.mark.parametrize("walk", list(WALKS))
def test_energy_attribution(setup, walk):
    clk = ManualClock(tick=0.01)  # nonzero step durations without sleeping
    eng = _engine(setup, walk, clock=clk)
    reqs = [eng.submit([9 + i, 2, 3], max_new_tokens=4) for i in range(3)]
    eng.run_until_drained()
    s = eng.stats()
    assert s["energy_joules"] > 0
    assert s["joules_per_token"] == pytest.approx(s["energy_joules"] / s["tokens_out"])
    # the step joules split exactly over the requests that did the work
    assert sum(r.energy_j for r in reqs) == pytest.approx(eng.energy.joules, rel=1e-12)
    assert all(r.energy_j > 0 and r.joules_per_token > 0 for r in reqs)
    assert eng.metrics.get("engine_energy_joules_total").value == pytest.approx(eng.energy.joules)
    assert all(r.step_work == 0 for r in reqs)
    # a fixed roofline utilization override scales the charge deterministically
    bridge = EnergyBridge(chips=4, utilization=0.5)
    j = bridge.record_step(2.0, occupancy=1.0)
    assert j == pytest.approx(2.0 * 4 * telemetry.chip_power(0.5))
    assert bridge.record_step(0.0, occupancy=1.0) == 0.0 and bridge.joules == j


def test_energy_bridge_passed_in_is_charged(setup):
    bridge = EnergyBridge(job_id="tenant-a")
    eng = _engine(setup, "dense", energy=bridge, clock=ManualClock(tick=0.01))
    _serve(eng)
    assert eng.energy is bridge and bridge.joules > 0
    assert bridge.report()["jobs"].keys() == {"tenant-a"}


CONSTANTS = ("CHIP_PEAK_W", "CHIP_IDLE_W", "HOST_OVERHEAD_W", "PUE_FREE_COOLING", "PUE_CHILLER",
             "FREE_COOLING_FRACTION", "GRID_KGCO2_PER_KWH")
RECORDS = [("a", 1, 2.0, 0.0), ("a", 4, 0.5, 1.0), ("b", 5, 1.25, 0.37), ("b", 8, 3.0, 1.4), ("c", 1, 0.01, -0.2)]


def _ledger_readings(mod):
    ledger = mod.EnergyLedger()
    charged = [ledger.record(job, chips=c, seconds=t, utilization=u) for job, c, t, u in RECORDS]
    return charged, ledger.report(), ledger.job_chipseconds, mod.mw_check(5448), mod.effective_pue()


def test_ledger_charges_the_jax_ledgers_joules_with_its_constants(monkeypatch):
    for name in CONSTANTS:
        monkeypatch.setattr(telemetry, name, getattr(jax_telemetry, name))
    assert _ledger_readings(telemetry) == _ledger_readings(jax_telemetry)
    roofline = {"compute_s": 0.3, "memory_s": 0.5}
    assert telemetry.train_step_utilization(roofline) == jax_telemetry.train_step_utilization(roofline)


def test_ledger_constants_are_the_cards():
    """The H100's power limit and idle draw; no host power; the facility's
    PUE and grid constants as in the JAX package."""
    assert telemetry.CHIP_PEAK_W == 700.0 and 0 < telemetry.CHIP_IDLE_W < 100.0
    assert telemetry.HOST_OVERHEAD_W == 0.0
    assert telemetry.chip_power(0.0) == telemetry.CHIP_IDLE_W and telemetry.chip_power(1.0) == 700.0
    for name in ("PUE_FREE_COOLING", "PUE_CHILLER", "FREE_COOLING_FRACTION", "GRID_KGCO2_PER_KWH"):
        assert getattr(telemetry, name) == getattr(jax_telemetry, name)
    ledger = telemetry.EnergyLedger()
    assert ledger.record("j", chips=4, seconds=1.0, utilization=1.0) == 4 * 700.0
