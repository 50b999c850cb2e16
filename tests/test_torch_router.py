"""The port's multi-replica router, replicas and fault plans against the JAX
package's, scenario for scenario.

Each test runs one scenario of ``tests/test_router.py`` twice, over the JAX
front-ends with JAX engines and over the port's front-ends with torch
engines, on the same weights (``bridge.params_from_jax``) at
``reduce_for_smoke(olmo-1b)``, and requires equal observations: which
replica each request lands on, tokens, finish reasons, request and replica
states, and the router's ``stats()`` with the timing keys and
``cache_bytes`` left out (the port keeps one block table where the JAX
engine keeps one per layer).  Then the reference test's own assertions run
on the port's observations.  Both sides use fp32 pools, so no near-tie can
flip an argmax, and an ``eos_token`` outside the vocab, so every request
runs to its length.  Clocks are the reference's: ``ManualClock`` where it
uses one, the real clock elsewhere (where no time-driven decision is made).

The port's serve launcher (``repro_torch.launch.serve``) drains on the CPU
with one engine and with two replicas; ``--tp 2`` exits naming the
tensor-parallel item.
"""

import asyncio
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.serving as J
import repro_torch.serving as T
from repro.config.model import reduce_for_smoke as jax_reduce
from repro.configs import get_config as jax_get_config
from repro.models import init_params as jax_init_params
from repro_torch.bridge import params_from_jax
from repro_torch.config import reduce_for_smoke
from repro_torch.configs import get_config

torch.set_num_threads(2)

EOS = 1 << 30  # outside the vocab: every request runs to its length
# stats that read the clock, or the cache layout (one block table against
# one per layer)
UNCOMPARED = ("mean_ttft_s", "ttft_p50_s", "ttft_p99_s", "tpot_p50_s", "tpot_p99_s", "energy_joules",
              "joules_per_token", "cache_bytes")


@pytest.fixture(scope="module")
def sides():
    jcfg = jax_reduce(jax_get_config("olmo-1b"))
    jparams = jax_init_params(jcfg, jax.random.PRNGKey(0), jnp.float32)
    tcfg = reduce_for_smoke(get_config("olmo-1b"))
    tparams = params_from_jax(tcfg, jax.tree.map(np.asarray, jparams), device="cpu")
    return {
        "jax": SimpleNamespace(mod=J, cfg=jcfg, params=jparams, engine_kw=dict(cache_dtype=jnp.float32)),
        "torch": SimpleNamespace(mod=T, cfg=tcfg, params=tparams,
                                 engine_kw=dict(cache_dtype=torch.float32, device="cpu")),
    }


def make_engine(S, **kw):
    kw.setdefault("max_batch", 4)
    kw.setdefault("max_seq", 64)
    kw.setdefault("cache_kind", "paged")
    kw.setdefault("block_size", 4)
    kw.setdefault("prefix_cache", True)
    kw.setdefault("prefill_budget", 8)
    return S.mod.InferenceEngine(S.cfg, S.params, eos_token=EOS, **S.engine_kw, **kw)


def make_router(S, n, *, clock=None, fault_plans=None, engine_kw=None, **router_kw):
    replicas = [
        S.mod.Replica(
            i,
            make_engine(S, clock=clock, **(engine_kw or {})),
            clock=clock,
            fault_plan=(fault_plans or {}).get(i),
        )
        for i in range(n)
    ]
    router_kw.setdefault("backoff_base_s", 1e-4)
    return S.mod.Router(replicas, clock=clock, **router_kw)


def family(t, n=8):
    return [(13 * t + 5 * j + 7) % 197 + 2 for j in range(n)]


def comparable(stats: dict) -> dict:
    """Router stats without the clock-read keys and ``cache_bytes``."""
    out = {k: v for k, v in stats.items() if k not in UNCOMPARED and k != "per_replica"}
    out["per_replica"] = {i: {k: v for k, v in s.items() if k not in UNCOMPARED}
                          for i, s in stats["per_replica"].items()}
    return out


def both(sides, scenario) -> dict:
    """Run ``scenario`` on each side; the observations must be equal."""
    obs = {name: scenario(S) for name, S in sides.items()}
    assert obs["torch"] == obs["jax"]
    return obs["torch"]


def seen(req) -> dict:
    return dict(replica=req.replica_id, state=req.state, reason=req.finish_reason, tokens=list(req.generated),
                failovers=req.failovers, attempts=req.attempts)


# ---- FaultPlan unit behaviour ---------------------------------------------


@pytest.mark.parametrize(
    "plan",
    [dict(crash_at_step=3, hang_from_step=10, slow_from_step=5, slow_until_step=8), {},
     dict(slow_from_step=0, slow_until_step=None), dict(slow_from_step=2, slow_every=3)],
)
def test_fault_plan_schedule(plan):
    tp, jp = T.FaultPlan(**plan), J.FaultPlan(**plan)
    for k in range(24):
        assert (tp.crashes_at(k), tp.hangs_at(k), tp.slow_at(k)) == (jp.crashes_at(k), jp.hangs_at(k), jp.slow_at(k))
    assert tp.benign == jp.benign
    if plan.get("crash_at_step") == 3:
        assert not tp.crashes_at(2) and tp.crashes_at(3) and tp.crashes_at(7)
        assert not tp.hangs_at(9) and tp.hangs_at(10)
        assert not tp.slow_at(4) and tp.slow_at(5) and tp.slow_at(7) and not tp.slow_at(8)
    with pytest.raises(ValueError):
        T.FaultPlan(slow_every=0)


def test_router_validation(sides):
    for S in sides.values():
        M = S.mod
        with pytest.raises(ValueError):
            M.Router([])
        eng = make_engine(S)
        with pytest.raises(ValueError):
            M.Router([M.Replica(0, eng), M.Replica(0, eng)])
        with pytest.raises(ValueError):
            M.Router([M.Replica(0, eng)], policy="sticky-bit")
        with pytest.raises(ValueError):
            M.Router([M.Replica(0, eng)], suspect_after=2.0, fail_after=1.0)
        with pytest.raises(ValueError):
            M.Router([M.Replica(0, eng)], max_retries=-1)
        with pytest.raises(ValueError):
            M.Replica(-1, eng)
    assert T.ROUTING_POLICIES == J.ROUTING_POLICIES


# ---- routing --------------------------------------------------------------


def test_affinity_routes_to_warm_replica(sides):
    def scenario(S):
        router = make_router(S, 2)
        first = router.submit(family(0) + [31, 32], max_new_tokens=4)
        router.run_until_drained()
        warm = first.replica_id
        cold = router.replicas[1 - warm]
        cold_req = cold.engine.submit([9, 8, 7], max_new_tokens=2)
        follower = router.submit(family(0) + [41, 42], max_new_tokens=4)
        routed = follower.replica_id
        affinity = router.metrics.counter("router_affinity_routed_total").value
        router.run_until_drained()
        return dict(warm=warm, routed=routed, affinity=affinity, first=seen(first), follower=seen(follower),
                    cold=(cold_req.state.name, list(cold_req.generated)), stats=comparable(router.stats()))

    o = both(sides, scenario)
    assert o["routed"] == o["warm"] and o["affinity"] >= 1
    assert o["follower"]["tokens"] and o["follower"]["state"] == "done"
    assert o["cold"][0] == "DONE"


def test_sticky_key_pins_cold_burst(sides):
    def scenario(S):
        router = make_router(S, 2)
        burst = [router.submit(family(3) + [60 + i], max_new_tokens=3) for i in range(3)]
        other = router.submit(family(4), max_new_tokens=3)
        placed = [r.replica_id for r in burst] + [other.replica_id]
        router.run_until_drained()
        return dict(placed=placed, reqs=[seen(r) for r in burst + [other]], stats=comparable(router.stats()))

    o = both(sides, scenario)
    assert len(set(o["placed"][:3])) == 1 and o["placed"][3] != o["placed"][0]
    assert all(r["state"] == "done" for r in o["reqs"])


def test_distinct_prompts_balance_by_load(sides):
    def scenario(S):
        router = make_router(S, 2)
        reqs = [router.submit(family(t), max_new_tokens=3) for t in range(4)]
        placed = [r.replica_id for r in reqs]
        router.run_until_drained()
        return dict(placed=placed, reqs=[seen(r) for r in reqs], stats=comparable(router.stats()))

    o = both(sides, scenario)
    assert set(o["placed"]) == {0, 1}
    s = o["stats"]
    assert s["requests_done"] == 4 and s["requests_failed"] == 0 and s["failovers"] == 0


def test_round_robin_and_random_policies(sides):
    def scenario(S):
        rr = make_router(S, 2, policy="round_robin")
        a = rr.submit(family(0), max_new_tokens=2)
        b = rr.submit(family(0), max_new_tokens=2)
        rnd = make_router(S, 2, policy="random")
        reqs = [rnd.submit(family(t), max_new_tokens=2) for t in range(8)]
        return dict(rr=[a.replica_id, b.replica_id], random=[r.replica_id for r in reqs])

    o = both(sides, scenario)
    assert set(o["rr"]) == {0, 1}
    assert all(r in (0, 1) for r in o["random"])


# ---- failover correctness -------------------------------------------------


def test_crash_failover_is_token_identical(sides):
    prompts = [family(t) + [50 + t] for t in range(4)]

    def scenario(S):
        clock = S.mod.ManualClock(tick=1e-4)
        router = make_router(S, 2, clock=clock, fault_plans={0: S.mod.FaultPlan(crash_at_step=4)})
        reqs = [router.submit(p, max_new_tokens=8) for p in prompts]
        on_zero = [r.req_id for r in reqs if r.replica_id == 0]
        router.run_until_drained()
        names = [e.name for e in router.tracer.events]
        return dict(on_zero=on_zero, reqs=[seen(r) for r in reqs], preemptions=[r.preemptions for r in reqs],
                    states=[r.state.value for r in router.replicas], stats=comparable(router.stats()),
                    down="replica_down" in names, failover="failover" in names,
                    metric="router_failovers_total" in router.metrics.render_text())

    o = both(sides, scenario)
    ref = make_engine(sides["torch"], max_batch=8)
    ref_reqs = [ref.submit(p, max_new_tokens=8) for p in prompts]
    ref.run_until_drained()
    assert o["on_zero"], "load balancing must place work on the doomed replica"
    assert o["states"][0] == "dead"
    s = o["stats"]
    assert s["requests_done"] == 4 and s["requests_failed"] == 0
    assert s["failovers"] >= len(o["on_zero"]) and s["retries"] >= len(o["on_zero"])
    assert [r["tokens"] for r in o["reqs"]] == [r.generated for r in ref_reqs], "failover changed greedy output"
    moved = o["reqs"][o["on_zero"][0]]
    assert moved["failovers"] >= 1 and o["preemptions"][o["on_zero"][0]] == moved["failovers"]
    assert moved["replica"] == 1
    assert o["down"] and o["failover"] and o["metric"]


def test_hang_detected_by_heartbeat_sweep(sides):
    def scenario(S):
        clock = S.mod.ManualClock(tick=0.01)
        router = make_router(S, 2, clock=clock, suspect_after=0.05, fail_after=0.4,
                             fault_plans={0: S.mod.FaultPlan(hang_from_step=1)})
        req = router.submit(family(1), max_new_tokens=6)
        first = req.replica_id
        router.run_until_drained()
        names = [e.name for e in router.tracer.events]
        return dict(first=first, req=seen(req), states=[r.state.value for r in router.replicas],
                    names=sorted(set(names)), stats=comparable(router.stats()))

    o = both(sides, scenario)
    assert o["first"] == 0
    assert o["states"][0] == "unhealthy"
    assert o["req"]["state"] == "done" and o["req"]["replica"] == 1 and o["req"]["failovers"] >= 1
    assert "replica_suspect" in o["names"] and "replica_down" in o["names"]
    ref = make_engine(sides["torch"])
    ref_req = ref.submit(family(1), max_new_tokens=6)
    ref.run_until_drained()
    assert o["req"]["tokens"] == ref_req.generated


def test_slow_replica_suspects_then_recovers(sides):
    def scenario(S):
        clock = S.mod.ManualClock()
        router = make_router(S, 2, clock=clock, suspect_after=1.0, fail_after=50.0)
        straggler = router.replicas[0]
        straggler.last_heartbeat = -2.0
        router._sweep_health(clock.now)
        suspect = (straggler.state.value, straggler.admittable)
        req = router.submit(family(2), max_new_tokens=2)
        straggler.last_heartbeat = clock.now
        router._sweep_health(clock.now)
        return dict(suspect=suspect, placed=req.replica_id, recovered=straggler.state.value,
                    names=[e.name for e in router.tracer.events])

    o = both(sides, scenario)
    assert o["suspect"] == ("suspect", True)
    assert o["placed"] == 1, "healthy peer preferred over the suspect"
    assert o["recovered"] == "healthy"
    assert "replica_suspect" in o["names"] and "replica_recovered" in o["names"]


def test_retry_exhaustion_fails_the_request(sides):
    def scenario(S):
        clock = S.mod.ManualClock(tick=1e-4)
        router = make_router(S, 2, clock=clock, fault_plans={0: S.mod.FaultPlan(crash_at_step=2),
                                                             1: S.mod.FaultPlan(crash_at_step=2)})
        reqs = [router.submit(family(t), max_new_tokens=8) for t in range(2)]
        done = router.run_until_drained()
        return dict(reqs=[seen(r) for r in reqs], states=[r.state.value for r in router.replicas],
                    done=len(done), has_work=router.has_work, stats=comparable(router.stats()))

    o = both(sides, scenario)
    assert o["states"] == ["dead", "dead"]
    assert all(r["state"] == "failed" for r in o["reqs"])
    assert {r["reason"] for r in o["reqs"]} <= {"failed", "unavailable"}
    assert o["done"] == 2 and not o["has_work"] and o["stats"]["requests_failed"] == 2


def test_degraded_mode_rejects_submissions(sides):
    def scenario(S):
        router = make_router(S, 1)
        router.replicas[0].state = S.mod.ReplicaState.UNHEALTHY
        with pytest.raises(S.mod.ServiceUnavailable) as err:
            router.submit(family(0), max_new_tokens=2)
        return dict(error=str(err.value), rejected=router.metrics.counter("router_unavailable_total").value,
                    stats=comparable(router.stats()))

    o = both(sides, scenario)
    assert o["rejected"] == 1 and o["stats"]["replicas_admittable"] == 0


def test_abort_reaches_parked_failover(sides):
    def scenario(S):
        clock = S.mod.ManualClock()
        router = make_router(S, 2, clock=clock, backoff_base_s=1e9,
                             fault_plans={0: S.mod.FaultPlan(crash_at_step=1)})
        req = router.submit(family(5), max_new_tokens=8)
        first = req.replica_id
        router.step()
        router.step()
        parked = (req.engine_req is None, req.state)
        aborted = router.abort(req, "cancelled")
        after = seen(req)
        again = router.abort(req)
        router.run_until_drained()
        return dict(first=first, parked=parked, aborted=aborted, after=after, again=again,
                    stats=comparable(router.stats()))

    o = both(sides, scenario)
    assert o["first"] == 0 and o["parked"] == (True, "active")
    assert o["aborted"] and o["after"]["state"] == "done" and o["after"]["reason"] == "cancelled"
    assert not o["again"], "double abort is a no-op"
    assert o["stats"]["requests_inflight"] == 0


# ---- drain ----------------------------------------------------------------


def test_drain_finishes_work_then_retires(sides):
    def scenario(S):
        router = make_router(S, 2)
        req = router.submit(family(0), max_new_tokens=6)
        first = req.replica_id
        router.step()
        router.drain(0)
        late = router.submit(family(0) + [70], max_new_tokens=2)
        router.run_until_drained()
        router.step()
        with pytest.raises(ValueError):
            router.drain(0)
        names = [e.name for e in router.tracer.events]
        return dict(first=first, req=seen(req), late=seen(late), states=[r.state.value for r in router.replicas],
                    drain="drain" in names, complete="drain_complete" in names, stats=comparable(router.stats()))

    o = both(sides, scenario)
    assert o["first"] == 0 and o["late"]["replica"] == 1, "draining replica must not admit, even on affinity"
    assert o["req"]["state"] == "done" and o["req"]["replica"] == 0, "drain lets work finish in place"
    assert o["states"][0] == "retired" and o["drain"] and o["complete"]


def test_drain_migrate_moves_work_token_identically(sides):
    def scenario(S):
        clock = S.mod.ManualClock(tick=1e-4)
        router = make_router(S, 2, clock=clock)
        req = router.submit(family(6), max_new_tokens=8)
        first = req.replica_id
        for _ in range(3):
            router.step()
        mid = len(req.generated)
        router.drain(0, migrate=True)
        router.run_until_drained()
        router.step()
        alloc = router.replicas[0].engine.allocator
        return dict(first=first, mid=mid, req=seen(req), states=[r.state.value for r in router.replicas],
                    free=(alloc.num_free, alloc.capacity), stats=comparable(router.stats()))

    o = both(sides, scenario)
    ref = make_engine(sides["torch"])
    ref_req = ref.submit(family(6), max_new_tokens=8)
    ref.run_until_drained()
    assert o["first"] == 0 and o["mid"] > 0, "migration must happen mid-decode to test resume"
    assert o["req"]["state"] == "done" and o["req"]["replica"] == 1
    assert o["req"]["tokens"] == ref_req.generated, "migration changed greedy output"
    assert o["stats"]["migrations"] == 1 and o["stats"]["failovers"] == 0
    assert o["states"][0] == "retired"
    assert o["free"][0] == o["free"][1], "migrated-off replica must hold no blocks"


# ---- the async loop serves a fleet unchanged ------------------------------


def test_async_engine_drives_router_fleet(sides):
    prompts = [family(0) + [80], family(1) + [81]]

    def scenario(S):
        async def go():
            async with S.mod.AsyncEngine(make_router(S, 2)) as aeng:
                return await asyncio.gather(*(aeng.generate(p, max_new_tokens=5) for p in prompts))

        return [(final.reason, final.n_tokens, toks) for final, toks in asyncio.run(go())]

    o = both(sides, scenario)
    ref = make_engine(sides["torch"])
    ref_reqs = [ref.submit(p, max_new_tokens=5) for p in prompts]
    ref.run_until_drained()
    assert [toks for _, _, toks in o] == [r.generated for r in ref_reqs]
    assert all(reason == "length" for reason, _, _ in o)


# ---- the serve launcher ---------------------------------------------------


@pytest.mark.parametrize("replicas", [1, 2])
def test_serve_launcher_drains_on_the_cpu(replicas, capsys):
    from repro_torch.launch.serve import main

    stats = main(["--device", "cpu", "--arch", "olmo-1b", "--requests", "6", "--max-new", "4",
                  "--shared-prefix", "16", "--prefill-budget", "16", "--replicas", str(replicas)])
    out = capsys.readouterr().out
    assert "on cpu" in out and "[serve] stats:" in out
    engines = [stats] if replicas == 1 else list(stats["per_replica"].values())
    assert sum(s["requests_done"] for s in engines) == 6
    for s in engines:
        assert s["alloc_blocks_in_use"] == 0 and s["alloc_total_allocs"] == s["alloc_total_frees"]
    if replicas == 2:
        assert stats["requests_done"] == 6 and stats["requests_inflight"] == 0


def test_serve_launcher_refuses_tensor_parallelism():
    from repro_torch.launch.serve import main

    with pytest.raises(SystemExit, match="tensor-parallel item of ROADMAP Queue 1"):
        main(["--device", "cpu", "--tp", "2"])
