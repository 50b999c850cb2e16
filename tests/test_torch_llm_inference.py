"""The port's Fig. 9 harness (``repro_torch.benchmarks.llm_inference``)
against JAX engines built with the same shapes and prompts.

Each ported scenario runs at the reference's sizes on the CPU with the JAX
engine's weights (bridged) and the reference's bf16 caches, and its
integer outputs must equal the JAX engines': tokens (and so tokens out),
decode steps, prefill and prefix-hit tokens, ``peak_active``, drafted and
accepted tokens, preemptions, aborts, and the virtual-clock TTFTs; the
harness's own checks (the reference's assertions) must pass.  The JAX
side runs the reference module's workload generators and drive functions
(``benchmarks/llm_inference.py``), never its scenario functions, which
write into ``benchmarks/results/``; the port writes into ``tmp_path``.
"""

import importlib.util
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config.model import reduce_for_smoke as jax_reduce
from repro.configs import get_config as jax_get_config
from repro.models import init_params as jax_init_params
from repro.serving import FaultPlan as JaxFaultPlan
from repro.serving import InferenceEngine as JaxEngine
from repro.serving import ManualClock as JaxClock
from repro.serving import Replica as JaxReplica
from repro.serving import Router as JaxRouter
from repro_torch.benchmarks import llm_inference as B
from repro_torch.launch import roofline
from repro_torch.bridge import params_from_jax

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parents[1]


def _reference_module():
    spec = importlib.util.spec_from_file_location("reference_llm_inference", ROOT / "benchmarks" / "llm_inference.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


ref = _reference_module()


@pytest.fixture(scope="module")
def model():
    jcfg = jax_reduce(jax_get_config("mistral-nemo-12b"))
    jparams = jax_init_params(jcfg, jax.random.PRNGKey(0), jnp.float32)
    tcfg, _ = B.default_model("cpu")
    return jcfg, jparams, tcfg, params_from_jax(tcfg, jax.tree.map(np.asarray, jparams), device="cpu")


def _jax_drive(eng, prompts, max_new) -> dict:
    """The reference's closed-loop ``_drive``, keeping the requests."""
    reqs = [eng.submit(p, max_new_tokens=max_new, online=i % 2 == 0) for i, p in enumerate(prompts)]
    eng.run_until_drained()
    s = eng.stats()
    s["tokens"] = [list(r.generated) for r in reqs]
    s["finish_reasons"] = [r.finish_reason for r in reqs]
    return s


INT_KEYS = ("tokens_out", "decode_steps", "prefill_tokens", "prefill_chunks", "peak_active", "preemptions",
            "requests_done", "requests_aborted", "deadline_violations")
SPEC_KEYS = ("drafted_tokens", "accepted_tokens", "verify_tokens", "spec_steps")


def _same(t: dict, j: dict, keys=INT_KEYS) -> None:
    for k in keys:
        assert t[k] == j[k], k
    for k in ("prefix_hit_tokens", "prefix_hits") + SPEC_KEYS:
        assert t.get(k) == j.get(k), k


def test_defaults_and_workloads_are_the_references():
    for name in ("MAX_SEQ", "DENSE_BATCH", "BLOCK_SIZE", "N_REQUESTS", "MAX_NEW", "SYSTEM_PROMPT_LEN", "UNIQUE_TAIL",
                 "SPEC_PATTERN", "SPEC_REQUESTS", "SPEC_MAX_NEW", "SPEC_K", "OPENLOOP_QPS", "OPENLOOP_REQUESTS",
                 "OPENLOOP_SEED", "HI_DEADLINE_S", "STEP_OVERHEAD_S", "TOKEN_COST_S", "SPILL_GROUPS", "SPILL_ROUNDS",
                 "SPILL_MAX_NEW", "SPILL_NUM_BLOCKS", "SPILL_BYTES", "RESTORE_COST_S", "DISPATCH_OVERHEAD_S"):
        assert getattr(B, name) == getattr(ref, name), name
    assert (B.LOW_PROMPT, B.LOW_MAX_NEW, B.HI_PROMPT, B.HI_MAX_NEW) == (
        ref.LOW_PROMPT, ref.LOW_MAX_NEW, ref.HI_PROMPT, ref.HI_MAX_NEW)
    assert B.shared_prefix_prompts() == ref._shared_prefix_prompts()
    assert B.spill_prompts() == ref._spill_prompts()
    assert B.openloop_arrivals() == ref._openloop_arrivals()
    assert B.spec_prompts() == [[200 + i] + ref.SPEC_PATTERN * 6 for i in range(ref.SPEC_REQUESTS)]
    assert B.default_prompts() == [[1 + i, 2, 3, 4] for i in range(ref.N_REQUESTS)]


def test_closed_loop_matches_jax_engines(model, tmp_path, monkeypatch):
    """Paged against dense at equal bytes, the shared-prompt A/B and the
    three speculative arms, as the reference's ``run()`` builds them."""
    jcfg, jparams, tcfg, tparams = model
    monkeypatch.setattr(roofline, "RESULTS_DIR", tmp_path)  # no dry run there: no roofline row
    rows = B.run(tcfg, tparams, device="cpu", out=tmp_path, trace_out=str(tmp_path / "trace.json"))
    got = {r["name"].removeprefix("llm_inference_"): r for r in rows}
    written = json.loads((tmp_path / "llm_inference.json").read_text())
    assert [r["name"] for r in written] == [r["name"] for r in rows] and (tmp_path / "trace.json").exists()

    mk = lambda **kw: JaxEngine(jcfg, jparams, max_seq=ref.MAX_SEQ, **kw)  # noqa: E731
    prompts = B.default_prompts()
    expect = {
        "dense": _jax_drive(mk(max_batch=ref.DENSE_BATCH, cache_kind="dense"), prompts, ref.MAX_NEW),
        "paged": _jax_drive(mk(max_batch=ref.N_REQUESTS, cache_kind="paged", block_size=ref.BLOCK_SIZE,
                               num_blocks=ref.DENSE_BATCH * ref.MAX_SEQ // ref.BLOCK_SIZE), prompts, ref.MAX_NEW),
    }
    shared = dict(max_batch=4, cache_kind="paged", block_size=ref.BLOCK_SIZE)
    for label, on in (("uncached", False), ("cached", True)):
        expect[f"prefix_{label}"] = _jax_drive(
            mk(prefix_cache=on, prefill_budget=32, **shared), ref._shared_prefix_prompts(), 8)
    for label, kw in (("off", {}), ("ngram", dict(spec_decode="ngram", spec_k=ref.SPEC_K)),
                      ("draft", dict(spec_decode="draft", spec_k=ref.SPEC_K, draft_cfg=jcfg, draft_params=jparams))):
        expect[f"spec_{label}"] = _jax_drive(mk(**shared, **kw), B.spec_prompts(), ref.SPEC_MAX_NEW)
    assert got.keys() == expect.keys()
    for arm, j in expect.items():
        t = got[arm]
        assert t["tokens"] == j["tokens"], arm
        assert t["finish_reasons"] == j["finish_reasons"], arm
        _same(t, j)
        assert t["time_base"] == "wall clock, cpu"
    assert got["dense"]["cache_bytes"] == expect["dense"]["cache_bytes"]
    # the port keeps one block table where the JAX engine keeps one per layer
    L, nb = tcfg.num_layers, ref.MAX_SEQ // ref.BLOCK_SIZE
    assert got["paged"]["cache_bytes"] == expect["paged"]["cache_bytes"] - (L - 1) * ref.N_REQUESTS * nb * 4
    assert got["paged"]["alloc_peak_in_use"] == expect["paged"]["alloc_peak_in_use"]
    assert got["paged"]["peak_active"] > got["dense"]["peak_active"] == ref.DENSE_BATCH
    for arm in ("spec_ngram", "spec_draft"):
        assert got[arm]["acceptance_rate"] == expect[arm]["acceptance_rate"]
        assert got[arm]["accepted_per_step"] == expect[arm]["accepted_per_step"]


def test_openloop_matches_jax_engines(model, tmp_path):
    jcfg, jparams, tcfg, tparams = model
    rows = {r["policy"]: r for r in B.run_openloop(tcfg, tparams, device="cpu", out=tmp_path)}
    assert (tmp_path / "llm_inference_openloop.json").exists()
    for policy, t in rows.items():
        clock = JaxClock()
        eng = JaxEngine(jcfg, jparams, max_batch=4, max_seq=ref.MAX_SEQ, cache_kind="paged", block_size=ref.BLOCK_SIZE,
                        num_blocks=13, prefix_cache=True, prefill_budget=16, policy=policy, clock=clock)
        j = ref._drive_openloop(eng, clock, ref._openloop_arrivals())
        done = sorted(eng.done, key=lambda r: r.req_id)
        assert t["tokens"] == [list(r.generated) for r in done]
        assert t["ttfts"] == [r.ttft for r in done]  # virtual time: exact
        _same(t, j)
        for k in ("makespan_s", "high_priority_ttft_p99_s", "high_priority_ttft_p50_s", "ttft_p50_s", "ttft_p99_s"):
            assert t[k] == j[k], k
        assert t["time_base"] == B.MODELLED
    assert rows["slo"]["preemptions"] >= 1 and rows["fcfs"]["requests_aborted"] >= 1


def test_spill_matches_jax_engines(model, tmp_path):
    jcfg, jparams, tcfg, tparams = model
    rows = {r["name"].rsplit("_", 1)[1]: r for r in B.run_spill(tcfg, tparams, device="cpu", out=tmp_path)}
    for label, spill_bytes in (("drop", 0), ("spill", ref.SPILL_BYTES)):
        clock = JaxClock()
        eng = JaxEngine(jcfg, jparams, max_batch=2, max_seq=ref.MAX_SEQ, cache_kind="paged", block_size=ref.BLOCK_SIZE,
                        num_blocks=ref.SPILL_NUM_BLOCKS, prefix_cache=True, prefill_budget=16,
                        spill_bytes=spill_bytes, clock=clock)
        j, toks = ref._drive_spill(eng, clock)
        t = rows[label]
        assert t["tokens"] == toks
        assert t["ttfts"] == [r.ttft for r in sorted(eng.done, key=lambda r: r.req_id)]
        assert t["mean_ttft_s"] == j["mean_ttft_s"]
        _same(t, j)
        for k in ("alloc_evictions_dropped", "alloc_evictions_spilled", "restores", "spill_hit_tokens"):
            assert t.get(k) == j.get(k), k
    assert rows["spill"]["prefix_hit_rate"] > rows["drop"]["prefix_hit_rate"]


def test_fused_matches_jax_engines(model, tmp_path):
    jcfg, jparams, tcfg, tparams = model
    rows = {r["name"].split("_")[2]: r for r in B.run_fused(tcfg, tparams, device="cpu", out=tmp_path)}
    prompts = ref._shared_prefix_prompts()
    for label, fused in (("legacy", False), ("fused", True)):
        eng = JaxEngine(jcfg, jparams, max_batch=4, max_seq=ref.MAX_SEQ, cache_kind="paged", block_size=ref.BLOCK_SIZE,
                        prefix_cache=True, prefill_budget=32, fused=fused)
        for p in prompts:
            eng.submit(p, max_new_tokens=8)
        eng.run_until_drained()
        d0, y0, s0 = eng.dispatches_total, eng.host_syncs_total, eng.steps
        reqs = [eng.submit(p, max_new_tokens=8) for p in prompts]
        eng.run_until_drained()
        t = rows[label]
        assert t["tokens"] == [list(r.generated) for r in reqs]
        assert t["decode_steps"] == eng.steps - s0
        assert t["dispatches_per_step"] == (eng.dispatches_total - d0) / (eng.steps - s0)
        assert t["host_syncs_per_token"] == (eng.host_syncs_total - y0) / t["tokens_out"]
    assert rows["fused"]["model_step_s"] < rows["legacy"]["model_step_s"]


def test_router_matches_jax_routers(model, tmp_path):
    """``run_router``'s four arms against JAX routers of the reference's
    shapes (``_make_router``'s engines, with an ``eos_token`` outside the
    vocab on both sides), driven by the reference's ``_drive_router`` on its
    tenant prompts: tokens, placements' integer results, hit rates,
    failovers, retries, replica states and the virtual clock's numbers."""
    jcfg, jparams, tcfg, tparams = model
    eos = 1 << 30
    rows = {r["name"].removeprefix("llm_inference_router_"): r
            for r in B.run_router(tcfg, tparams, device="cpu", out=tmp_path, eos_token=eos)}
    assert (tmp_path / "llm_inference_router.json").exists()
    assert B.tenant_prompts() == ref._tenant_prompts()
    assert (B.ROUTER_TENANTS, B.ROUTER_PER_TENANT, B.ROUTER_MAX_NEW) == (
        ref.ROUTER_TENANTS, ref.ROUTER_PER_TENANT, ref.ROUTER_MAX_NEW)

    def arm(n, policy="affinity", fault_plans=None):
        clock = JaxClock()
        replicas = [
            JaxReplica(i, JaxEngine(jcfg, jparams, max_batch=4, max_seq=ref.MAX_SEQ, cache_kind="paged",
                                    block_size=ref.BLOCK_SIZE, prefix_cache=True, prefill_budget=16, clock=clock,
                                    eos_token=eos),
                       clock=clock, fault_plan=(fault_plans or {}).get(i))
            for i in range(n)
        ]
        router = JaxRouter(replicas, policy=policy, clock=clock)
        s, toks = ref._drive_router(router, clock, ref._tenant_prompts())
        return router, s, toks

    expect = {}
    _, *expect["single"] = arm(1)
    aff_router, *expect["affinity"] = arm(2)
    _, *expect["random"] = arm(2, policy="random")
    crash_at = max(aff_router.replicas[0].steps // 2, 1)
    _, *expect["failover"] = arm(2, fault_plans={0: JaxFaultPlan(crash_at_step=crash_at)})
    assert rows.keys() == expect.keys()
    for name, (j, toks) in expect.items():
        t = rows[name]
        assert t["tokens"] == toks, name
        for k in ("requests_submitted", "requests_done", "requests_failed", "requests_inflight", "failovers",
                  "retries", "migrations", "tokens_out", "prefill_tokens", "prefix_hit_tokens", "prefix_hit_rate",
                  "replica_states", "makespan_s", "tok_per_s"):
            assert t[k] == j[k], (name, k)
    assert rows["failover"]["crash_at_step"] == crash_at and rows["failover"]["failovers"] >= 1
    assert all(r["tokens_match_single"] for r in rows.values())
    assert rows["affinity"]["prefix_hit_rate"] > rows["random"]["prefix_hit_rate"]
    assert rows["affinity"]["speedup_vs_single"] > B.ROUTER_SCALING


def test_main_writes_where_asked(tmp_path, capsys):
    rows = B.main(["--device", "cpu", "--out", str(tmp_path), "--spill"])
    assert (tmp_path / "llm_inference_spill.json").exists() and len(rows) == 2
    assert capsys.readouterr().out.count("llm_inference_tiered_") == 2
    assert not str(B.OUT_DIR).startswith(str(ROOT / "benchmarks"))
