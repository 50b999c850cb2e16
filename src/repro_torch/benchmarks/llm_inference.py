"""LLM inference (paper Fig. 9) on the card: paged against dense engines,
prefix-cached against re-prefill admission, speculative decoding, open-loop
SLO scheduling, the tiered KV cache, the fused step and the multi-replica
router.

The torch twin of the repository's ``benchmarks/llm_inference.py``, with
its workloads, engine shapes and assertions.  The paper reports 70B
llama.cpp decode throughput on the Grace CPU; this serves a model through
the port's continuous-batching engine (``repro_torch.serving``):

* **paged vs dense** (``run``) — once with the slot-granular dense cache
  and once with the paged block pool at the **same cache-byte budget**
  (``num_blocks = dense_batch * max_seq / block_size``, slots decoupled
  from ``max_seq``): TTFT and TPOT percentiles, output tokens/s, decode
  steps, achievable concurrency (``peak_active``), cache bytes, peak
  blocks.
* **shared system prompt** (``run``) — every request carries one system
  prompt plus a short unique tail; the prefix-cached engine prefills the
  shared blocks once.  The cached arm must compute at most half the
  uncached arm's prefill tokens, with a hit rate above 0.
* **speculative decoding** (``run``) — the repetitive-suffix workload
  (prompts end in a repeated pattern): off, the n-gram drafter, and the
  target as its own drafter.  Both drafting arms must emit more than one
  token per slot-step and take fewer decode steps than off.
* **open-loop SLO scheduling** (``run_openloop``) — Poisson arrivals at a
  fixed offered QPS, 3:1 long low-priority completions against short
  high-priority requests with a TTFT deadline, on a tight block pool,
  under ``policy="slo"`` and ``"fcfs"``.
* **tiered KV cache** (``run_spill``) — drop-on-evict against the host
  spill tier on an over-committed pool, two rounds of 8 tenants.
* **fused step** (``run_fused``) — the legacy walk against ``fused=True``
  on the shared-prompt workload after a warm-up round.
* **multi-replica router** (``run_router``) — engines behind the
  prefix-affinity ``serving.router.Router`` on a multi-tenant workload (8
  families, each sharing a distinct 3-block system prompt): 1 replica; 2
  with affinity routing (modelled tok/s above 1.3x one replica's, hit rate
  within 10 points of it); 2 with random routing (affinity must beat its
  hit rate); 2 with one replica crashed by a ``FaultPlan`` mid-run (no
  request lost, tokens equal to the no-failure run's).
* **tensor parallelism** (``run_tp``) — one engine over ``tp`` ranks
  (``launch.mesh.run_ranks``, ``InferenceEngine(mesh=)``) against one rank
  on the shared-prompt workload with the prefix cache, a prefill budget of
  32 and n-gram speculative decoding: greedy tokens and the global
  ``cache_bytes`` must equal TP=1's; each rank's pools hold its kv-head
  slice (``cache_bytes_per_device``).

Time bases.  ``run`` times each arm on the wall clock of its device (the
card's by default; the device is named in every row).  The open-loop,
spill and fused arms advance a ``ManualClock`` by a per-step cost model
(``STEP_OVERHEAD_S``, ``TOKEN_COST_S``, ``RESTORE_COST_S``,
``DISPATCH_OVERHEAD_S``), as the reference does: their TTFTs and step
costs are **modelled, not measured**, exact and machine-independent, and
their rows say so (``time_base``).  The router's modelled clock charges a
fleet round its slowest replica's step, as if replicas ran in parallel;
on one card they step in turns, so its rows also read the measured wall
seconds and wall tokens/s, which claim no scaling.  The fused arm's
``wall_step_s`` is measured.  The tensor-parallel rows read the wall clock
of rank 0's drain; their backend is in the row: with gloo, each
collective is staged through host memory, and ranks that share one card
take turns on it, so these times say nothing of NVLink or NCCL.

Every size is a parameter whose default is the reference's constant, so
that on the CPU, with the JAX engine's weights, the integer results equal
the reference's.  The default model is the reference's,
``reduce_for_smoke(mistral-nemo-12b)``, with random weights from seed 0.
Run::

    PYTHONPATH=src python -m repro_torch.benchmarks.llm_inference [--openloop|--spill|--fused|--router] [--device cpu]
    PYTHONPATH=src python -m repro_torch.benchmarks.llm_inference --tp 2 [--backend gloo] [--device cpu]

Results go to ``--out`` (default ``build/llm_inference/`` of the checkout,
which git ignores), one JSON file per scenario.
"""

from __future__ import annotations

import argparse
import gc
import json
import random
import time
from collections import deque
from pathlib import Path

import numpy as np
import torch

from repro_torch.config import reduce_for_smoke
from repro_torch.configs import get_config
from repro_torch.device import resolve_device
from repro_torch.launch.mesh import BACKENDS, pick_backend, run_ranks
from repro_torch.models import init_params
from repro_torch.serving import FaultPlan, InferenceEngine, Replica, Router
from repro_torch.serving.metrics import ManualClock
from repro_torch.utils.tree import tree_map

OUT_DIR = Path(__file__).resolve().parents[3] / "build" / "llm_inference"

MAX_SEQ = 128
DENSE_BATCH = 4
BLOCK_SIZE = 16
N_REQUESTS = 16
MAX_NEW = 12

SYSTEM_PROMPT_LEN = 48  # 3 full blocks shared by every request
UNIQUE_TAIL = 4
SHARED_BATCH = 4  # later requests admit after the prefix is indexed
SHARED_BUDGET = 32
SHARED_MAX_NEW = 8

SPEC_PATTERN = [17, 29, 11, 5]  # repetitive suffix the n-gram drafter can look up
SPEC_REQUESTS = 8
SPEC_MAX_NEW = 24
SPEC_K = 4

MODELLED = "virtual clock: modelled step costs, not measured"


def default_model(device="cuda"):
    """The reference's model: smoke-size mistral-nemo-12b, random fp32
    weights from seed 0."""
    cfg = reduce_for_smoke(get_config("mistral-nemo-12b"))
    return cfg, init_params(cfg, 0, device=resolve_device(device))


def _check(ok: bool, msg: str) -> None:
    if not ok:
        raise AssertionError(msg)


def _device_name(device: torch.device) -> str:
    return torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"


def _percentiles(eng, s: dict) -> None:
    """TTFT/TPOT p50/p99 from the engine's histograms, into ``s``."""
    for key, metric in (("ttft", "engine_ttft_seconds"), ("tpot", "engine_tpot_seconds")):
        p = eng.metrics.percentiles(metric, pcts=(50, 99))
        s[f"{key}_p50_s"], s[f"{key}_p99_s"] = p[50], p[99]


def drive(eng, prompts, *, max_new: int) -> dict:
    """Closed loop: submit every prompt (alternately online and offline),
    drain, and read the engine's stats on the wall clock.  ``tokens`` holds
    each request's generated tokens, ``request_joules`` the joules the
    engine attributed to them (all of ``energy_joules``),
    ``decode_tick_p50_s`` a decode step's median with its sampling and
    host fetch and, for an engine built with ``profile=True``,
    ``profile_s`` the seconds of each profiled phase."""
    t0 = time.perf_counter()
    reqs = [eng.submit(p, max_new_tokens=max_new, online=i % 2 == 0) for i, p in enumerate(prompts)]
    eng.run_until_drained()
    if eng.device.type == "cuda":
        torch.cuda.synchronize(eng.device)
    dt = time.perf_counter() - t0
    s = eng.stats()
    s["wall_s"] = dt
    s["tok_per_s"] = s["tokens_out"] / dt
    _percentiles(eng, s)
    s["tokens"] = [list(r.generated) for r in reqs]
    s["finish_reasons"] = [r.finish_reason for r in reqs]
    s["request_joules"] = sum(r.energy_j for r in reqs)
    s["decode_tick_p50_s"] = eng.metrics.histogram("engine_decode_seconds").percentile(50)
    profiled = {n[len("engine_profile_") : -len("_seconds")]: eng.metrics.get(n).sum
                for n in eng.metrics.names() if n.startswith("engine_profile_")}
    if profiled:  # profile=True: the synced seconds of each phase
        s["profile_s"] = profiled
    return s


def default_prompts() -> list[list[int]]:
    return [[1 + i, 2, 3, 4] for i in range(N_REQUESTS)]


def shared_prefix_prompts(n: int = N_REQUESTS, system_len: int = SYSTEM_PROMPT_LEN, tail: int = UNIQUE_TAIL):
    """One system prompt of ``system_len`` tokens, then ``tail`` unique
    tokens per request (ids below 256 at the reference's sizes, the smoke
    vocab)."""
    system = [(7 * j + 3) % 199 + 2 for j in range(system_len)]
    return [system + [190 + i * tail + t for t in range(tail)] for i in range(n)]


def spec_prompts() -> list[list[int]]:
    """The repetitive-suffix workload: a distinct first token, then the
    pattern six times."""
    return [[200 + i] + SPEC_PATTERN * 6 for i in range(SPEC_REQUESTS)]


def dense_paged_kwargs(
    *, max_seq=MAX_SEQ, dense_batch=DENSE_BATCH, block_size=BLOCK_SIZE, paged_batch=N_REQUESTS,
    cache_dtype=torch.bfloat16, eos_token=1, device="cuda",
) -> tuple[dict, dict]:
    """Engine arguments of the two arms at the same cache bytes: the dense
    cache's ``dense_batch x max_seq`` positions sliced into blocks (the
    null block included) for a paged engine of ``paged_batch`` slots."""
    base = dict(max_seq=max_seq, cache_dtype=cache_dtype, eos_token=eos_token, device=device)
    dense = dict(base, max_batch=dense_batch, cache_kind="dense")
    paged = dict(
        base, max_batch=paged_batch, cache_kind="paged", block_size=block_size,
        num_blocks=dense_batch * max_seq // block_size, trace_capacity=65536,
    )
    return dense, paged


def closed_loop(
    cfg, params, *, device="cuda", cache_dtype=torch.bfloat16, eos_token=1, max_seq=MAX_SEQ,
    dense_batch=DENSE_BATCH, block_size=BLOCK_SIZE, paged_batch=N_REQUESTS, prompts=None, max_new=MAX_NEW,
    shared=None, shared_batch=SHARED_BATCH, shared_budget=SHARED_BUDGET, shared_max_new=SHARED_MAX_NEW,
    spec=None, spec_k=SPEC_K, spec_max_new=SPEC_MAX_NEW, trace_out=None,
) -> dict:
    """The closed-loop arms of ``run``, unchecked: arm name -> ``drive``
    stats (``dense``, ``paged``, ``prefix_uncached``, ``prefix_cached``,
    ``spec_off``, ``spec_ngram``, ``spec_draft``).  ``prompts``,
    ``shared`` and ``spec`` default to the reference's workloads."""
    prompts = prompts if prompts is not None else default_prompts()
    shared = shared if shared is not None else shared_prefix_prompts()
    spec = spec if spec is not None else spec_prompts()
    dense_kw, paged_kw = dense_paged_kwargs(
        max_seq=max_seq, dense_batch=dense_batch, block_size=block_size, paged_batch=paged_batch,
        cache_dtype=cache_dtype, eos_token=eos_token, device=device,
    )
    arms = {"dense": drive(InferenceEngine(cfg, params, **dense_kw), prompts, max_new=max_new)}
    paged = InferenceEngine(cfg, params, **paged_kw)
    arms["paged"] = drive(paged, prompts, max_new=max_new)
    if trace_out:
        Path(trace_out).parent.mkdir(parents=True, exist_ok=True)
        paged.tracer.write(trace_out)
    base = dict(
        max_batch=shared_batch, max_seq=max_seq, cache_kind="paged", block_size=block_size,
        cache_dtype=cache_dtype, eos_token=eos_token, device=device,
    )
    for label, on in (("uncached", False), ("cached", True)):
        eng = InferenceEngine(cfg, params, prefix_cache=on, prefill_budget=shared_budget, **base)
        arms[f"prefix_{label}"] = drive(eng, shared, max_new=shared_max_new)
    for label, kw in (
        ("off", {}),
        ("ngram", dict(spec_decode="ngram", spec_k=spec_k)),
        ("draft", dict(spec_decode="draft", spec_k=spec_k, draft_cfg=cfg, draft_params=params)),
    ):
        arms[f"spec_{label}"] = drive(InferenceEngine(cfg, params, **base, **kw), spec, max_new=spec_max_new)
    return arms


def check_closed_loop(arms: dict) -> None:
    """The reference's assertions on ``closed_loop``'s arms."""
    ds, ps = arms["dense"], arms["paged"]
    _check(ps["cache_bytes"] <= ds["cache_bytes"], "paged budget drifted above dense")
    for label in ("ngram", "draft"):
        s = arms[f"spec_{label}"]
        _check(
            s["accepted_per_step"] > 1.0,
            f"speculative ({label}) must emit > 1 token per slot-step on the repetitive-suffix workload: "
            f"{s['accepted_per_step']:.2f}",
        )
        _check(
            s["decode_steps"] < arms["spec_off"]["decode_steps"],
            f"speculative ({label}) must take fewer decode steps than baseline",
        )
    cached, uncached = arms["prefix_cached"], arms["prefix_uncached"]
    _check(
        cached["prefill_tokens"] * 2 <= uncached["prefill_tokens"],
        f"prefix cache must save >= 2x prefill compute on the shared-prompt mix: "
        f"{cached['prefill_tokens']} vs {uncached['prefill_tokens']}",
    )
    _check(cached["prefix_hit_rate"] > 0, "shared-prefix workload produced no hits")


def _write(out, name: str, rows: list[dict]) -> None:
    out = Path(out)
    out.mkdir(parents=True, exist_ok=True)
    (out / name).write_text(json.dumps(rows, indent=1))


def roofline_row() -> dict | None:
    """The full 12B model's decode step at 32k from the one-card dry run
    (``repro_torch.launch.dryrun``'s ``dryrun_h100.json`` in
    ``launch.roofline.RESULTS_DIR``), when it holds the
    ``mistral-nemo-12b|decode_32k`` cell: its bound, the larger roofline
    term, and the tokens/s of a 128-request batch at that bound."""
    from repro_torch.launch import roofline

    rec = roofline.load(roofline.RESULTS_DIR).get("mistral-nemo-12b|decode_32k")
    if not rec or rec.get("status") != "run":
        return None
    bound = max(rec["roofline"].values())
    return {"name": "llm_inference_12b_decode32k_roofline", "us_per_call": bound * 1e6,
            "derived": f"batch128 -> {128 / bound:.0f} tok/s/card, dominant={rec['dominant']}",
            "time_base": "roofline bound, one H100 (launch.dryrun, not measured)"}


def run(cfg=None, params=None, *, device="cuda", out=OUT_DIR, trace_out=None, **sizes) -> list[dict]:
    """Paged against dense at equal cache bytes, the shared-prompt A/B and
    speculative decoding (``closed_loop``, whose sizes ``sizes`` may set),
    checked as the reference checks them.  One row per arm; every row
    carries its arm's stats and the device its wall clock is.  Where the
    dry run costed the full 12B model's 32k decode step, its roofline row
    follows (``roofline_row``)."""
    device = resolve_device(device)
    if cfg is None:
        cfg, params = default_model(device)
    arms = closed_loop(cfg, params, device=device, trace_out=trace_out, **sizes)
    check_closed_loop(arms)
    on = _device_name(device)
    rows = []
    for label in ("dense", "paged"):
        s = arms[label]
        derived = f"tok/s={s['tok_per_s']:.1f} peak_concurrent={s['peak_active']} cache_bytes={s['cache_bytes']}"
        if label == "paged":
            derived += (
                f" peak_blocks={s['alloc_peak_in_use']}/{s['alloc_capacity']}"
                f" ttft_p50_ms={s['ttft_p50_s'] * 1e3:.1f} ttft_p99_ms={s['ttft_p99_s'] * 1e3:.1f}"
            )
        rows.append({"name": f"llm_inference_{label}", "us_per_call": s["wall_s"] / max(s["decode_steps"], 1) * 1e6,
                     "derived": derived, **s})
    for label in ("uncached", "cached"):
        s = arms[f"prefix_{label}"]
        rows.append({
            "name": f"llm_inference_prefix_{label}", "us_per_call": (s["mean_ttft_s"] or 0.0) * 1e6,
            "derived": (
                f"mean_ttft_ms={(s['mean_ttft_s'] or 0.0) * 1e3:.1f} prefill_tokens={s['prefill_tokens']} "
                f"hit_rate={s.get('prefix_hit_rate', 0.0):.2f}"
            ),
            **s,
        })
    for label in ("off", "ngram", "draft"):
        s = arms[f"spec_{label}"]
        rows.append({
            "name": f"llm_inference_spec_{label}", "us_per_call": s["wall_s"] / max(s["decode_steps"], 1) * 1e6,
            "derived": (
                f"steps={s['decode_steps']} tok={s['tokens_out']} "
                f"accepted_per_step={s.get('accepted_per_step', 1.0):.2f} "
                f"acceptance_rate={s.get('acceptance_rate', 0.0):.2f}"
            ),
            **s,
        })
    for r in rows:
        r["time_base"] = f"wall clock, {on}"
    derived_row = roofline_row()
    if derived_row:
        rows.append(derived_row)
    _write(out, "llm_inference.json", rows)
    return rows


# ---- open-loop SLO scheduling A/B -----------------------------------------
OPENLOOP_QPS = 6.0
OPENLOOP_REQUESTS = 24  # every 4th is high-priority interactive
OPENLOOP_SEED = 7
LOW_PROMPT, LOW_MAX_NEW = 24, 20  # 3 blocks of 16 at worst case
HI_PROMPT, HI_MAX_NEW = 6, 6  # 1 block
HI_DEADLINE_S = 0.25  # TTFT target for the interactive class
OPENLOOP_NUM_BLOCKS = 13  # four low-priority completions exhaust the pool
OPENLOOP_BUDGET = 16
# virtual per-step cost model: fixed dispatch overhead + per-token compute
# (prefill chunk tokens, decode tokens and verify windows all count)
STEP_OVERHEAD_S = 0.020
TOKEN_COST_S = 0.001


def openloop_arrivals() -> list[tuple[float, bool]]:
    """One Poisson arrival trace shared by both policy arms: (time, is_hi)."""
    rng = random.Random(OPENLOOP_SEED)
    t, out = 0.0, []
    for i in range(OPENLOOP_REQUESTS):
        t += rng.expovariate(OPENLOOP_QPS)
        out.append((t, i % 4 == 3))
    return out


def drive_openloop(eng, clock: ManualClock, arrivals) -> dict:
    """Submit on the arrival trace and step on virtual time: the clock
    advances by the step cost model after every ``step()`` and jumps to the
    next arrival when the engine idles, so queueing delay lands in every
    TTFT."""
    pending = deque(arrivals)
    rng = random.Random(OPENLOOP_SEED + 1)
    reqs = []
    while pending or eng.has_work:
        while pending and pending[0][0] <= clock.now:
            _, is_hi = pending.popleft()
            prompt = [rng.randrange(2, 200) for _ in range(HI_PROMPT if is_hi else LOW_PROMPT)]
            reqs.append(eng.submit(
                prompt, max_new_tokens=HI_MAX_NEW if is_hi else LOW_MAX_NEW, priority=2 if is_hi else 0,
                deadline_s=HI_DEADLINE_S if is_hi else None,
            ))
        if not eng.has_work:
            clock.advance(max(pending[0][0] - clock.now, 0.0))
            continue
        # dispatch overhead lands before the step so a first token emitted
        # inside it carries a non-zero TTFT; per-token compute lands after
        clock.advance(STEP_OVERHEAD_S)
        fed0 = eng.prefill_tokens + eng.verify_tokens
        produced = eng.step()
        fed = eng.prefill_tokens + eng.verify_tokens - fed0
        clock.advance(TOKEN_COST_S * (produced + fed))
    s = eng.stats()
    s["makespan_s"] = clock.now
    s["qps_sustained"] = len(reqs) / clock.now
    _percentiles(eng, s)
    hi_ttfts = [r.ttft for r in reqs if r.priority > 0 and r.ttft is not None]
    s["high_priority_ttft_p99_s"] = float(np.percentile(hi_ttfts, 99))
    s["high_priority_ttft_p50_s"] = float(np.percentile(hi_ttfts, 50))
    s["ttfts"] = [r.ttft for r in reqs]
    s["tokens"] = [list(r.generated) for r in reqs]
    return s


def run_openloop(cfg=None, params=None, *, device="cuda", out=OUT_DIR, max_seq=MAX_SEQ,
                 block_size=BLOCK_SIZE) -> list[dict]:
    """SLO against FCFS on one Poisson arrival trace at equal offered QPS."""
    device = resolve_device(device)
    if cfg is None:
        cfg, params = default_model(device)
    arrivals = openloop_arrivals()
    rows, by_policy = [], {}
    for policy in ("slo", "fcfs"):
        clock = ManualClock()
        eng = InferenceEngine(
            cfg, params, max_batch=4, max_seq=max_seq, cache_kind="paged", block_size=block_size,
            num_blocks=OPENLOOP_NUM_BLOCKS, prefix_cache=True, prefill_budget=OPENLOOP_BUDGET, policy=policy,
            clock=clock, device=device,
        )
        s = by_policy[policy] = drive_openloop(eng, clock, arrivals)
        rows.append({
            "name": f"llm_inference_openloop_{policy}", "policy": policy, "qps_offered": OPENLOOP_QPS,
            "us_per_call": s["high_priority_ttft_p99_s"] * 1e6, "time_base": MODELLED,
            "derived": (
                f"hi_p99_ttft_ms={s['high_priority_ttft_p99_s'] * 1e3:.1f} preemptions={s['preemptions']} "
                f"deadline_miss={s['deadline_violations']} aborted={s['requests_aborted']} "
                f"qps={s['qps_sustained']:.2f}"
            ),
            **s,
        })
    slo, fcfs = by_policy["slo"], by_policy["fcfs"]
    _check(slo["requests_done"] == fcfs["requests_done"] == OPENLOOP_REQUESTS, "requests lost")
    _check(slo["preemptions"] >= 1, "tight pool must force at least one preemption")
    _check(fcfs["preemptions"] == 0, "fcfs must never preempt")
    _check(
        slo["high_priority_ttft_p99_s"] < fcfs["high_priority_ttft_p99_s"],
        f"SLO scheduling must beat FCFS on high-priority p99 TTFT at equal offered QPS: "
        f"{slo['high_priority_ttft_p99_s']:.3f}s vs {fcfs['high_priority_ttft_p99_s']:.3f}s",
    )
    _check(slo["deadline_violations"] <= fcfs["deadline_violations"], "SLO missed more deadlines than FCFS")
    _check(slo["requests_aborted"] == 0, "SLO arm must serve every request in time")
    _check(fcfs["requests_aborted"] >= 1, "FCFS must shed hopeless deadline requests")
    _write(out, "llm_inference_openloop.json", rows)
    return rows


# ---- tiered KV cache: drop-on-evict vs host-RAM spill ----------------------
SPILL_GROUPS = 8
SPILL_ROUNDS = 2
SPILL_MAX_NEW = 8
SPILL_NUM_BLOCKS = 12  # 11 usable: ~1.5 requests' working set, constant eviction
SPILL_BYTES = 64 << 20
# restoring one spilled block is cheaper than recomputing its 16 tokens
# (16 * TOKEN_COST_S) but not free
RESTORE_COST_S = 0.004


def spill_prompts() -> list[list[int]]:
    """SPILL_GROUPS tenants, each with a distinct 48-token system prompt (3
    full blocks) plus a 4-token unique tail: together ~3x the pool, so every
    chain is evicted before its tenant returns."""
    prompts = []
    for g in range(SPILL_GROUPS):
        system = [(11 * g + 3 * j + 5) % 193 + 2 for j in range(SYSTEM_PROMPT_LEN)]
        prompts.append(system + [198 + g * UNIQUE_TAIL + k for k in range(UNIQUE_TAIL)])
    return prompts


def drive_spill(eng, clock: ManualClock) -> tuple[dict, list]:
    """Sequential submit and drain per request on virtual time, SPILL_ROUNDS
    passes over the tenants: round 2 finds round 1's chains evicted,
    prefilled again (drop) or swapped back from host memory (spill).  Step
    cost: dispatch overhead + per-token compute + per-block restore."""
    toks, ttfts = [], []
    for _ in range(SPILL_ROUNDS):
        for p in spill_prompts():
            r = eng.submit(list(p), max_new_tokens=SPILL_MAX_NEW)
            while eng.has_work:
                clock.advance(STEP_OVERHEAD_S)
                fed0 = eng.prefill_tokens + eng.verify_tokens
                restored0 = eng.restores
                produced = eng.step()
                fed = eng.prefill_tokens + eng.verify_tokens - fed0
                clock.advance(TOKEN_COST_S * (produced + fed) + RESTORE_COST_S * (eng.restores - restored0))
            toks.append(list(r.generated))
            ttfts.append(r.ttft)
    s = eng.stats()
    s["mean_ttft_s"] = float(np.mean(ttfts))
    s["ttfts"] = ttfts
    return s, toks


def run_spill(cfg=None, params=None, *, device="cuda", out=OUT_DIR, max_seq=MAX_SEQ,
              block_size=BLOCK_SIZE) -> list[dict]:
    """Drop-on-evict against the host spill tier on an over-committed pool:
    the spill arm must win hit rate and mean TTFT with equal tokens."""
    device = resolve_device(device)
    if cfg is None:
        cfg, params = default_model(device)
    arms, toks = {}, {}
    for label, spill_bytes in (("drop", 0), ("spill", SPILL_BYTES)):
        clock = ManualClock()
        eng = InferenceEngine(
            cfg, params, max_batch=2, max_seq=max_seq, cache_kind="paged", block_size=block_size,
            num_blocks=SPILL_NUM_BLOCKS, prefix_cache=True, prefill_budget=16, spill_bytes=spill_bytes, clock=clock,
            device=device,
        )
        arms[label], toks[label] = drive_spill(eng, clock)
    drop, spill = arms["drop"], arms["spill"]
    _check(toks["spill"] == toks["drop"], "spill tier changed greedy outputs")
    _check(drop["alloc_evictions_dropped"] > 0, "pool never overflowed; no A/B")
    _check(spill["alloc_evictions_spilled"] > 0 and spill["restores"] > 0, "the spill arm never spilled or restored")
    _check(
        spill["prefix_hit_rate"] > drop["prefix_hit_rate"],
        f"spill tier must lift the hit rate on the returning-tenant mix: "
        f"{spill['prefix_hit_rate']:.2f} vs {drop['prefix_hit_rate']:.2f}",
    )
    _check(
        spill["mean_ttft_s"] < drop["mean_ttft_s"],
        f"restoring from host RAM must beat re-prefill on mean TTFT: "
        f"{spill['mean_ttft_s']:.3f}s vs {drop['mean_ttft_s']:.3f}s",
    )
    _check(spill["prefill_tokens"] < drop["prefill_tokens"], "the spill arm prefilled no fewer tokens")
    rows = []
    for label in ("drop", "spill"):
        s = arms[label]
        rows.append({
            "name": f"llm_inference_tiered_{label}", "us_per_call": s["mean_ttft_s"] * 1e6, "time_base": MODELLED,
            "tokens_match": toks[label] == toks["drop"], "tokens": toks[label],
            "derived": (
                f"mean_ttft_ms={s['mean_ttft_s'] * 1e3:.1f} hit_rate={s.get('prefix_hit_rate', 0.0):.2f} "
                f"prefill_tokens={s['prefill_tokens']} restores={s.get('restores', 0)}"
            ),
            **s,
        })
    _write(out, "llm_inference_spill.json", rows)
    return rows


# ---- multi-replica router: affinity, scaling, failover --------------------
ROUTER_TENANTS = 8
ROUTER_PER_TENANT = 2
ROUTER_MAX_NEW = 12
ROUTER_BUDGET = 16
ROUTER_SCALING = 1.3  # modelled tok/s of 2 replicas over 1, at least
ROUTER_HIT_SLACK = 0.10  # affinity keeps the hit rate within this of 1 replica's


def tenant_prompts(tenants: int = ROUTER_TENANTS, per_tenant: int = ROUTER_PER_TENANT,
                   system_len: int = SYSTEM_PROMPT_LEN, tail: int = UNIQUE_TAIL) -> list[list[int]]:
    """``tenants`` families, each sharing a distinct ``system_len``-token
    system prompt (3 full blocks at the reference's sizes), interleaved in
    submission order: affinity keeps a family on one replica, where its
    prefix blocks are, and random placement splits it and prefills the
    family's prompt on every replica it lands on.  Tails stay under 256,
    the smoke vocab, at the reference's sizes."""
    prompts = []
    for i in range(per_tenant):
        for t in range(tenants):
            system = [(13 * t + 5 * j + 7) % 197 + 2 for j in range(system_len)]
            prompts.append(system + [192 + (t * per_tenant + i) * tail + k for k in range(tail)])
    return prompts


def make_router(cfg, params, n: int, *, clock, policy: str = "affinity", fault_plans=None, router_cls=Router,
                max_batch: int = 4, max_seq: int = MAX_SEQ, block_size: int = BLOCK_SIZE,
                prefill_budget: int = ROUTER_BUDGET, **engine_kw):
    """``n`` paged engines with the prefix cache, each a ``Replica`` on
    ``clock`` under its fault plan, behind a ``router_cls`` router.  The
    engines share ``params``."""
    replicas = [
        Replica(i, InferenceEngine(cfg, params, max_batch=max_batch, max_seq=max_seq, cache_kind="paged",
                                   block_size=block_size, prefix_cache=True, prefill_budget=prefill_budget,
                                   clock=clock, **engine_kw),
                clock=clock, fault_plan=(fault_plans or {}).get(i))
        for i in range(n)
    ]
    return router_cls(replicas, policy=policy, clock=clock)


def _replica_work(eng) -> int:
    return eng.prefill_tokens + eng.verify_tokens + eng.tokens_out


def drive_router(router, clock: ManualClock, prompts, *, max_new: int = ROUTER_MAX_NEW) -> tuple[dict, list]:
    """Closed-loop fleet drain on virtual time.  Replicas run in parallel in
    a deployment, so a fleet round costs the *slowest* replica's step: the
    fixed step overhead plus the per-token cost of the largest replica work
    that round.  Also reads the wall clock around the drain: on one card
    the replicas step in turns, so the wall is the sum of their steps."""
    reqs = [router.submit(list(p), max_new_tokens=max_new) for p in prompts]
    device = router.replicas[0].engine.device
    t0 = time.perf_counter()
    while router.has_work:
        before = {rep.id: _replica_work(rep.engine) for rep in router.replicas}
        router.step()
        deltas = [_replica_work(rep.engine) - before[rep.id] for rep in router.replicas]
        clock.advance(STEP_OVERHEAD_S + TOKEN_COST_S * max(deltas, default=0))
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    wall = time.perf_counter() - t0
    s = router.stats()
    s["makespan_s"] = clock.now
    s["tok_per_s"] = s["tokens_out"] / clock.now if clock.now else 0.0
    s["wall_s"] = wall
    s["wall_tok_per_s"] = s["tokens_out"] / wall
    return s, [list(r.generated) for r in reqs]


def run_router(cfg=None, params=None, *, device="cuda", out=OUT_DIR, prompts=None, max_new: int = ROUTER_MAX_NEW,
               same_tokens=None, **engine_kw) -> list[dict]:
    """Router A/B on the tenant workload: 1 replica; 2 with affinity routing
    (modelled tok/s above ``ROUTER_SCALING`` x 1 replica's, hit rate within
    ``ROUTER_HIT_SLACK``); 2 with random routing (affinity must beat its hit
    rate); 2 with replica 0 crashed halfway through the steps it ran in the
    affinity arm (no request lost, at least one failover, replica 0 dead).
    Every arm's tokens must equal the single replica's by ``same_tokens``
    (``same_tokens(tokens, reference) -> bool``; equality by default).
    ``prompts`` default to ``tenant_prompts()``; ``engine_kw`` reach every
    engine (``make_router``'s sizes, ``fused``, ``cache_dtype``,
    ``eos_token``, ...).  The modelled numbers (``tok_per_s``,
    ``makespan_s``) come from ``drive_router``'s virtual clock, as in the
    reference; ``wall_s`` and ``wall_tok_per_s`` are the device's wall
    clock, where two replicas step in turns: no scaling is claimed from
    them.  On the card each arm's fleet is freed after it ran, and its row
    reads the arm's peak memory."""
    device = resolve_device(device)
    if cfg is None:
        cfg, params = default_model(device)
    prompts = prompts if prompts is not None else tenant_prompts()
    same = same_tokens if same_tokens is not None else (lambda toks, ref: toks == ref)
    n_req = len(prompts)

    def arm(n, policy="affinity", fault_plans=None):
        gc.collect()  # what an earlier engine left in cycles
        if device.type == "cuda":
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats(device)
        clock = ManualClock()
        router = make_router(cfg, params, n, clock=clock, policy=policy, fault_plans=fault_plans, device=device,
                             **engine_kw)
        s, toks = drive_router(router, clock, prompts, max_new=max_new)
        s["replica_steps"] = {rep.id: rep.steps for rep in router.replicas}
        s["replica_launches"] = {rep.id: dict(rep.launches) for rep in router.replicas}  # eager calls
        del router
        gc.collect()  # the engines' hooks and graphs hold cycles
        if device.type == "cuda":
            s["peak_mem_bytes"] = torch.cuda.max_memory_allocated(device)
            torch.cuda.empty_cache()
        return s, toks

    single, single_toks = arm(1)
    aff, aff_toks = arm(2)
    rnd, rnd_toks = arm(2, policy="random")
    # kill replica 0 halfway through the steps it ran in the healthy
    # affinity run: requests are mid-flight there when it dies
    crash_at = max(aff["replica_steps"][0] // 2, 1)
    fo, fo_toks = arm(2, fault_plans={0: FaultPlan(crash_at_step=crash_at)})

    _check(same(aff_toks, single_toks) and same(rnd_toks, single_toks), "replica placement changed greedy outputs")
    _check(
        fo["requests_done"] == n_req and fo["requests_failed"] == 0,
        f"lost requests after replica kill: done={fo['requests_done']}/{n_req} failed={fo['requests_failed']}",
    )
    _check(fo["failovers"] >= 1, "the kill must have forced at least one failover")
    _check(fo["replica_states"][0] == "dead", f"replica 0 is {fo['replica_states'][0]} after its crash")
    _check(same(fo_toks, single_toks), "failover changed greedy outputs vs no-failure run")
    _check(
        aff["tok_per_s"] > ROUTER_SCALING * single["tok_per_s"],
        f"2 replicas must scale modelled aggregate decode: {aff['tok_per_s']:.1f} vs {single['tok_per_s']:.1f} tok/s",
    )
    _check(
        aff["prefix_hit_rate"] >= single["prefix_hit_rate"] - ROUTER_HIT_SLACK,
        f"affinity routing lost the prefix cache: hit rate {aff['prefix_hit_rate']:.2f} vs "
        f"{single['prefix_hit_rate']:.2f} on 1 replica",
    )
    _check(
        aff["prefix_hit_rate"] > rnd["prefix_hit_rate"],
        f"affinity must beat random placement on hit rate: {aff['prefix_hit_rate']:.2f} vs "
        f"{rnd['prefix_hit_rate']:.2f}",
    )

    on = _device_name(device)
    rows = []
    for name, s, toks in (("single", single, single_toks), ("affinity", aff, aff_toks), ("random", rnd, rnd_toks),
                          ("failover", fo, fo_toks)):
        rows.append({
            "name": f"llm_inference_router_{name}", "us_per_call": s["makespan_s"] / max(s["requests_done"], 1) * 1e6,
            "time_base": f"tok_per_s, makespan_s: {MODELLED}; wall_s, wall_tok_per_s: wall clock, {on}",
            "policy": s["routing_policy"], "crash_at_step": crash_at if name == "failover" else None,
            "tokens_match_single": toks == single_toks, "tokens": toks,
            "derived": (
                f"tok/s={s['tok_per_s']:.1f} wall_tok/s={s['wall_tok_per_s']:.1f} hit={s['prefix_hit_rate']:.2f} "
                f"failovers={s['failovers']:.0f} done={s['requests_done']}/{n_req}"
            ),
            **s,
        })
    rows[1]["speedup_vs_single"] = aff["tok_per_s"] / single["tok_per_s"]
    _write(out, "llm_inference_router.json", rows)
    return rows


# ---- fused one-dispatch step A/B ------------------------------------------
# per-host-round-trip overhead of the modelled step latency: the launch and
# host-sync cost the fused step removes
DISPATCH_OVERHEAD_S = 0.002


def fused_arm(cfg, params, prompts, *, fused: bool, **engine_kw) -> dict:
    """One arm of ``run_fused``: a warm-up round of ``prompts`` (which
    captures every graph the timed round uses on the card), then a timed
    round of the same prompts."""
    eng = InferenceEngine(cfg, params, fused=fused, **engine_kw)
    for p in prompts:
        eng.submit(p, max_new_tokens=SHARED_MAX_NEW)
    eng.run_until_drained()
    d0, y0, s0 = eng.dispatches_total, eng.host_syncs_total, eng.steps
    w0 = eng.prefill_tokens + eng.verify_tokens
    reqs = [eng.submit(p, max_new_tokens=SHARED_MAX_NEW) for p in prompts]
    t0 = time.perf_counter()
    eng.run_until_drained()
    if eng.device.type == "cuda":
        torch.cuda.synchronize(eng.device)
    wall = time.perf_counter() - t0
    steps = eng.steps - s0
    toks = sum(len(r.generated) for r in reqs)
    fed = eng.prefill_tokens + eng.verify_tokens - w0
    disp = eng.dispatches_total - d0
    syncs = eng.host_syncs_total - y0
    return {
        "wall_step_s": wall / max(steps, 1),
        "model_step_s": (DISPATCH_OVERHEAD_S * disp + TOKEN_COST_S * (toks + fed)) / max(steps, 1),
        "dispatches_per_token": disp / max(toks, 1),
        "host_syncs_per_token": syncs / max(toks, 1),
        "dispatches_per_step": disp / max(steps, 1),
        "decode_steps": steps,
        "tokens_out": toks,
        "tokens": [list(r.generated) for r in reqs],
    }


def run_fused(cfg=None, params=None, *, device="cuda", out=OUT_DIR, max_seq=MAX_SEQ,
              block_size=BLOCK_SIZE) -> list[dict]:
    """The legacy walk against the fused one-dispatch step on the
    shared-prompt workload: equal greedy tokens, fewer dispatches and host
    syncs per token, and a lower modelled step latency."""
    device = resolve_device(device)
    if cfg is None:
        cfg, params = default_model(device)
    kw = dict(max_batch=SHARED_BATCH, max_seq=max_seq, cache_kind="paged", block_size=block_size, prefix_cache=True,
              prefill_budget=SHARED_BUDGET, device=device)
    arms = {label: fused_arm(cfg, params, shared_prefix_prompts(), fused=fused, **kw)
            for label, fused in (("legacy", False), ("fused", True))}
    fs, ls = arms["fused"], arms["legacy"]
    _check(fs["tokens"] == ls["tokens"], "fused step changed greedy tokens")
    _check(
        fs["dispatches_per_token"] < ls["dispatches_per_token"],
        f"fused must dispatch less per decoded token: "
        f"{fs['dispatches_per_token']:.3f} vs {ls['dispatches_per_token']:.3f}",
    )
    _check(fs["host_syncs_per_token"] <= ls["host_syncs_per_token"], "fused syncs more per token")
    _check(
        fs["model_step_s"] < ls["model_step_s"],
        f"fused must lower modelled per-step latency: {fs['model_step_s']:.4f} vs {ls['model_step_s']:.4f}",
    )
    on = _device_name(device)
    rows = [{
        "name": f"llm_inference_{label}_step", "us_per_call": a["wall_step_s"] * 1e6,
        "time_base": f"wall_step_s: wall clock, {on}; model_step_s: {MODELLED}",
        "derived": (
            f"model_step_ms={a['model_step_s'] * 1e3:.2f} disp/tok={a['dispatches_per_token']:.3f} "
            f"syncs/tok={a['host_syncs_per_token']:.3f}"
        ),
        **a,
    } for label, a in arms.items()]
    _write(out, "llm_inference_fused.json", rows)
    return rows


def drive_tp(cfg, params, prompts, mesh=None, device="cuda") -> tuple[list, dict]:
    """One arm of ``run_tp`` on the reference's engine (the prefix cache, a
    prefill budget of 32, n-gram drafting): (tokens, stats with
    ``wall_s``); under a mesh rank 0 drives and releases the followers,
    which return (None, stats)."""
    eng = InferenceEngine(cfg, params, mesh=mesh, max_batch=4, max_seq=MAX_SEQ, cache_kind="paged",
                          block_size=BLOCK_SIZE, prefix_cache=True, prefill_budget=32, spec_decode="ngram",
                          spec_k=SPEC_K, device=resolve_device(device))
    if eng.rank != 0:
        eng.follow()
        return None, eng.stats()
    t0 = time.perf_counter()
    reqs = [eng.submit(p, max_new_tokens=MAX_NEW) for p in prompts]
    eng.run_until_drained()
    if eng.device.type == "cuda":
        torch.cuda.synchronize(eng.device)
    s = eng.stats()
    s["wall_s"] = time.perf_counter() - t0
    eng.stop_followers()
    return [list(r.generated) for r in reqs], s


def _tp_rank(rank, mesh, cfg, params, prompts, device):
    """A rank of ``run_tp``: the parent's CPU weights, or seed 0's drawn on
    the rank's device."""
    dev = resolve_device(device)
    params = init_params(cfg, 0, device=dev) if params is None else tree_map(lambda t: t.to(dev), params)
    return drive_tp(cfg, params, prompts, mesh, dev)


def run_tp(tp: int = 2, cfg=None, params=None, *, device="cuda", backend=None, out=OUT_DIR) -> list[dict]:
    """TP=``tp`` against TP=1 on the shared-prompt workload (the
    reference's ``run_tp``): greedy tokens and global cache bytes equal,
    each rank's pools its kv-head slice.  ``params`` (default: seed 0's
    draw, made again on each rank) go to the ranks through host memory."""
    device = resolve_device(device)
    if cfg is None:
        cfg = reduce_for_smoke(get_config("mistral-nemo-12b"))
    prompts = shared_prefix_prompts()[:8]
    base_params = init_params(cfg, 0, device=device) if params is None else tree_map(lambda t: t.to(device), params)
    base_toks, base_stats = drive_tp(cfg, base_params, prompts, device=device)
    del base_params
    host = None if params is None else tree_map(lambda t: t.cpu(), params)
    results = run_ranks(_tp_rank, tp, backend=backend, device=device, args=(cfg, host, prompts, str(device)))
    tp_toks, tp_stats = results[0]
    _check(tp_toks == base_toks, f"TP={tp} changed greedy tokens vs TP=1")
    _check(tp_stats["cache_bytes"] == base_stats["cache_bytes"], "global bytes drifted")
    on = _device_name(device)
    used = pick_backend(tp, backend, device)
    rows = [
        {
            "name": f"llm_inference_tp{n}_{device.type}",
            "us_per_call": s["wall_s"] / max(s["decode_steps"], 1) * 1e6,
            "tp": n,
            "tokens_equal": True,
            "tokens_out": s["tokens_out"],
            "cache_bytes": s["cache_bytes"],
            "cache_bytes_per_device": s.get("cache_bytes_per_device", s["cache_bytes"]),
            "prefix_hit_rate": s.get("prefix_hit_rate", 0.0),
            "accepted_per_step": s.get("accepted_per_step", 1.0),
            "kv_heads_per_rank": s.get("kv_heads_per_rank", cfg.num_kv_heads),
            "backend": used if n > 1 else None,
            "device": on,
            "time_base": f"wall clock of rank 0's drain, {on}" + (f", {used} collectives" if n > 1 else ""),
            "derived": (
                f"tok={s['tokens_out']} cache_bytes={s['cache_bytes']} "
                f"per_device={s.get('cache_bytes_per_device', s['cache_bytes'])}"
            ),
        }
        for n, s in ((1, base_stats), (tp, tp_stats))
    ]
    _write(out, "llm_inference_tp.json", rows)
    return rows


def main(argv=None) -> list[dict]:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default=str(OUT_DIR), help="directory of the JSON results")
    ap.add_argument("--trace-out", default=None, metavar="PATH",
                    help="write the paged run's request-lifecycle Chrome trace (closed-loop scenarios)")
    which = ap.add_mutually_exclusive_group()
    which.add_argument("--openloop", action="store_true", help="open-loop SLO vs FCFS on virtual time")
    which.add_argument("--spill", action="store_true", help="drop-on-evict vs the host spill tier on virtual time")
    which.add_argument("--fused", action="store_true", help="legacy walk vs the fused one-dispatch step")
    which.add_argument("--router", action="store_true",
                       help="1 replica vs 2 behind the router: affinity, random, a mid-run crash")
    which.add_argument("--tp", type=int, default=1,
                       help="the tensor-parallel A/B at this degree instead of the single-engine scenarios")
    ap.add_argument("--backend", default=None, choices=BACKENDS, help="process-group backend of --tp")
    args = ap.parse_args(argv)
    if args.tp > 1:
        rows = run_tp(args.tp, device=args.device, backend=args.backend, out=args.out)
    elif args.router:
        rows = run_router(device=args.device, out=args.out)
    elif args.fused:
        rows = run_fused(device=args.device, out=args.out)
    elif args.spill:
        rows = run_spill(device=args.device, out=args.out)
    elif args.openloop:
        rows = run_openloop(device=args.device, out=args.out)
    else:
        rows = run(device=args.device, out=args.out, trace_out=args.trace_out)
    for r in rows:
        print(f"{r['name']},{r['us_per_call']:.1f},{r['derived']},{r['time_base']}", flush=True)
    return rows


if __name__ == "__main__":
    main()
