"""Tensor-parallel paged serving of the port: TP=2 over two gloo ranks on
the CPU against TP=1 and against the JAX engine.

The cases mirror the JAX package's ``TP_CASES`` (``tests/test_sharded_serving.py``):
olmo-1b plain and with the prefix cache, chunked prefill and n-gram
speculative decoding; qwen3-moe at capacity factor 8; olmo-1b at window 8;
hymba-1.5b, whose 5 heads over 1 kv head do not divide the model axis, so
its attention stays replicated with a warning; each on both ``attn_impl``s
(the paged kernels' wrappers take their plain versions on the CPU), and once
with ``fused=True`` (eager on the CPU).  The two ranks run every case in one
spawn (``torch_tp_ranks.run_serving_cases``; the ranks import no JAX), each
from its ``shard_params`` slice of the bridged weights.  Each case checks:

* greedy tokens and finish reasons equal to the port's TP=1, to the JAX
  engine's (TP=1, ``eos_token`` outside the vocab) and between the ranks;
* one whole-prompt ``prefill_step``'s logits within 1e-5 of TP=1's,
  relative to the largest logit;
* each rank's pools at ``KV / 2`` heads (all of them for hymba), and the
  host block table after every step equal on both ranks and to TP=1's;
* ``cache_bytes()`` equal to TP=1's, ``cache_bytes(per_device=True)``
  carrying half the pool bytes; the allocator and prefix counters equal
  to TP=1's.

One more case runs ``policy="slo"`` with deadlines: rank 0 steps on a
manual clock, the follower's clock reads an hour ahead.  Its finish
reasons, deadline aborts included, equal TP=1's on rank 0's clock: the
decisions come from rank 0.  The Fig. 9 harness's ``--tp 2`` arm and the
serve launcher's ``--tp 2`` (offline, and ``--http`` with one request)
run once each.  Every case runs fp32 pools, so no near-tie can flip an
argmax.  Smoke rwkv6-7b (no attention, no pools) serves at TP=2 against
TP=1 in a test and a spawn of its own.
"""

import dataclasses
import json
import os
import signal
import subprocess
import sys
import time
import urllib.request
import warnings
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config.model import reduce_for_smoke as jax_reduce
from repro.configs import get_config as jax_get_config
from repro.models import init_params as jax_init_params
from repro.serving import InferenceEngine as JaxEngine
from repro_torch.bridge import params_from_jax
from repro_torch.config import reduce_for_smoke
from repro_torch.configs import get_config
from repro_torch.launch.mesh import free_port, run_ranks
from repro_torch.models import init_params
from repro_torch.serving import InferenceEngine

import torch_tp_ranks

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parents[1]
EOS_OUT = 1 << 30  # outside every vocab: requests run to their length
SHARED = [11, 12, 13, 14, 15, 16, 17, 18]
PROMPTS = [
    SHARED + [7, 3, 9, 4] * 3 + [5],
    SHARED + [5, 9, 12, 5, 9, 12, 2],
    SHARED + [21, 22, 23, 24],
    SHARED + [7, 3, 9, 4] * 3 + [5],  # repeat: a full prefix hit
]
SPEC = dict(spec_decode="ngram", spec_k=3, prefill_budget=8)

# (arch, window, attn_impl, engine options), the reference's TP_CASES on
# both of the port's attn_impls, and one fused case
CASES = [
    ("olmo-1b", 0, "kernel", {}),
    ("olmo-1b", 0, "plain", {}),
    ("olmo-1b", 0, "kernel", SPEC),
    ("olmo-1b", 0, "plain", SPEC),
    ("qwen3-moe-235b-a22b", 0, "kernel", SPEC),
    ("qwen3-moe-235b-a22b", 0, "plain", SPEC),
    ("olmo-1b", 8, "kernel", SPEC),
    ("olmo-1b", 8, "plain", dict(spec_decode="ngram", spec_k=3)),
    ("hymba-1.5b", 0, "kernel", {}),
    ("hymba-1.5b", 0, "plain", {}),
    ("olmo-1b", 0, "kernel", dict(fused=True, prefill_budget=8)),
]
IDS = [f"{a}-w{w}-{i}-{'+'.join(sorted(k)) or 'plain'}" for a, w, i, k in CASES]
# the SLO case: deadlines that rank 0's clock decides
SLO_SUBMIT = [dict(max_new_tokens=6), dict(max_new_tokens=6, deadline_s=0.5),
              dict(max_new_tokens=6, deadline_s=0.015), dict(max_new_tokens=6, priority=1, deadline_s=0.2)]
COUNTERS = ("prefill_tokens", "prefill_chunks", "evictions", "verify_tokens", "tokens_out")


def _bridged(arch, window):
    jcfg, tcfg = jax_reduce(jax_get_config(arch)), reduce_for_smoke(get_config(arch))
    if jcfg.moe is not None:  # capacity cannot bind
        jcfg = jcfg.replace(moe=dataclasses.replace(jcfg.moe, capacity_factor=8.0))
        tcfg = tcfg.replace(moe=dataclasses.replace(tcfg.moe, capacity_factor=8.0))
    if window:
        jcfg, tcfg = jcfg.replace(sliding_window=window), tcfg.replace(sliding_window=window)
    jparams = jax_init_params(jcfg, jax.random.PRNGKey(0), jnp.float32)
    return jcfg, tcfg, jparams, params_from_jax(tcfg, jax.tree.map(np.asarray, jparams), device="cpu")


def _jax_tokens(jcfg, jparams, kw) -> tuple[list, list]:
    kw = {k: v for k, v in kw.items() if k != "fused"}  # the walks' tokens agree
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        eng = JaxEngine(jcfg, jparams, max_batch=2, max_seq=64, block_size=8, cache_dtype=jnp.float32,
                        eos_token=EOS_OUT, **kw)
        reqs = [eng.submit(p, max_new_tokens=6) for p in PROMPTS]
        eng.run_until_drained()
    return [list(r.generated) for r in reqs], [r.finish_reason for r in reqs]


def _case(tcfg, tparams, impl, kw, *, submit=None, clock=None) -> dict:
    return {
        "cfg": tcfg, "params": tparams, "prompts": PROMPTS, "clock": clock,
        "submit": submit or [dict(max_new_tokens=6)] * len(PROMPTS),
        "engine": dict(max_batch=2, max_seq=64, block_size=8, cache_dtype=torch.float32, eos_token=EOS_OUT,
                       attn_impl=impl, **kw),
    }


@pytest.fixture(scope="module")
def runs():
    """TP=1 and JAX references in this process; every TP=2 case on two
    spawned ranks at once."""
    models, jax_refs, cases, refs = {}, {}, [], []
    for arch, window, impl, kw in CASES:
        if (arch, window) not in models:
            models[arch, window] = _bridged(arch, window)
        jcfg, tcfg, jparams, tparams = models[arch, window]
        jkey = (arch, window, tuple(sorted((k, v) for k, v in kw.items() if k != "fused")))
        if jkey not in jax_refs:
            jax_refs[jkey] = _jax_tokens(jcfg, jparams, kw)
        case = _case(tcfg, tparams, impl, kw)
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", RuntimeWarning)
            ref = torch_tp_ranks.serve(tcfg, tparams, case)
        ref["logits"] = torch_tp_ranks.prefill_logits(tcfg, tparams, PROMPTS[0])
        ref["jax"] = jax_refs[jkey]
        cases.append(case)
        refs.append(ref)
    _, tcfg, _, tparams = models["olmo-1b", 0]
    slo = _case(tcfg, tparams, "kernel", dict(policy="slo", prefill_budget=8), submit=SLO_SUBMIT, clock="slo")
    refs.append(torch_tp_ranks.serve(tcfg, tparams, slo))
    cases.append(slo)
    ranks = run_ranks(torch_tp_ranks.run_serving_cases, 2, device="cpu", args=(cases,), timeout_s=300)
    return refs, ranks


@pytest.mark.parametrize("i", range(len(CASES)), ids=IDS)
def test_tp2_equals_tp1_and_the_jax_engine(runs, i):
    refs, ranks = runs
    arch, window, impl, kw = CASES[i]
    ref, r0, r1 = refs[i], ranks[0][i], ranks[1][i]
    jax_tokens, jax_reasons = ref["jax"]
    assert ref["tokens"] == jax_tokens and ref["reasons"] == jax_reasons
    assert r0["tokens"] == ref["tokens"], f"{IDS[i]}: TP=2 changed greedy tokens"
    assert r1["tokens"] == r0["tokens"] and r1["reasons"] == r0["reasons"] == ref["reasons"]
    for r in (r0, r1):
        scale = float(np.abs(ref["logits"]).max())
        assert float(np.abs(r["logits"] - ref["logits"]).max()) <= 1e-5 * scale, IDS[i]
        np.testing.assert_array_equal(r["tables"], ref["tables"])
    cfg = reduce_for_smoke(get_config(arch))
    split = cfg.num_heads % 2 == 0 and cfg.num_kv_heads % 2 == 0
    kv = cfg.num_kv_heads // 2 if split else cfg.num_kv_heads
    pool = (cfg.num_layers, ref["pool_shapes"]["k"][1], 8, kv, cfg.head_dim)
    assert ref["pool_shapes"]["k"][3] == cfg.num_kv_heads
    sb, s0, s1 = ref["stats"], r0["stats"], r1["stats"]
    pool_bytes = 2 * int(np.prod(ref["pool_shapes"]["k"])) * 4
    for r, s in ((r0, s0), (r1, s1)):
        assert r["pool_shapes"] == {"k": pool, "v": pool}
        assert s["tp"] == 2 and s["kv_heads_per_rank"] == kv
        assert s["cache_bytes"] == sb["cache_bytes"]
        assert s["cache_bytes_per_device"] == sb["cache_bytes"] - (pool_bytes // 2 if split else 0)
        keys = [k for k in sb if k.startswith(("alloc_", "prefix_"))] + [k for k in COUNTERS if k in sb]
        assert {k: s[k] for k in keys} == {k: sb[k] for k in keys}, IDS[i]
    replicated = [w for w in r0["warnings"] if "head counts" in w]
    assert bool(replicated) == (not split), r0["warnings"]
    if kw.get("fused"):
        assert s0["fused"] and s0["dispatches_per_step"] <= sb["dispatches_per_step"]


def test_decisions_come_from_rank_0(runs):
    """Under ``policy="slo"`` with deadlines, the follower, whose clock
    reads an hour ahead, aborts exactly what rank 0's clock aborts."""
    refs, ranks = runs
    ref, r0, r1 = refs[-1], ranks[0][len(CASES)], ranks[1][len(CASES)]
    assert set(ref["reasons"]) >= {"length", "deadline_exceeded"}, ref["reasons"]
    assert r0["reasons"] == r1["reasons"] == ref["reasons"]
    assert r0["tokens"] == r1["tokens"] == ref["tokens"]
    np.testing.assert_array_equal(r1["tables"], ref["tables"])


def test_ranks_hold_slices_and_import_no_jax(runs):
    _, ranks = runs
    for r in ranks:
        assert r[-1] == {"jax_loaded": False}
    cfg = reduce_for_smoke(get_config("olmo-1b"))
    olmo = ranks[0][0]["local_shapes"]
    assert olmo["wq"] == (cfg.d_model, cfg.num_heads // 2, cfg.head_dim)
    assert olmo["tok"] == (cfg.padded_vocab // 2, cfg.d_model)


def test_fig9_tp_arm(tmp_path):
    """The harness's ``--tp 2`` arm on the CPU: it asserts equal tokens and
    global cache bytes itself."""
    from repro_torch.benchmarks.llm_inference import main

    rows = main(["--tp", "2", "--device", "cpu", "--out", str(tmp_path)])
    assert [r["name"] for r in rows] == ["llm_inference_tp1_cpu", "llm_inference_tp2_cpu"]
    one, two = rows
    assert two["backend"] == "gloo" and two["tokens_equal"] and two["tokens_out"] == one["tokens_out"]
    assert two["cache_bytes"] == one["cache_bytes"] and two["cache_bytes_per_device"] < one["cache_bytes"]
    assert json.loads((tmp_path / "llm_inference_tp.json").read_text())[1]["tp"] == 2


def test_serve_launcher_tp2():
    """``--tp 2`` drains the launcher's requests over two gloo ranks with
    TP=1's tokens count and global cache bytes."""
    from repro_torch.launch.serve import main

    argv = ["--device", "cpu", "--arch", "olmo-1b", "--requests", "3", "--max-new", "4"]
    one = main(argv)
    two = main(argv + ["--tp", "2"])
    assert two["tp"] == 2 and two["requests_done"] == 3
    assert two["tokens_out"] == one["tokens_out"] and two["cache_bytes"] == one["cache_bytes"]


def _get(url: str, data: bytes | None = None) -> str:
    req = urllib.request.Request(url, data=data, headers={"Content-Type": "application/json"} if data else {})
    with urllib.request.urlopen(req, timeout=30) as resp:
        return resp.read().decode()


def test_serve_launcher_tp2_http():
    """``--tp 2 --http`` serves one request from rank 0 and drains on
    SIGTERM, which the launcher forwards to rank 0; its tokens are the TP=1
    engine's on the same seed."""
    port = free_port()
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.serve", "--device", "cpu", "--arch", "olmo-1b", "--tp", "2",
         "--http", "--port", str(port)],
        cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
    )
    try:
        base = f"http://127.0.0.1:{port}"
        for _ in range(600):
            try:
                if _get(base + "/healthz"):
                    break
            except OSError:
                time.sleep(0.1)
        raw = _get(base + "/v1/generate", json.dumps({"prompt": [5, 9, 12, 7], "max_new_tokens": 5}).encode())
        proc.send_signal(signal.SIGTERM)
        out, _ = proc.communicate(timeout=120)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    assert proc.returncode == 0, out
    assert "drain complete" in out, out
    events = [json.loads(line[len("data: "):]) for line in raw.splitlines() if line.startswith("data: ")]
    tokens = [t for e in events for t in e.get("tokens", [])]
    cfg = reduce_for_smoke(get_config("olmo-1b"))
    eng = InferenceEngine(cfg, init_params(cfg, 0, device="cpu"), max_batch=4, max_seq=256, block_size=16,
                          device="cpu")
    req = eng.submit([5, 9, 12, 7], max_new_tokens=5)
    eng.run_until_drained()
    assert tokens == req.generated, (raw, out)


def test_tp2_serving_of_the_ssm_family():
    """Smoke rwkv6-7b (the seed's weights) on two gloo ranks: its channel
    mix splits its hidden dim and sums ``kv`` once, its time mix runs
    whole; greedy tokens and finish reasons equal TP=1's on both ranks, one
    prefill's logits within 1e-5 of TP=1's, relative to the largest logit."""
    cfg = reduce_for_smoke(get_config("rwkv6-7b"))
    params = init_params(cfg, 0, "cpu")
    prompts = [[11, 12, 13, 14, 7, 3, 9, 4, 5], [5, 9, 12, 5, 9, 12, 2], [21, 22, 23, 24]]
    case = {"cfg": cfg, "params": params, "prompts": prompts, "clock": None,
            "submit": [dict(max_new_tokens=6)] * len(prompts),
            "engine": dict(max_batch=2, max_seq=64, block_size=8, cache_dtype=torch.float32, eos_token=1 << 30)}
    ref = torch_tp_ranks.serve(cfg, params, case)
    logits = torch_tp_ranks.prefill_logits(cfg, params, prompts[0])
    ranks = run_ranks(torch_tp_ranks.run_serving_cases, 2, device="cpu", args=([case],), timeout_s=300)
    r0, r1 = ranks[0][0], ranks[1][0]
    assert r0["local_shapes"]["tok"][0] == cfg.vocab_size // 2  # the vocab split, as every family's
    for r in (r0, r1):
        assert r["tokens"] == ref["tokens"] and r["reasons"] == ref["reasons"]
        assert float(np.abs(r["logits"] - logits).max()) <= 1e-5 * float(np.abs(logits).max())
