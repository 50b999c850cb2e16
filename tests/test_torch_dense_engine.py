"""The port's ``cache_kind="dense"`` engine against the JAX engine's.

Same weights (``bridge.params_from_jax``), same prompts: greedy tokens,
finish reasons, every integer stat and ``cache_bytes`` equal to the JAX
dense engine's, on smoke olmo-1b (fp32 and bf16 caches, an ``eos_token``
outside the vocab and one these weights emit), gemma-7b and olmo-1b with a
sliding window that the prompts outrun (the ring wraps), and the moe
family's qwen3-moe and arctic at capacity factor 8 (the bucketed prompt's
pad positions are routed, and no pair can be dropped).  The dense walk
against the port's paged walk token for token at fp32, as the JAX
package's ``tests/test_paged.py`` holds its two layouts; the same byte
budget admits more concurrency paged.  The dense walk's refusals and
warnings, the oversized-request rejection, abort and deadline.
"""

import dataclasses
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config.model import reduce_for_smoke as jax_reduce
from repro.configs import get_config as jax_get_config
from repro.models import init_params as jax_init_params
from repro.serving import InferenceEngine as JaxEngine
from repro.serving import ManualClock as JaxClock
from repro_torch.bridge import params_from_jax
from repro_torch.config import reduce_for_smoke
from repro_torch.configs import get_config
from repro_torch.serving import InferenceEngine, RequestState
from repro_torch.serving.metrics import ManualClock

torch.set_num_threads(2)

DTYPES = {"fp32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}


def _models(arch, window=None):
    jcfg, tcfg = jax_reduce(jax_get_config(arch)), reduce_for_smoke(get_config(arch))
    if jcfg.moe is not None:  # capacity cannot bind: cf >= num_experts / top_k
        jcfg = jcfg.replace(moe=dataclasses.replace(jcfg.moe, capacity_factor=8.0))
        tcfg = tcfg.replace(moe=dataclasses.replace(tcfg.moe, capacity_factor=8.0))
    if window is not None:
        jcfg, tcfg = jcfg.replace(sliding_window=window), tcfg.replace(sliding_window=window)
    jparams = jax_init_params(jcfg, jax.random.PRNGKey(0), jnp.float32)
    tparams = params_from_jax(tcfg, jax.tree.map(np.asarray, jparams), device="cpu")
    return jcfg, tcfg, jparams, tparams


def _prompts(n=7, seed=5, lengths=(5, 9, 17, 3, 30, 12, 21)):
    rng = np.random.default_rng(seed)
    return [[int(t) for t in rng.integers(2, 250, m)] for m in lengths[:n]]


def _int_stats(s: dict) -> dict:
    return {k: v for k, v in s.items() if isinstance(v, int) and not isinstance(v, bool)}


def _pair(arch, window=None, dtype="fp32", **kw):
    jcfg, tcfg, jparams, tparams = _models(arch, window)
    jdt, tdt = DTYPES[dtype]
    jeng = JaxEngine(jcfg, jparams, cache_kind="dense", cache_dtype=jdt, **kw)
    teng = InferenceEngine(tcfg, tparams, cache_kind="dense", cache_dtype=tdt, device="cpu", **kw)
    return jeng, teng


@pytest.mark.parametrize(
    "arch,window,dtype,eos,max_new",
    [
        ("olmo-1b", None, "fp32", 1 << 20, 8),
        ("olmo-1b", None, "fp32", 65, 8),
        ("olmo-1b", None, "bf16", 1 << 20, 8),
        ("gemma-7b", None, "fp32", 1 << 20, 8),
        ("olmo-1b", 8, "fp32", 1 << 20, 40),
        ("qwen3-moe-235b-a22b", None, "fp32", 1 << 20, 8),
        ("arctic-480b", None, "fp32", 1 << 20, 8),
    ],
    ids=["olmo-1b", "olmo-1b-eos-65", "olmo-1b-bf16", "gemma-7b", "olmo-1b-window-8", "qwen3-moe", "arctic"],
)
def test_dense_engine_matches_jax_engine(arch, window, dtype, eos, max_new):
    """The window case serves prompt + new tokens past max_seq: the ring
    (8 slots) wraps, which a window arch is allowed."""
    jeng, teng = _pair(arch, window, dtype, max_batch=3, max_seq=48, eos_token=eos)
    prompts = _prompts()
    jreqs = [jeng.submit(p, max_new_tokens=max_new) for p in prompts]
    treqs = [teng.submit(p, max_new_tokens=max_new) for p in prompts]
    jeng.run_until_drained()
    teng.run_until_drained()
    assert all(r.state == RequestState.DONE for r in treqs)
    assert [r.generated for r in treqs] == [r.generated for r in jreqs]
    assert [r.finish_reason for r in treqs] == [r.finish_reason for r in jreqs]
    js, ts = jeng.stats(), teng.stats()
    assert _int_stats(ts) == _int_stats(js)
    assert ts["cache_kind"] == "dense" and ts["cache_bytes"] == teng.cache_bytes() == jeng.cache_bytes()
    assert ts["peak_active"] == 3 and ts["prefill_chunks"] == len(prompts)
    assert not any(k.startswith(("alloc_", "prefix_", "spill_")) or k == "block_size" for k in ts)
    assert ts["energy_joules"] > 0 and "joules_per_token" in ts
    # the ring after the drain, empty slots' decode writes included
    assert np.array_equal(teng.cache["pos"].numpy(), np.asarray(jeng.cache["pos"]))
    if eos == 65:  # these weights emit 65 in two of the seven requests
        assert {r.finish_reason for r in treqs} == {"eos", "length"}


@pytest.mark.parametrize(
    "arch", ["olmo-1b", "gemma-7b", "stablelm-12b", "mistral-nemo-12b", "qwen3-moe-235b-a22b", "arctic-480b"]
)
def test_dense_matches_paged(arch):
    """The two layouts of the port decode the same greedy tokens at fp32."""
    _, tcfg, _, tparams = _models(arch)
    outs = {}
    for kind in ("dense", "paged"):
        eng = InferenceEngine(
            tcfg, tparams, max_batch=3, max_seq=64, cache_kind=kind, block_size=8, cache_dtype=torch.float32,
            eos_token=1 << 20, device="cpu",
        )
        reqs = [eng.submit(p, max_new_tokens=6) for p in _prompts(5)]
        eng.run_until_drained()
        assert all(r.state == RequestState.DONE for r in reqs)
        outs[kind] = [r.generated for r in reqs]
    assert outs["paged"] == outs["dense"]


def test_paged_admits_more_concurrency_same_byte_budget():
    _, tcfg, _, tparams = _models("olmo-1b")
    kw = dict(max_seq=64, cache_dtype=torch.float32, eos_token=1 << 20, device="cpu")
    dense = InferenceEngine(tcfg, tparams, max_batch=2, cache_kind="dense", **kw)
    # 16 blocks of 8 = 128 positions (the null block included) = 2 x 64
    paged = InferenceEngine(tcfg, tparams, max_batch=8, cache_kind="paged", block_size=8, num_blocks=16, **kw)
    assert paged.cache_bytes() <= dense.cache_bytes()
    for eng in (dense, paged):
        for i in range(8):
            eng.submit([3 + i, 4, 5], max_new_tokens=5)
        eng.run_until_drained()
        assert len(eng.done) == 8
    assert dense.stats()["peak_active"] == 2
    assert paged.stats()["peak_active"] > dense.stats()["peak_active"]
    assert paged.stats()["decode_steps"] < dense.stats()["decode_steps"]


@pytest.mark.parametrize(
    "option,value,attr,ignored",
    [
        ("spec_decode", "ngram", "spec_mode", "off"),
        ("prefix_cache", True, "prefix", None),
        ("prefill_budget", 16, "_chunked", False),
        ("quantize_kv", "int8", "quantize_kv", None),
        ("spill_bytes", 1 << 20, "spill", None),
    ],
)
def test_dense_warns_and_ignores_paged_options(option, value, attr, ignored):
    """Each paged option warns on the dense layout, as in the JAX engine,
    and the engine serves as without it."""
    jcfg, tcfg, jparams, tparams = _models("olmo-1b")
    with pytest.warns(RuntimeWarning):
        JaxEngine(jcfg, jparams, cache_kind="dense", max_seq=32, **{option: value})
    with pytest.warns(RuntimeWarning, match=option):
        eng = InferenceEngine(tcfg, tparams, cache_kind="dense", max_seq=32, device="cpu", **{option: value})
    assert getattr(eng, attr) == ignored
    r = eng.submit([5, 6, 7], max_new_tokens=3)
    eng.run_until_drained()
    assert r.finish_reason is not None and eng.stats()["cache_kind"] == "dense"


def test_dense_refuses_fused():
    jcfg, tcfg, jparams, tparams = _models("olmo-1b")
    with pytest.raises(ValueError, match="fused"):
        JaxEngine(jcfg, jparams, cache_kind="dense", fused=True)
    with pytest.raises(ValueError, match="fused"):
        InferenceEngine(tcfg, tparams, cache_kind="dense", fused=True, device="cpu")
    with warnings.catch_warnings():
        warnings.simplefilter("error")  # the plain dense engine warns about nothing
        eng = InferenceEngine(tcfg, tparams, cache_kind="dense", device="cpu")
    assert not eng.chunked() and not eng.can_preempt()


def test_oversized_request_rejected():
    """A full-attention request past max_seq would wrap the ring; a window
    arch may run past it."""
    _, tcfg, _, tparams = _models("olmo-1b")
    dense = InferenceEngine(tcfg, tparams, max_batch=2, max_seq=32, cache_kind="dense", device="cpu")
    with pytest.raises(ValueError, match="max_seq"):
        dense.submit(list(range(2, 30)), max_new_tokens=16)  # 28 + 16 > 32
    dense.submit(list(range(2, 18)), max_new_tokens=16)  # 16 + 16 = 32 fits
    windowed = InferenceEngine(
        tcfg.replace(sliding_window=8), tparams, max_batch=2, max_seq=32, cache_kind="dense", device="cpu"
    )
    windowed.submit(list(range(2, 30)), max_new_tokens=16)


def test_dense_abort_and_deadline_match_jax():
    """One slot: request 0 decodes, request 1 queues behind it with a TTFT
    deadline that passes on the manual clock (aborted, never admitted),
    request 2 queues without one; request 0 is aborted mid-decode, which
    empties its ring row, and request 2 then runs to its length."""
    jcfg, tcfg, jparams, tparams = _models("olmo-1b")
    runs = {}
    for name, engine_cls, params, cfg, clock, extra in (
        ("jax", JaxEngine, jparams, jcfg, JaxClock(), dict(cache_dtype=jnp.float32)),
        ("torch", InferenceEngine, tparams, tcfg, ManualClock(), dict(cache_dtype=torch.float32, device="cpu")),
    ):
        eng = engine_cls(cfg, params, max_batch=1, max_seq=48, cache_kind="dense", eos_token=1 << 20, clock=clock,
                         **extra)
        reqs = [eng.submit([5, 6, 7, 8], max_new_tokens=12)]
        eng.step()
        # a deadline orders request 1 ahead of request 2 under the SLO policy
        reqs += [eng.submit([9, 10], max_new_tokens=4, deadline_s=0.5), eng.submit([11, 12, 13], max_new_tokens=5)]
        for _ in range(2):
            eng.step()
        clock.advance(1.0)
        eng.step()  # request 1's deadline passes while it waits
        assert reqs[1].finish_reason == "deadline_exceeded" and reqs[1].slot is None
        assert eng.abort(reqs[0].req_id) and not eng.abort(reqs[0])
        if name == "torch":
            assert bool((eng.cache["pos"] == -1).all()) and bool((eng.cache["k"] == 0).all())
        eng.run_until_drained()
        runs[name] = ([r.generated for r in reqs], [r.finish_reason for r in reqs], _int_stats(eng.stats()))
    assert runs["torch"] == runs["jax"]
    tokens, reasons, stats = runs["torch"]
    assert reasons == ["aborted", "deadline_exceeded", "length"] and len(tokens[2]) == 5
    assert stats["requests_aborted"] == 2 and stats["deadline_violations"] == 1
