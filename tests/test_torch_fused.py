"""The port's fused one-dispatch step against the JAX package's.

* ``unified_step`` against JAX ``unified_step`` on the same bridged
  weights: a decode row, two chunk rows of one request in the same call
  (the second reads the first's K/V) and a width-0 pad row.  fp32 pools,
  so the logits of valid lanes agree to 1e-4 (sums in another order), as
  ``test_torch_model.py`` holds ``prefill_step``; the pools agree on every
  live block.
* ``fused_sample_accept`` against the JAX function on greedy rows (decode,
  chunk, a verify window with drafts): accept counts and tokens equal.
* The port's fused engine (``fused=True``, eager on the CPU) against the
  JAX fused engine and against the port's legacy walk: greedy tokens,
  finish reasons and every integer stat but ``cache_bytes`` (the port keeps
  one block table, the JAX engine one per layer), including the dispatch
  and sync counts of both walks against the JAX engine's.  fp32 pools; the
  eos id lies outside the vocab unless a case names one.  The moe cases
  (qwen3-moe with the prefix cache, arctic staggered) run at capacity
  factor 8, where no pair can be dropped.
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
from repro.models import init_paged_cache as jax_init_paged_cache
from repro.models import init_params as jax_init_params
from repro.models import prefill_step as jax_prefill_step
from repro.models import unified_step as jax_unified_step
from repro.serving import InferenceEngine as JaxEngine
from repro.serving.sampler import fused_sample_accept as jax_fused_sample_accept
from repro_torch.bridge import params_from_jax
from repro_torch.config import reduce_for_smoke
from repro_torch.configs import get_config
from repro_torch.models import init_paged_cache, prefill_step, unified_step
from repro_torch.serving import InferenceEngine, RequestState
from repro_torch.serving.sampler import fused_sample_accept

torch.set_num_threads(2)

EOS_OUT = 1 << 30  # outside every vocab: requests run to their length


def _bridged(arch, key=0, **overrides):
    jcfg = jax_reduce(jax_get_config(arch)).replace(**overrides)
    tcfg = reduce_for_smoke(get_config(arch)).replace(**overrides)
    if jcfg.moe is not None:  # capacity cannot bind: cf >= num_experts / top_k
        jcfg = jcfg.replace(moe=dataclasses.replace(jcfg.moe, capacity_factor=8.0))
        tcfg = tcfg.replace(moe=dataclasses.replace(tcfg.moe, capacity_factor=8.0))
    jparams = jax_init_params(jcfg, jax.random.PRNGKey(key), jnp.float32)
    return jcfg, tcfg, jparams, params_from_jax(tcfg, jax.tree.map(np.asarray, jparams), device="cpu")


# ---------------------------------------------------------------------------
# (a) unified_step
# ---------------------------------------------------------------------------

BS, NB, NBLK = 8, 4, 9
HIST = 10  # request A's prefilled history (blocks 1, 2); it decodes at position 10
LIVE = [1, 2, 3, 4]  # A's blocks, then B's


@pytest.mark.parametrize("jax_impl", ["xla", "pallas"])
def test_unified_step_matches_jax(jax_impl):
    jcfg, tcfg, jparams, tparams = _bridged("olmo-1b", key=3)
    rng = np.random.default_rng(7)
    hist = rng.integers(0, jcfg.vocab_size, HIST).astype(np.int32)
    b_prompt = rng.integers(0, jcfg.vocab_size, 12).astype(np.int32)
    a_row = np.array([1, 2, 0, 0], np.int32)
    b_row = np.array([3, 4, 0, 0], np.int32)

    # rows: A decodes at HIST; B's chunks [0, 8) and [8, 12) in the same
    # call; a width-0 pad row with an all-null table
    R, W = 4, 8
    tokens = np.zeros((R, W), np.int32)
    tokens[0, 0] = 5
    tokens[1] = b_prompt[:8]
    tokens[2, :4] = b_prompt[8:]
    start = np.array([HIST, 0, 8, 0], np.int32)
    widths = np.array([1, 8, 4, 0], np.int32)
    tbl = np.stack([a_row, b_row, b_row, np.zeros(NB, np.int32)])

    jcache = jax_init_paged_cache(jcfg, NBLK, BS, 2, NB, jnp.float32)
    _, jcache = jax_prefill_step(
        jcfg, jparams, jcache, jnp.asarray(hist[None]), jnp.asarray([0], jnp.int32), jnp.asarray(a_row[None])
    )
    jlogits, jcache = jax_unified_step(
        jcfg, jparams, jcache, jnp.asarray(tokens), jnp.asarray(start), jnp.asarray(widths), jnp.asarray(tbl),
        attn_impl=jax_impl,
    )

    tcache = init_paged_cache(tcfg, NBLK, BS, 2, NB, torch.float32, device="cpu")
    prefill_step(tcfg, tparams, tcache, torch.from_numpy(hist[None]), torch.tensor([0], dtype=torch.int32),
                 torch.from_numpy(a_row[None]))
    tlogits, tcache = unified_step(
        tcfg, tparams, tcache, torch.from_numpy(tokens), torch.from_numpy(start), torch.from_numpy(widths),
        torch.from_numpy(tbl),
    )

    assert tlogits.shape == (R, W, tcfg.padded_vocab)
    jl, tl = np.asarray(jlogits), tlogits.numpy()
    for i in range(R):
        w = widths[i]
        err = float(np.max(np.abs(tl[i, :w] - jl[i, :w]))) if w else 0.0
        assert err < 1e-4, f"row {i}: logits differ by {err}"
    for name in ("k", "v"):
        got = tcache[name][:, LIVE].numpy()
        ref = np.asarray(jcache[name])[:, LIVE]
        assert np.abs(got - ref).max() < 1e-5, name


# ---------------------------------------------------------------------------
# (b) fused_sample_accept
# ---------------------------------------------------------------------------


def test_fused_sample_accept_matches_jax_on_greedy_rows():
    R, W, V = 5, 6, 64
    K = W - 1
    rng = np.random.default_rng(2)
    logits = rng.standard_normal((R, W, V)).astype(np.float32)
    argmax = logits.argmax(-1)
    drafts = np.zeros((R, K), np.int32)
    valid = np.zeros((R, K), bool)
    sample_lane = np.zeros((R,), np.int32)
    # row 0: decode; row 1: a chunk of width 4; row 2: a verify window whose
    # third draft is wrong; row 3: every draft right (the bonus lane);
    # row 4: two valid drafts, both right, then no window
    sample_lane[1] = 3
    drafts[2] = argmax[2, :K]
    drafts[2, 2] = (argmax[2, 2] + 1) % V
    valid[2] = True
    drafts[3] = argmax[3, :K]
    valid[3] = True
    drafts[4, :2] = argmax[4, :2]
    valid[4, :2] = True
    temps = np.zeros((R,), np.float32)
    top_ks = np.zeros((R,), np.int32)
    top_ks[1] = 5  # greedy rows ignore top-k

    jn, jf = jax_fused_sample_accept(
        jnp.asarray(logits), jnp.asarray(drafts), None, jnp.asarray(valid), jnp.asarray(temps),
        jnp.asarray(top_ks), jnp.asarray(sample_lane), jax.random.PRNGKey(0),
    )
    tn, tf = fused_sample_accept(
        torch.from_numpy(logits), torch.from_numpy(drafts), None, torch.from_numpy(valid), torch.from_numpy(temps),
        torch.from_numpy(top_ks), torch.from_numpy(sample_lane), torch.Generator().manual_seed(0),
    )
    assert tn.tolist() == np.asarray(jn).tolist() == [0, 0, 2, K, 2]
    assert tf.tolist() == np.asarray(jf).tolist()
    assert tf.tolist()[:2] == [argmax[0, 0], argmax[1, 3]]


# ---------------------------------------------------------------------------
# (c), (d) the fused engine
# ---------------------------------------------------------------------------

SHARED = [11, 12, 13, 14, 15, 16, 17, 18]
PROMPTS = [
    SHARED + [7, 3, 9, 4] * 3 + [5],
    SHARED + [5, 9, 12, 5, 9, 12, 2],
    SHARED + [21, 22, 23, 24],
    [30, 31],
]


def _engine(cls, cfg, params, *, fused, **kw):
    base = dict(max_batch=2, max_seq=64, block_size=8, prefill_budget=8, eos_token=EOS_OUT, fused=fused)
    base.update(kw)
    if cls is JaxEngine:
        base["cache_dtype"] = jnp.float32
    else:
        base.update(cache_dtype=torch.float32, device="cpu")
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        return cls(cfg, params, **base)


def _drain(eng, prompts=PROMPTS, max_new=6):
    reqs = [eng.submit(p, max_new_tokens=max_new) for p in prompts]
    eng.run_until_drained()
    return reqs


def _staggered(eng):
    """One request decodes a few ticks, then the rest arrive: with a budget
    of 4 the later prompts chunk across several ticks beside the decode."""
    reqs = [eng.submit(PROMPTS[0], max_new_tokens=8)]
    for _ in range(3):
        eng.step()
    reqs += [eng.submit(p, max_new_tokens=8) for p in PROMPTS[1:]]
    eng.run_until_drained()
    return reqs


def _preempted(eng):
    """A high-priority arrival preempts the decoding request between ticks;
    the victim resumes through chunk rows."""
    low = eng.submit(PROMPTS[0], max_new_tokens=8)
    for _ in range(4):
        eng.step()
    assert low.state.name == "ACTIVE"
    high = eng.submit([40, 41, 42], max_new_tokens=4, priority=5)
    eng.step()
    assert low.state.name == "WAITING" and low.preemptions == 1
    eng.run_until_drained()
    return [low, high]


def _eos_prompts():
    """``test_torch_engine.py``'s prompts: with eos 137 these weights finish
    some requests by EOS and some by length."""
    prefix = [7, 3, 19, 42, 5, 88, 13, 2, 61, 17, 23, 99]
    rng = np.random.default_rng(11)
    tail = lambda n: [int(t) for t in rng.integers(2, 250, n)]  # noqa: E731
    return [prefix + tail(8), prefix + tail(5), tail(9), prefix + tail(11), prefix[:10] + tail(3), prefix + tail(2)]


ENGINE_CASES = {
    "olmo_1b": ("olmo-1b", {}, dict(prefix_cache=False), _drain),
    "olmo_1b_prefix": ("olmo-1b", {}, dict(prefix_cache=True), _drain),
    "mistral_window_8": ("mistral-nemo-12b", {"sliding_window": 8}, {}, _drain),
    "staggered": ("olmo-1b", {}, dict(max_batch=3, prefill_budget=4), _staggered),
    "preemption": ("olmo-1b", {}, dict(max_batch=1, prefill_budget=4), _preempted),
    "eos_137": (
        "olmo-1b", {}, dict(eos_token=137, prefill_budget=16),
        lambda eng: _drain(eng, _eos_prompts(), max_new=6),
    ),
    # the moe family at capacity factor 8 (no pair dropped; test_torch_moe.py
    # holds both walks where capacity binds)
    "qwen3_moe_prefix": ("qwen3-moe-235b-a22b", {}, dict(prefix_cache=True), _drain),
    "arctic": ("arctic-480b", {}, dict(max_batch=3, prefill_budget=4), _staggered),
}


def _int_stats(s: dict) -> dict:
    return {k: v for k, v in s.items() if type(v) is int and k != "cache_bytes"}


def _run_all(name):
    arch, overrides, kw, drive = ENGINE_CASES[name]
    jcfg, tcfg, jparams, tparams = _bridged(arch, **overrides)
    out = {}
    for side, cls, cfg, params in (("jax", JaxEngine, jcfg, jparams), ("torch", InferenceEngine, tcfg, tparams)):
        for fused in (False, True):
            eng = _engine(cls, cfg, params, fused=fused, **kw)
            reqs = drive(eng)
            assert all(r.state.name == "DONE" for r in reqs)  # either package's RequestState
            assert eng.allocator.blocks_in_use == 0
            out[side, fused] = ([list(r.generated) for r in reqs], [r.finish_reason for r in reqs], eng.stats())
    return out


@pytest.mark.parametrize("name", list(ENGINE_CASES))
def test_fused_engine_matches_jax_and_legacy(name):
    out = _run_all(name)
    tokens, reasons, stats = out["torch", True]
    assert tokens == out["jax", True][0] == out["torch", False][0]
    assert reasons == out["jax", True][1] == out["torch", False][1]
    if name == "eos_137":
        assert set(reasons) == {"eos", "length"}
    else:
        assert set(reasons) == {"length"}
    for fused in (False, True):
        js, ts = _int_stats(out["jax", fused][2]), _int_stats(out["torch", fused][2])
        common = js.keys() & ts.keys()
        assert {"dispatches_total", "host_syncs_total", "decode_steps", "tokens_out"} <= common
        assert {k: ts[k] for k in common} == {k: js[k] for k in common}, f"fused={fused}"
    assert stats["fused"] and not out["torch", False][2]["fused"]
    if name == "olmo_1b_prefix":
        assert stats["prefix_hit_tokens"] > 0


def test_fused_engine_takes_fewer_dispatches():
    """The fused step's contract (the JAX package's
    ``test_fused_fewer_dispatches_and_syncs``, with an eos outside the
    vocab so every request runs to its length)."""
    _, tcfg, _, tparams = _bridged("olmo-1b")
    stats = {}
    for fused in (False, True):
        eng = _engine(InferenceEngine, tcfg, tparams, fused=fused)
        _drain(eng)
        stats[fused] = eng.stats()
    assert stats[True]["dispatches_per_step"] < stats[False]["dispatches_per_step"]
    assert stats[True]["host_syncs_per_step"] <= stats[False]["host_syncs_per_step"]
    assert stats[True]["dispatches_per_step"] <= 1.5


def test_fused_with_spec_decode_is_refused():
    """``fused=True`` with ``spec_decode="ngram"`` is no longer refused: it
    builds and drains on the CPU, every tick with decoding slots a verify
    tick.  Its parity with the JAX engine is ``test_torch_spec_decode.py``'s."""
    _, tcfg, _, tparams = _bridged("olmo-1b")
    eng = _engine(InferenceEngine, tcfg, tparams, fused=True, spec_decode="ngram", spec_k=3)
    reqs = _drain(eng)
    s = eng.stats()
    assert all(r.state == RequestState.DONE and len(r.generated) == 6 for r in reqs)
    assert s["fused"] and s["spec_steps"] > 0 and s["drafted_tokens"] > 0
    assert s["alloc_blocks_in_use"] == 0 and s["dispatches_per_step"] <= 1.5
