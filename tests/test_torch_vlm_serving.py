"""The port's vlm family (llama-3.2-vision-90b) on the serving path against
the JAX package's, on the CPU, at smoke size (one group of 4 self layers
and a cross layer, 8 image tokens) and with two groups (10 layers), on
bridged weights whose cross gates are open (``test_torch_vlm._perturbed``).

* The grouped slot cache: ``make_engine_cache`` (nesting, shapes, dtypes,
  ``cache_bytes``), ``decode_cache_from_prefill`` (the ``(G, g)`` self
  rings, with and without a sliding window that wraps), ``write_request_into_slot``,
  ``write_prefill_into_slot`` (also over a slot a longer request left
  uncleared: its stale rows sit under position -1) and ``clear_slot``
  against the JAX functions fed the same raw cache, leaf for leaf: fp32
  caches to 1e-5, bf16 caches equal (the same rounding of the same values).
* The engine on the dense slot cache against the JAX engine on one manual
  clock, bf16 and fp32 caches, one and two groups: greedy tokens, finish
  reasons and every stat (``cache_bytes`` included: both hold one position
  row a self layer and no table), and the cache after the drain.  Each
  prefill gets zero image tokens, as the JAX engine feeds; ``cache_kind=
  "paged"`` turns into ``"dense"`` without a warning.
* The chunked options warn with the JAX engine's messages and are
  disabled; ``fused=True`` raises its ``ValueError``; the chunked model
  steps refuse the family with its message.
* A finished request's slot is emptied (image K/V zero, positions -1).
* The serve launcher on smoke llama-3.2-vision-90b prints ``cache_kind: dense``.
"""

import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_vlm import _prompt, models

from repro.models import prefill as jax_prefill
from repro.models import prefill_step as jax_prefill_step
from repro.models.cache import cache_bytes as jax_cache_bytes
from repro.serving import InferenceEngine as JaxEngine
from repro.serving import ManualClock as JaxClock
from repro.serving import kvcache as jkv
from repro_torch.models import cache_bytes, init_paged_cache, prefill_step, supports_chunked_prefill, supports_paged
from repro_torch.serving import InferenceEngine, RequestState
from repro_torch.serving import kvcache as tkv
from repro_torch.serving.metrics import ManualClock
from repro_torch.utils.tree import tree_leaves

torch.set_num_threads(2)

EOS_OUT = 1 << 30  # outside the vocab: requests run to their length
MAX_SEQ = 48
DTYPES = {"fp32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}


def _torch_tree(tree):
    return {k: _torch_tree(v) if isinstance(v, dict) else torch.from_numpy(np.array(v, np.float32)) for k, v in tree.items()}


def _same(t, j, dtype):
    """Leaf for leaf: fp32 to 1e-5, other dtypes and positions bit for bit."""
    for part in j:
        for name, ref in j[part].items():
            got = t[part][name]
            assert tuple(got.shape) == ref.shape, (part, name)
            ref = np.asarray(ref.astype(jnp.float32) if ref.dtype == jnp.bfloat16 else ref)
            if dtype == "fp32" or name == "pos":
                np.testing.assert_allclose(got.float().numpy(), ref, atol=1e-5, rtol=0, err_msg=f"{part}/{name}")
            else:
                assert torch.equal(got, torch.from_numpy(ref).to(got.dtype)), (part, name)


def _raw(jcfg, jparams, n, padded, seed):
    """The JAX prefill's raw cache of one prompt of n tokens padded to
    ``padded`` (random image tokens)."""
    toks = np.zeros((1, padded), np.int32)
    toks[0, :n] = _prompt(n, seed)
    vis = np.random.default_rng(seed).standard_normal((1, jcfg.vision.num_image_tokens, jcfg.d_model))
    _, raw = jax_prefill(jcfg, jparams, {"tokens": jnp.asarray(toks), "last_index": jnp.asarray([n - 1]),
                                         "vision_tokens": jnp.asarray(vis, jnp.float32)})
    return raw


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("variant,window", [("plain", 0), ("two_groups", 0), ("plain", 8)],
                         ids=["one-group", "two-groups", "window-8"])
def test_slot_surgery_matches_jax(variant, window, dtype):
    jcfg, tcfg, jparams, _ = models(variant)
    jcfg, tcfg = jcfg.replace(sliding_window=window), tcfg.replace(sliding_window=window)
    jdt, tdt = DTYPES[dtype]
    n, padded = 13, 16
    jeng = jkv.make_engine_cache(jcfg, 3, MAX_SEQ, jdt)
    teng = tkv.make_engine_cache(tcfg, 3, MAX_SEQ, tdt, device="cpu")
    direct = tkv.make_engine_cache(tcfg, 3, MAX_SEQ, tdt, device="cpu")
    _same(teng, jeng, dtype)
    assert teng["self"]["pos"].dtype == torch.int32 and teng["cross"]["ck"].dtype == tdt
    assert sum(t.numel() * t.element_size() for t in tree_leaves(teng)) == cache_bytes(tcfg, 3, MAX_SEQ, tdt)
    assert cache_bytes(tcfg, 3, MAX_SEQ, tdt) == jax_cache_bytes(jcfg, 3, MAX_SEQ, jdt)
    # slot 2 first holds a request 7 tokens longer, left uncleared
    tkv.write_prefill_into_slot(tcfg, direct, _torch_tree(_raw(jcfg, jparams, n + 7, n + 7, 3)), 2, seq_filled=n + 7)
    raws = {slot: _raw(jcfg, jparams, n, padded, seed) for slot, seed in ((0, 1), (1, 2))}
    for slot, raw in raws.items():
        jreq = jkv.decode_cache_from_prefill(jcfg, raw, seq_filled=n, decode_len=MAX_SEQ)
        treq = tkv.decode_cache_from_prefill(tcfg, _torch_tree(raw), seq_filled=n, decode_len=MAX_SEQ)
        _same(treq, jreq, "fp32")
        jeng = jkv.write_request_into_slot(jcfg, jeng, jreq, slot)
        assert tkv.write_request_into_slot(tcfg, teng, treq, slot) is teng  # in place
        assert tkv.write_prefill_into_slot(tcfg, direct, _torch_tree(raw), slot, seq_filled=n) is direct
    _same(teng, jeng, dtype)
    tkv.write_prefill_into_slot(tcfg, direct, _torch_tree(raws[1]), 2, seq_filled=n)
    for part, slot_dim in (("self", 2), ("cross", 1)):
        for name, leaf in teng[part].items():
            assert torch.equal(direct[part][name].narrow(slot_dim, 0, 2), leaf.narrow(slot_dim, 0, 2)), name
    stale = direct["self"]["pos"][:, :, 2]
    assert torch.equal(stale, teng["self"]["pos"][:, :, 1])
    filled = stale >= 0  # the rows the longer request left past the prompt sit under position -1
    for name in ("k", "v"):
        assert torch.equal(direct["self"][name][:, :, 2][filled], teng["self"][name][:, :, 1][filled]), name
        assert bool(direct["self"][name][:, :, 2][~filled].any()) == (window == 0)
    for name in ("ck", "cv"):
        assert torch.equal(direct["cross"][name][:, 2], teng["cross"][name][:, 1]), name
    jeng = jkv.clear_slot(jcfg, jeng, 1)
    assert tkv.clear_slot(tcfg, teng, 1) is teng
    _same(teng, jeng, dtype)
    assert bool((teng["self"]["pos"][:, :, 1] == -1).all()) and not bool(teng["cross"]["ck"][:, 1].any())
    assert bool(teng["cross"]["ck"][:, 0].any()) and not bool((teng["self"]["pos"][:, :, 0] == -1).all())


ENGINE_PROMPTS = [_prompt(n, 30 + i) for i, n in enumerate((13, 9, 21, 3, 17, 6, 11))]
MAX_NEW = [10, 6, 12, 8, 9, 5, 11]


def _engines(variant, dtype, cache_kind="dense", **kw):
    jcfg, tcfg, jparams, tparams = models(variant)
    jdt, tdt = DTYPES[dtype]
    kw = {"max_batch": 3, "max_seq": MAX_SEQ, "cache_kind": cache_kind, "eos_token": EOS_OUT, **kw}
    je = JaxEngine(jcfg, jparams, clock=JaxClock(), cache_dtype=jdt, **kw)
    te = InferenceEngine(tcfg, tparams, clock=ManualClock(), cache_dtype=tdt, device="cpu", **kw)
    return je, te


@pytest.mark.parametrize(
    "variant,dtype,asked",
    [("plain", "bf16", "dense"), ("plain", "fp32", "dense"), ("plain", "bf16", "paged"), ("two_groups", "bf16", "dense")],
    ids=["bf16", "fp32", "paged-asked", "two-groups-bf16"],
)
def test_engine_matches_jax_engine(variant, dtype, asked):
    """Three slots, seven requests: prompts bucketed to powers of two,
    each with zero image tokens."""
    with warnings.catch_warnings():
        warnings.simplefilter("error")  # a paged request turns dense silently
        je, te = _engines(variant, dtype, asked)
    assert te.cache_kind == je.cache_kind == "dense" and te.allocator is None
    assert set(te.cache) == {"self", "cross"}
    jreqs = [je.submit(p, max_new_tokens=m) for p, m in zip(ENGINE_PROMPTS, MAX_NEW)]
    treqs = [te.submit(p, max_new_tokens=m) for p, m in zip(ENGINE_PROMPTS, MAX_NEW)]
    je.run_until_drained()
    te.run_until_drained()
    assert all(r.state == RequestState.DONE for r in treqs)
    assert [r.generated for r in treqs] == [r.generated for r in jreqs]
    assert [r.finish_reason for r in treqs] == [r.finish_reason for r in jreqs]
    assert te.stats() == je.stats()
    s = te.stats()
    assert s["cache_kind"] == "dense" and s["prefill_chunks"] == len(ENGINE_PROMPTS)
    assert s["prefill_tokens"] == sum(len(p) for p in ENGINE_PROMPTS)
    _same(te.cache, jax.tree.map(np.asarray, je.cache), dtype)


def test_finished_slot_is_emptied():
    """Two requests, 3 and 9 new tokens: when the first finishes its slot's
    image K/V go to zero and its ring positions to -1 in every layer, while
    the second keeps its own; then the cache after the drain equals the JAX
    engine's (idle slots decode too, in both packages).  With biases: zero
    image tokens project to the K/V biases, which the cleared slot loses."""
    je, te = _engines("bias", "fp32", max_batch=2)
    prompts, max_new = (_prompt(12, 1), _prompt(20, 2)), (3, 9)
    jr = [je.submit(p, max_new_tokens=m) for p, m in zip(prompts, max_new)]
    short, long_ = (te.submit(p, max_new_tokens=m) for p, m in zip(prompts, max_new))
    je.step()
    te.step()
    slots = (short.slot, long_.slot)
    assert all(bool((te.cache["self"]["pos"][:, :, s] >= 0).any()) for s in slots)
    assert all(bool(te.cache["cross"][name][:, s].any()) for s in slots for name in ("ck", "cv"))
    while short.state != RequestState.DONE:
        je.step()
        te.step()
    assert long_.state == RequestState.ACTIVE
    assert bool((te.cache["self"]["pos"][:, :, slots[0]] <= 0).all())  # emptied, then the idle row's position 0
    assert bool((te.cache["self"]["pos"][:, :, slots[1]] > 0).any())
    for name in ("ck", "cv"):
        assert not bool(te.cache["cross"][name][:, slots[0]].any()) and bool(te.cache["cross"][name][:, slots[1]].any())
        assert not np.asarray(je.cache["cross"][name])[:, slots[0]].any()
    je.run_until_drained()
    te.run_until_drained()
    assert [r.generated for r in (short, long_)] == [r.generated for r in jr]
    _same(te.cache, jax.tree.map(np.asarray, je.cache), "fp32")


def _warning_texts(fn):
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        fn()
    return sorted(str(w.message) for w in caught if issubclass(w.category, RuntimeWarning))


@pytest.mark.parametrize("kind", ["paged", "dense"])
def test_chunked_options_warn_and_fused_raises_as_jax(kind):
    jcfg, tcfg, jparams, tparams = models()
    options = dict(prefix_cache=True, prefill_budget=16, spec_decode="ngram", quantize_kv="int8")
    jw = _warning_texts(lambda: JaxEngine(jcfg, jparams, cache_kind=kind, max_seq=64, **options))
    holder = {}
    tw = _warning_texts(lambda: holder.setdefault(
        "eng", InferenceEngine(tcfg, tparams, cache_kind=kind, max_seq=64, device="cpu", **options)))
    assert tw == jw and len(tw) == 4
    eng = holder["eng"]
    assert not eng.chunked() and not eng.can_preempt() and eng.prefix is None and eng.spec_mode == "off"
    r = eng.submit(_prompt(10, 3), max_new_tokens=3)
    eng.run_until_drained()
    assert r.state == RequestState.DONE and 1 <= len(r.generated) <= 3
    with pytest.raises(ValueError) as jerr:
        JaxEngine(jcfg, jparams, cache_kind=kind, fused=True)
    with pytest.raises(ValueError) as terr:
        InferenceEngine(tcfg, tparams, cache_kind=kind, fused=True, device="cpu")
    assert str(terr.value) == str(jerr.value)


def test_chunked_steps_refuse_the_family():
    jcfg, tcfg, jparams, tparams = models()
    assert not supports_paged(tcfg) and not supports_chunked_prefill(tcfg)
    with pytest.raises(ValueError) as jerr:
        jax_prefill_step(jcfg, jparams, {}, jnp.zeros((1, 4), jnp.int32), jnp.zeros(1, jnp.int32),
                         jnp.zeros((1, 2), jnp.int32))
    with pytest.raises(ValueError) as terr:
        prefill_step(tcfg, tparams, {}, torch.zeros((1, 4), dtype=torch.int32), torch.zeros(1, dtype=torch.int32),
                     torch.zeros((1, 2), dtype=torch.int32))
    assert str(terr.value) == str(jerr.value)
    with pytest.raises(ValueError, match="no paged cache for family 'vlm'"):
        init_paged_cache(tcfg, 4, 8, 1, 2, torch.float32, device="cpu")


def test_serve_launcher_serves_vlm(capsys):
    from repro_torch.launch.serve import main

    stats = main(["--device", "cpu", "--arch", "llama-3.2-vision-90b", "--requests", "4", "--max-new", "4"])
    out = capsys.readouterr().out
    assert "llama-3.2-vision-90b" in out and "on cpu" in out and "'cache_kind': 'dense'" in out
    assert stats["cache_kind"] == "dense" and stats["requests_done"] == 4
