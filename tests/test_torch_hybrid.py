"""The port's hybrid family (hymba-1.5b: attention and SSM heads side by
side) on the serving path against the JAX package's, on the CPU, at smoke
size (``reduce_for_smoke``: 2 layers, d_model 80, 5 query heads over 1 kv
head of 16, a sliding window of 32, SSD chunks of 16), on bridged weights.

* The blocks: ``hybrid_block_prefill`` (output, K/V, conv and SSM states)
  on a 40-token prompt, past the window; ``hybrid_block_decode`` against a
  paged layer cache (the plain K1) and a dense ring, outputs to 4e-6 of
  their largest value, the written K/V row, conv and SSM states to 2e-6.
* The model: ``prefill`` of two prompts longer than the window (40 and 37
  tokens, one chunk of 40 and of 37 in the SSD scan), grafted into paged
  blocks or written into ring rows, then 6 ``decode_step`` s fed the JAX
  run's greedy tokens: every step's logits to 2e-5 of their largest
  value, the states after the last step to 2e-5.  The paged case runs the
  JAX decode under ``attn_impl="xla"`` and ``"pallas"`` (K1 in interpret
  mode), the port's under ``"kernel"`` (on the CPU, K1's plain version).
* The engine, paged (bf16 pools, int8 pools, fp32 pools) and dense,
  against the JAX engine on one manual clock: greedy tokens, finish
  reasons and every stat but ``cache_bytes`` equal (``eos_token`` outside
  the vocab).  The prompts outgrow the window, so K1's window and the
  paged engine's window reclaim bind.
* Backpressure: a pool that holds one request's blocks admits the next
  only when blocks come back, step for step as the JAX engine.
* A finished request's slot has zero states, the others keep theirs.
* The JAX paged cache bridged (``paged_cache_from_jax``): the conv and SSM
  states leaf for leaf, and a decode step from it as the JAX step.
* The chunked options warn with the JAX engine's messages and are
  disabled; ``fused=True`` raises its ``ValueError``; the chunked model
  steps refuse the family with its message.
"""

import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config.model import reduce_for_smoke as jax_reduce
from repro.configs import get_config as jax_get_config
from repro.models import blocks as jax_blocks
from repro.models import decode_step as jax_decode_step
from repro.models import init_paged_cache as jax_init_paged_cache
from repro.models import init_params as jax_init_params
from repro.models import prefill as jax_prefill
from repro.models import prefill_step as jax_prefill_step
from repro.serving import InferenceEngine as JaxEngine
from repro.serving import ManualClock as JaxClock
from repro.serving.kvcache import decode_cache_from_prefill as jax_ring_from_prefill
from repro.serving.kvcache import graft_prefill_into_blocks as jax_graft
from repro.serving.kvcache import make_engine_cache as jax_make_engine_cache
from repro.serving.kvcache import write_request_into_slot as jax_write_slot
from repro_torch.bridge import params_from_jax
from repro_torch.config import reduce_for_smoke
from repro_torch.configs import get_config
from repro_torch.models import blocks, decode_step, init_paged_cache, prefill, prefill_step
from repro_torch.serving import InferenceEngine, RequestState
from repro_torch.serving.kvcache import graft_prefill_into_blocks, make_engine_cache, write_prefill_into_slot
from repro_torch.serving.metrics import ManualClock

torch.set_num_threads(2)

ARCH = "hymba-1.5b"
EOS_OUT = 1 << 30  # outside the vocab: requests run to their length
BS, NB = 8, 8  # block size, table width: 64 positions


@pytest.fixture(scope="module")
def models():
    jcfg, tcfg = jax_reduce(jax_get_config(ARCH)), reduce_for_smoke(get_config(ARCH))
    jparams = jax_init_params(jcfg, jax.random.PRNGKey(0), jnp.float32)
    tparams = params_from_jax(tcfg, jax.tree.map(np.asarray, jparams), device="cpu")
    return jcfg, tcfg, jparams, tparams


def _rel(got: torch.Tensor, ref) -> float:
    ref = np.asarray(ref, dtype=np.float32)
    return float(np.max(np.abs(got.float().numpy() - ref))) / max(float(np.max(np.abs(ref))), 1e-30)


def _layer(jparams, layer=0):
    return jax.tree.map(lambda a: a[layer], jparams["blocks"])


def _prompt(n, seed):
    return [int(t) for t in np.random.default_rng(seed).integers(2, 250, n)]


# ---------------------------------------------------------------------------
# the blocks
# ---------------------------------------------------------------------------


def test_hybrid_block_prefill_matches_jax(models):
    jcfg, tcfg, jparams, tparams = models
    x = np.random.default_rng(1).standard_normal((2, 40, tcfg.d_model)).astype(np.float32)
    jx, jc = jax_blocks.hybrid_block_prefill(jcfg, _layer(jparams), jnp.asarray(x))
    tx, tc = blocks.hybrid_block_prefill(tcfg, tparams["blocks"][0], torch.from_numpy(x))
    assert _rel(tx, jx) < 4e-6
    assert set(tc) == set(jc) == {"k", "v", "conv", "ssm"}
    for name in tc:
        assert tc[name].shape == jc[name].shape and _rel(tc[name], jc[name]) < 2e-6, name


@pytest.mark.parametrize("layout", ["paged", "dense"])
def test_hybrid_block_decode_matches_jax(models, layout):
    """Three slots at positions 39 (the window binds), 5 and 0 (idle, a
    null table row); random K/V history and states, the same on both
    sides."""
    jcfg, tcfg, jparams, tparams = models
    rng = np.random.default_rng(2)
    B, KV, hd = 3, tcfg.num_kv_heads, tcfg.head_dim
    pos = np.array([39, 5, 0], np.int32)
    if layout == "paged":
        jcache = jax.tree.map(lambda a: np.array(a[0]), jax_init_paged_cache(jcfg, 1 + B * 5, BS, B, 5, jnp.float32))
        tbl = np.zeros((B, 5), np.int32)
        tbl[0], tbl[1, :1] = np.arange(1, 6), [6]
    else:
        jcache = jax.tree.map(lambda a: np.array(a[0]), jax_make_engine_cache(jcfg, B, 64, jnp.float32))
    for name in ("k", "v"):
        jcache[name][...] = rng.standard_normal(jcache[name].shape)
    if layout == "paged":
        jcache["tbl"][...] = tbl
    else:  # the ring (32 slots) of slot 0 holds positions 7..38, slot 1's 0..4
        for t in range(7, 39):
            jcache["pos"][0, t % 32] = t
        jcache["pos"][1, :5] = np.arange(5)
    jcache["conv"][...] = rng.standard_normal(jcache["conv"].shape)
    jcache["ssm"][...] = 0.5 * rng.standard_normal(jcache["ssm"].shape)
    tcache = {name: torch.from_numpy(a.copy()) for name, a in jcache.items()}
    x = rng.standard_normal((B, 1, tcfg.d_model)).astype(np.float32)
    jx, jnew = jax_blocks.hybrid_block_decode(
        jcfg, _layer(jparams), jnp.asarray(x), jax.tree.map(jnp.asarray, jcache), jnp.asarray(pos)
    )
    tx = blocks.hybrid_block_decode(tcfg, tparams["blocks"][0], torch.from_numpy(x), tcache, torch.from_numpy(pos),
                                    attn_impl="kernel")
    assert _rel(tx, jx) < 4e-6
    for name in ("k", "v", "conv", "ssm"):
        assert _rel(tcache[name], jnew[name]) < 2e-6, name
    if layout == "dense":
        assert np.array_equal(tcache["pos"].numpy(), np.asarray(jnew["pos"]))
    assert hd == 16 and KV == 1


# ---------------------------------------------------------------------------
# prefill + decode_step
# ---------------------------------------------------------------------------

PROMPTS = (_prompt(40, 11), _prompt(37, 12))
STEPS = 6


def _jax_caches(jcfg, jparams, layout):
    """The JAX side: each prompt prefilled alone, then grafted into its
    slot's blocks (paged) or written into its ring row (dense)."""
    L, B = jcfg.num_layers, len(PROMPTS)
    if layout == "paged":
        cache = jax_init_paged_cache(jcfg, 1 + B * NB, BS, B, NB, jnp.float32)
    else:
        cache = jax_make_engine_cache(jcfg, B, 64, jnp.float32)
    logits = []
    for slot, p in enumerate(PROMPTS):
        lg, raw = jax_prefill(jcfg, jparams, {"tokens": jnp.asarray([p], jnp.int32)})
        logits.append(lg[0])
        if layout == "paged":
            blocks_ = list(range(1 + slot * NB, 1 + (slot + 1) * NB))
            cache = jax_graft(jcfg, cache, raw, jnp.asarray(blocks_, jnp.int32), len(p), slot)
        else:
            cache = jax_write_slot(jcfg, cache, jax_ring_from_prefill(jcfg, raw, seq_filled=len(p), decode_len=64), slot)
    if layout == "paged":
        tbl = np.arange(1, 1 + B * NB, dtype=np.int32).reshape(B, NB)
        cache["tbl"] = jnp.broadcast_to(jnp.asarray(tbl), (L, B, NB))
    return logits, cache


def _torch_caches(tcfg, tparams, layout):
    B = len(PROMPTS)
    if layout == "paged":
        cache = init_paged_cache(tcfg, 1 + B * NB, BS, B, NB, torch.float32, device="cpu")
        cache["tbl"].copy_(torch.arange(1, 1 + B * NB, dtype=torch.int32).reshape(B, NB))
    else:
        cache = make_engine_cache(tcfg, B, 64, torch.float32, device="cpu")
    logits = []
    for slot, p in enumerate(PROMPTS):
        lg, raw = prefill(tcfg, tparams, {"tokens": torch.tensor([p], dtype=torch.int32)})
        logits.append(lg[0])
        if layout == "paged":
            graft_prefill_into_blocks(tcfg, cache, raw, list(range(1 + slot * NB, 1 + (slot + 1) * NB)), len(p), slot)
        else:
            write_prefill_into_slot(tcfg, cache, raw, slot, seq_filled=len(p))
    return logits, cache


@pytest.mark.parametrize("layout,jax_impl", [("paged", "xla"), ("paged", "pallas"), ("dense", "xla")])
def test_prefill_and_decode_steps_match_jax(models, layout, jax_impl):
    jcfg, tcfg, jparams, tparams = models
    jlog, jcache = _jax_caches(jcfg, jparams, layout)
    tlog, tcache = _torch_caches(tcfg, tparams, layout)
    for a, b in zip(tlog, jlog):
        assert _rel(a, b) < 2e-5
    pos = np.array([len(p) for p in PROMPTS], np.int32)
    tok = np.array([[int(np.argmax(np.asarray(lg)))] for lg in jlog], np.int32)
    for step in range(STEPS):
        jl, jcache = jax_decode_step(jcfg, jparams, jcache, jnp.asarray(tok), jnp.asarray(pos), attn_impl=jax_impl)
        tl, tcache = decode_step(tcfg, tparams, tcache, torch.from_numpy(tok), torch.from_numpy(pos), attn_impl="kernel")
        assert _rel(tl, jl) < 2e-5, f"step {step}"
        tok = np.asarray(jnp.argmax(jl, axis=-1), np.int32)[:, None]
        pos = pos + 1
    for name in ("conv", "ssm"):
        assert _rel(tcache[name], jcache[name]) < 2e-5, name
        assert tcache[name].dtype == torch.float32


def test_paged_cache_bridge_carries_the_states(models):
    """``bridge.paged_cache_from_jax`` on a JAX hybrid paged cache (bf16
    pools and conv state, fp32 SSM state, both prompts grafted): every leaf
    bit for bit in its own dtype, the first layer's table; a decode step
    from the bridged cache gives the JAX step's logits to 2e-5."""
    from repro_torch.bridge import paged_cache_from_jax

    jcfg, tcfg, jparams, tparams = models
    B, L = len(PROMPTS), jcfg.num_layers
    jcache = jax_init_paged_cache(jcfg, 1 + B * NB, BS, B, NB, jnp.bfloat16)
    for slot, p in enumerate(PROMPTS):
        _, raw = jax_prefill(jcfg, jparams, {"tokens": jnp.asarray([p], jnp.int32)})
        jcache = jax_graft(jcfg, jcache, raw, jnp.arange(1 + slot * NB, 1 + (slot + 1) * NB, dtype=jnp.int32), len(p), slot)
    jcache["tbl"] = jnp.broadcast_to(jnp.arange(1, 1 + B * NB, dtype=jnp.int32).reshape(B, NB), (L, B, NB))
    tcache = paged_cache_from_jax({n: np.asarray(a) for n, a in jcache.items()}, device="cpu")
    assert set(tcache) == set(jcache) == {"k", "v", "tbl", "conv", "ssm"}
    for name, leaf in tcache.items():
        want = np.asarray(jcache[name])[0] if name == "tbl" else np.asarray(jcache[name])
        assert str(leaf.dtype).removeprefix("torch.") == str(want.dtype), name
        assert np.array_equal(leaf.float().numpy(), want.astype(np.float32)), name
    assert tcache["conv"].dtype == torch.bfloat16 and tcache["ssm"].dtype == torch.float32
    pos = np.array([len(p) for p in PROMPTS], np.int32)
    tok = np.array([[7], [9]], np.int32)
    jl, _ = jax_decode_step(jcfg, jparams, jcache, jnp.asarray(tok), jnp.asarray(pos))
    tl, _ = decode_step(tcfg, tparams, tcache, torch.from_numpy(tok), torch.from_numpy(pos))
    assert _rel(tl, jl) < 2e-5


def test_chunked_steps_refuse_the_family(models):
    """The recurrent states cannot resume mid-prompt: ``prefill_step`` (and
    with it ``verify_step`` and ``unified_step``) raise the JAX package's
    ``ValueError``."""
    jcfg, tcfg, jparams, tparams = models
    row = np.arange(1, NB + 1, dtype=np.int32)[None]
    jcache = jax.tree.map(lambda a: a, jax_init_paged_cache(jcfg, 1 + NB, BS, 1, NB, jnp.float32))
    with pytest.raises(ValueError) as jerr:
        jax_prefill_step(jcfg, jparams, jcache, jnp.zeros((1, 4), jnp.int32), jnp.zeros(1, jnp.int32), jnp.asarray(row))
    from repro_torch.models import unified_step, verify_step

    cache = init_paged_cache(tcfg, 1 + NB, BS, 1, NB, torch.float32, device="cpu")
    args = (torch.zeros((1, 4), dtype=torch.int32), torch.zeros(1, dtype=torch.int32), torch.from_numpy(row))
    for fn in (prefill_step, verify_step):
        with pytest.raises(ValueError) as terr:
            fn(tcfg, tparams, cache, *args)
        assert str(terr.value) == str(jerr.value)
    with pytest.raises(ValueError, match="no chunked prefill for family 'hybrid'"):
        unified_step(tcfg, tparams, cache, args[0], args[1], torch.tensor([4], dtype=torch.int32), args[2])


# ---------------------------------------------------------------------------
# the engine
# ---------------------------------------------------------------------------

ENGINE_PROMPTS = [_prompt(n, 20 + i) for i, n in enumerate((40, 9, 33, 3, 45, 17, 28))]
DTYPES = {"fp32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}


def _engines(models, **kw):
    jcfg, tcfg, jparams, tparams = models
    dtype = kw.pop("dtype", "bf16")
    jdt, tdt = DTYPES[dtype]
    je = JaxEngine(jcfg, jparams, clock=JaxClock(), cache_dtype=jdt, **kw)
    te = InferenceEngine(tcfg, tparams, clock=ManualClock(), cache_dtype=tdt, device="cpu", **kw)
    return je, te


def _drain_both(je, te, prompts, max_new):
    jreqs = [je.submit(p, max_new_tokens=m) for p, m in zip(prompts, max_new)]
    treqs = [te.submit(p, max_new_tokens=m) for p, m in zip(prompts, max_new)]
    je.run_until_drained()
    te.run_until_drained()
    return jreqs, treqs


def _stats_but_cache_bytes(s):
    return {k: v for k, v in s.items() if k != "cache_bytes"}


@pytest.mark.parametrize(
    "kind,quantize,dtype",
    [("paged", False, "bf16"), ("paged", "int8", "bf16"), ("paged", False, "fp32"), ("dense", False, "bf16")],
    ids=["paged-bf16", "paged-int8", "paged-fp32", "dense-bf16"],
)
def test_engine_matches_jax_engine(models, kind, quantize, dtype):
    """Three slots, block size 8, max_seq 64: the 40- to 45-token prompts
    run past the window of 32 while they decode."""
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)  # int8 pools under the kernel path
        je, te = _engines(models, max_batch=3, max_seq=64, block_size=BS, cache_kind=kind, quantize_kv=quantize,
                          eos_token=EOS_OUT, dtype=dtype)
    max_new = [10, 6, 12, 8, 9, 5, 11]
    jreqs, treqs = _drain_both(je, te, ENGINE_PROMPTS, max_new)
    assert all(r.state == RequestState.DONE for r in treqs)
    assert [r.generated for r in treqs] == [r.generated for r in jreqs]
    assert [r.finish_reason for r in treqs] == [r.finish_reason for r in jreqs]
    assert _stats_but_cache_bytes(te.stats()) == _stats_but_cache_bytes(je.stats())
    s = te.stats()
    assert s["cache_kind"] == kind and s["prefill_chunks"] == len(ENGINE_PROMPTS)
    if kind == "paged":
        assert s["alloc_blocks_in_use"] == 0 and s["alloc_total_allocs"] == s["alloc_total_frees"]
        assert not any(k.startswith("prefix_") for k in s)


def test_backpressure_when_blocks_run_out(models):
    """A pool of 11 usable blocks of 8 and requests of 34 + 14 tokens (6
    blocks each): one request at a time is admitted while the others wait
    in the queue with free slots, until the window returns a request's
    first block (at position 39), which lets the next one in before the
    first finishes.  The queue, slot and block counts after every step,
    the tokens and the stats equal the JAX engine's."""
    je, te = _engines(models, max_batch=3, max_seq=64, block_size=BS, num_blocks=12, eos_token=EOS_OUT)
    prompts = [_prompt(34, 40 + i) for i in range(4)]
    jreqs = [je.submit(p, max_new_tokens=14) for p in prompts]
    treqs = [te.submit(p, max_new_tokens=14) for p in prompts]
    trace = {"jax": [], "torch": []}
    while je.has_work or te.has_work:
        for name, eng in (("jax", je), ("torch", te)):
            eng.step()
            s = eng.stats()
            trace[name].append((s["requests_queued"], s["requests_active"], s["alloc_blocks_in_use"]))
    assert trace["torch"] == trace["jax"]
    assert trace["torch"][0] == (3, 1, 6)  # one admitted, three waiting with two slots free
    assert max(active for _, active, _ in trace["torch"]) == 2  # the window lets a second in
    assert [r.generated for r in treqs] == [r.generated for r in jreqs]
    assert _stats_but_cache_bytes(te.stats()) == _stats_but_cache_bytes(je.stats())
    assert te.stats()["alloc_blocks_in_use"] == 0


@pytest.mark.parametrize("kind", ["paged", "dense"])
def test_states_zeroed_at_finish(models, kind):
    """Two requests, 3 and 9 new tokens, stepped beside the JAX engine: in
    the step where the first finishes its slot's conv and SSM states go to
    zero in every layer while the second's are kept.  A decode step
    computes every slot, idle ones included, so the freed slot's states
    fill again from its idle row, as in the JAX engine: after the drain
    the states equal the JAX engine's to 2e-5 of their largest value."""
    je, te = _engines(models, max_batch=2, max_seq=64, block_size=BS, cache_kind=kind, eos_token=EOS_OUT)
    prompts, max_new = (_prompt(12, 1), _prompt(20, 2)), (3, 9)
    jr = [je.submit(p, max_new_tokens=m) for p, m in zip(prompts, max_new)]
    short, long_ = (te.submit(p, max_new_tokens=m) for p, m in zip(prompts, max_new))
    je.step()
    te.step()
    slots = (short.slot, long_.slot)
    assert sorted(slots) == [0, 1]
    for name in ("conv", "ssm"):
        assert all(bool(te.cache[name][:, s].any()) for s in slots), name
    while short.state != RequestState.DONE:
        je.step()
        te.step()
    assert long_.state == RequestState.ACTIVE and jr[0].state.value == "done"
    for name in ("conv", "ssm"):
        for cache in (te.cache, jax.tree.map(np.asarray, je.cache)):
            assert not cache[name][:, slots[0]].any(), name
            assert cache[name][:, slots[1]].any(), name
    je.run_until_drained()
    te.run_until_drained()
    assert [r.generated for r in (short, long_)] == [r.generated for r in jr]
    for name in ("conv", "ssm"):
        assert _rel(te.cache[name], je.cache[name]) < 2e-5, name
        assert not bool(te.cache[name][:, slots[1]].any()), name  # the last to finish


def _warning_texts(fn):
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        fn()
    return sorted(str(w.message) for w in caught if issubclass(w.category, RuntimeWarning))


@pytest.mark.parametrize(
    "kind,options",
    [("paged", dict(prefix_cache=True, prefill_budget=16, spec_decode="ngram", spill_bytes=1 << 20)),
     ("dense", dict(prefix_cache=True, prefill_budget=16, spec_decode="ngram", quantize_kv="int8"))],
)
def test_chunked_options_warn_and_fused_raises_as_jax(models, kind, options):
    jcfg, tcfg, jparams, tparams = models
    jw = _warning_texts(lambda: JaxEngine(jcfg, jparams, cache_kind=kind, max_seq=64, **options))
    holder = {}
    tw = _warning_texts(lambda: holder.setdefault(
        "eng", InferenceEngine(tcfg, tparams, cache_kind=kind, max_seq=64, device="cpu", **options)))
    assert tw == jw and len(tw) == 4
    eng = holder["eng"]
    assert not eng.chunked() and not eng.can_preempt() and eng.prefix is None and eng.spec_mode == "off"
    assert eng.spill is None
    r = eng.submit(_prompt(10, 3), max_new_tokens=3)
    eng.run_until_drained()
    assert r.finish_reason == "length"
    with pytest.raises(ValueError) as jerr:
        JaxEngine(jcfg, jparams, cache_kind=kind, fused=True)
    with pytest.raises(ValueError) as terr:
        InferenceEngine(tcfg, tparams, cache_kind=kind, fused=True, device="cpu")
    assert str(terr.value) == str(jerr.value)


def test_serve_launcher_serves_hymba(capsys):
    from repro_torch.launch.serve import main

    stats = main(["--device", "cpu", "--arch", ARCH, "--requests", "4", "--max-new", "4", "--block-size", "8"])
    out = capsys.readouterr().out
    assert "hymba-1.5b" in out and "on cpu" in out
    assert stats["cache_kind"] == "paged" and stats["requests_done"] == 4 and stats["alloc_blocks_in_use"] == 0
