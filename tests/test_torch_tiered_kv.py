"""The port's host spill tier against the JAX package's.

* The ``SpillPool`` twin on its own: round trip, byte budget, LRU drops
  with ``on_drop``, refusals and the staging ring (the JAX package's
  ``tests/test_paged.py`` cases), then one seeded sequence of puts, gets,
  pops, touches, discards and flushes driven into the JAX pool and the
  port's: handles, ``bytes_used``, ``stats()`` and every returned row
  equal, for fp32, bf16 and int8 (with scale) leaves in each at-rest mode.
  bf16 and e4m3 rows spill their native bytes in every mode, as the JAX
  pool does (its float test is false for ml_dtypes' types).
* The int8 and fp8 at-rest codecs on fp32 rows: codes and scales bit-equal
  to the JAX pool's, and their decompression.
* ``gather_block_rows``, ``restore_block_rows``, ``copy_block_rows`` and
  ``truncate_block_rows`` with scale leaves against the JAX ``kvcache``.
* The JAX package's tiered cases that the port serves (olmo-1b; a window
  of 8; int8 at rest; an int8 pool; qwen3-moe at capacity factor 8, as
  ``tests/test_tiered_kv.py`` runs it) and arctic over an int8 pool at
  capacity factor 8: the port's spill engine against the
  JAX spill engine in the legacy and the fused walk, tokens, finish reasons
  and every integer stat but ``cache_bytes``, and against the port's
  drop-on-evict engine token for token.
* Preemption and abort while swap-ins are pending leave no residue.
* Knob validation.
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
from repro.serving import SpillPool as JaxSpillPool
from repro.serving import kvcache as jax_kvcache
from repro.serving.kvquant import quantize as jax_quantize
from repro_torch.bridge import paged_cache_from_jax, params_from_jax
from repro_torch.config import reduce_for_smoke
from repro_torch.configs import get_config
from repro_torch.serving import (
    InferenceEngine,
    RequestState,
    SpillPool,
    copy_block_rows,
    gather_block_rows,
    restore_block_rows,
    truncate_block_rows,
)

torch.set_num_threads(2)

EOS_OUT = 1 << 30  # outside every vocab: requests run to their length


def _np(t) -> np.ndarray:
    """A tensor or array as numpy bits: bf16 / e4m3 by their integers."""
    if isinstance(t, torch.Tensor):
        if t.dtype in (torch.bfloat16, torch.float8_e4m3fn):
            return t.view(torch.int16 if t.dtype == torch.bfloat16 else torch.uint8).numpy()
        return t.numpy()
    a = np.asarray(t)
    if a.dtype.name in ("bfloat16", "float8_e4m3fn"):
        return a.view(np.int16 if a.dtype.itemsize == 2 else np.uint8)
    return a


# ---------------------------------------------------------------------------
# the SpillPool twin
# ---------------------------------------------------------------------------


def _tiny_rows(tag: float) -> dict:
    """A recognizable 8-byte payload standing in for one block's rows."""
    return {"k": torch.full((2,), tag)}


def test_spill_pool_roundtrip_and_budget():
    drops = []
    pool = SpillPool(16, mode="cache", staging_depth=0, on_drop=drops.append)
    h1 = pool.put(_tiny_rows(1.0))
    h2 = pool.put(_tiny_rows(2.0))
    assert h1 < 0 and h2 < 0 and h1 != h2, "handles are distinct negatives"
    assert pool.bytes_used == 16 and len(pool) == 2
    h3 = pool.put(_tiny_rows(3.0))  # over budget: the LRU entry (h1) drops
    assert drops == [h1] and h1 not in pool and len(pool) == 2
    assert float(pool.get(h2)["k"][0]) == 2.0  # get keeps the entry
    h4 = pool.put(_tiny_rows(4.0))  # h2 was bumped by get: h3 drops
    assert drops == [h1, h3]
    assert float(pool.pop(h4)["k"][0]) == 4.0  # pop removes
    assert h4 not in pool and pool.bytes_used == 8
    assert pool.put(_tiny_rows(9.0) | {"pad": torch.zeros(30)}) is None
    assert pool.refused == 1, "an entry alone exceeding capacity is refused"
    s = pool.stats()
    assert s["spills"] == 4 and s["drops"] == 2 and s["blocks"] == 1


def test_spill_pool_staging_defers_materialization():
    pool = SpillPool(1 << 20, mode="cache", staging_depth=2)
    staged = [_tiny_rows(float(i)) for i in (1, 2, 3)]
    h1, h2, h3 = (pool.put(p) for p in staged)
    # depth 2: h1 was pushed out of the staging ring by h3's put
    assert pool.stats()["staged"] == 2
    assert pool._payload[h2]["k"] is staged[1]["k"], "a staged entry keeps its tensors"
    assert pool._payload[h1]["k"].device.type == "cpu"
    pool.flush()
    assert pool.stats()["staged"] == 0
    for h, tag in ((h1, 1.0), (h2, 2.0), (h3, 3.0)):
        assert float(pool.get(h)["k"][0]) == tag


def _payload(rng, dtype: str) -> tuple[dict, dict]:
    """One block's rows (L=2, bs=4, KV=2, hd=8) for the JAX pool and the
    port's pool, the same values: fp32 or bf16 float leaves, or int8 codes
    with their fp32 scale leaves."""
    x = {n: rng.standard_normal((2, 4, 2, 8)).astype(np.float32) * 3 for n in ("k", "v")}
    if dtype == "int8":
        j = {}
        for n in ("k", "v"):
            j[n], j[f"{n}_scale"] = jax_quantize(jnp.asarray(x[n]))
        return j, {n: torch.from_numpy(np.array(a)) for n, a in j.items()}
    if dtype == "bf16":
        j = {n: jnp.asarray(a, jnp.bfloat16) for n, a in x.items()}
        return j, {n: torch.from_numpy(a).bfloat16() for n, a in x.items()}
    return {n: jnp.asarray(a) for n, a in x.items()}, {n: torch.from_numpy(a) for n, a in x.items()}


def _returned(rows: dict) -> dict:
    return {n: _np(t) for n, t in sorted(rows.items())}


@pytest.mark.parametrize("mode", ["cache", "int8", "fp8"])
@pytest.mark.parametrize("dtype", ["fp32", "bf16", "int8"])
def test_spill_pool_matches_jax(dtype, mode):
    """One seeded sequence of pool operations, driven into both pools."""
    rng = np.random.default_rng(17)
    payloads = [_payload(rng, dtype) for _ in range(9)]
    one = JaxSpillPool(1 << 30, mode=mode).entry_nbytes(payloads[0][0])
    assert one == SpillPool(1 << 30, mode=mode).entry_nbytes(payloads[0][1])
    jdrops, tdrops = [], []
    jp = JaxSpillPool(3 * one + one // 2, mode=mode, staging_depth=1, on_drop=jdrops.append)
    tp = SpillPool(3 * one + one // 2, mode=mode, staging_depth=1, on_drop=tdrops.append)
    jh, th, jout, tout = [], [], [], []
    ops = rng.integers(0, 6, 40)
    for i, op in enumerate(ops):
        live = [h for h in jh if h in jp]
        if op <= 1 or not live:
            j, t = payloads[i % len(payloads)]
            jh.append(jp.put(j))
            th.append(tp.put(t))
            continue
        h = live[int(rng.integers(len(live)))]
        if op == 2:
            jout.append(_returned(jp.get(h)))
            tout.append(_returned(tp.get(h)))
        elif op == 3:
            jout.append(_returned(jp.pop(h)))
            tout.append(_returned(tp.pop(h)))
        elif op == 4:
            jp.touch(h)
            tp.touch(h)
        else:
            jp.discard(h) if i % 2 else jp.flush()
            tp.discard(h) if i % 2 else tp.flush()
        assert jp.bytes_used == tp.bytes_used and jp.stats() == tp.stats(), f"op {i}"
    assert th == jh and tdrops == jdrops and len(jout) == len(tout) > 0
    for a, b in zip(tout, jout):
        assert a.keys() == b.keys()
        for n in a:
            assert a[n].dtype == b[n].dtype and np.array_equal(a[n], b[n]), n
    assert tp.stats() == jp.stats() and tp.stats()["drops"] > 0
    if dtype == "bf16":  # the pool-native quirk: nothing compresses
        assert tp.entry_nbytes(payloads[0][1]) == 2 * 2 * 4 * 2 * 8 * 2


@pytest.mark.parametrize("mode", ["int8", "fp8"])
def test_at_rest_codecs_bit_equal(mode):
    jrows, trows = _payload(np.random.default_rng(23), "fp32")
    jc, tc = JaxSpillPool(1 << 20, mode=mode)._compress(jrows), SpillPool(1 << 20, mode=mode)._compress(trows)
    assert sorted(jc) == sorted(tc) == ["k", "k@qscale", "v", "v@qscale"]
    for n in jc:
        assert np.array_equal(_np(tc[n]), _np(jc[n])), n
    jd = JaxSpillPool(1 << 20, mode=mode)._decompress(jc)
    td = SpillPool(1 << 20, mode=mode)._decompress(tc)
    for n in ("k", "v"):
        assert td[n].dtype == torch.float32 and np.array_equal(td[n].numpy(), np.asarray(jd[n])), n


# ---------------------------------------------------------------------------
# block ops with scale leaves
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mode", ["int8", "fp8"])
def test_block_ops_with_scales_match_jax(mode):
    rng = np.random.default_rng(31)
    L, N, bs, KV, hd = 2, 7, 4, 2, 8
    jc = {}
    for n in ("k", "v"):
        jc[n], jc[f"{n}_scale"] = jax_quantize(jnp.asarray(rng.standard_normal((L, N, bs, KV, hd)), jnp.float32), mode)
    tc = paged_cache_from_jax({n: np.asarray(a) for n, a in jc.items()}, device="cpu")

    def same(tag):
        for n in jc:
            assert np.array_equal(_np(tc[n]), _np(jc[n])), f"{tag}: {n}"

    jrows, trows = jax_kvcache.gather_block_rows(jc, jnp.asarray(3)), gather_block_rows(tc, 3)
    assert sorted(trows) == sorted(jrows) == ["k", "k_scale", "v", "v_scale"]
    for n in jrows:
        assert np.array_equal(_np(trows[n]), _np(jrows[n])), n
    before = {n: t.clone() for n, t in trows.items()}
    jc = jax_kvcache.copy_block_rows(jc, jnp.asarray(5), jnp.asarray(3))
    copy_block_rows(tc, 5, 3)
    same("copy")
    for n in trows:  # the gathered payload is a copy, not a view of block 3
        assert np.array_equal(_np(trows[n]), _np(before[n])), n
    stacked_j = {n: jnp.stack([a, a], axis=1) for n, a in jrows.items()}
    stacked_t = {n: torch.stack([a, a], dim=1) for n, a in trows.items()}
    jc = jax_kvcache.restore_block_rows(jc, jnp.asarray([1, 6], jnp.int32), stacked_j)
    restore_block_rows(tc, torch.tensor([1, 6], dtype=torch.int32), stacked_t)
    same("restore")
    tbl = np.array([[1, 6, 0], [2, 4, 5]], np.int32)
    start, end = np.array([2, 5], np.int32), np.array([7, 8], np.int32)
    jc = jax_kvcache.truncate_block_rows(jc, jnp.asarray(tbl), jnp.asarray(start), jnp.asarray(end), span=5)
    truncate_block_rows(tc, torch.from_numpy(tbl), torch.from_numpy(start), torch.from_numpy(end), span=5)
    same("truncate")


# ---------------------------------------------------------------------------
# engines
# ---------------------------------------------------------------------------


def _group_prompts(groups=4, pre_len=24):
    """One prompt per group: a distinct 24-token prefix (3 full blocks at
    block size 8) plus a unique tail token.  Submitted over two rounds
    against a pool too small for all chains, round 2 finds round 1's chains
    evicted: dropped or spilled depending on the tier."""
    return [[10 + g * 40 + i for i in range(pre_len)] + [200 + g] for g in range(groups)]


def _drive(eng, rounds=2, max_new=5):
    reqs = []
    for _ in range(rounds):
        for p in _group_prompts():
            reqs.append(eng.submit(p, max_new_tokens=max_new))
            eng.run_until_drained()
    return reqs


def _bridged(window=0, arch="olmo-1b"):
    jcfg = jax_reduce(jax_get_config(arch))
    tcfg = reduce_for_smoke(get_config(arch))
    if jcfg.moe is not None:  # capacity cannot bind: cf >= num_experts / top_k (the JAX test's setting)
        jcfg = jcfg.replace(moe=dataclasses.replace(jcfg.moe, capacity_factor=8.0))
        tcfg = tcfg.replace(moe=dataclasses.replace(tcfg.moe, capacity_factor=8.0))
    if window:
        jcfg, tcfg = jcfg.replace(sliding_window=window), tcfg.replace(sliding_window=window)
    jparams = jax_init_params(jcfg, jax.random.PRNGKey(0), jnp.float32)
    return jcfg, tcfg, jparams, params_from_jax(tcfg, jax.tree.map(np.asarray, jparams), device="cpu")


def _engine(cls, cfg, params, **kw):
    base = dict(max_batch=2, max_seq=64, block_size=8, eos_token=EOS_OUT)
    base.update(kw)
    base.update(cache_dtype=jnp.float32) if cls is JaxEngine else base.update(cache_dtype=torch.float32, device="cpu")
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        return cls(cfg, params, **base)


def _int_stats(s: dict) -> dict:
    return {k: v for k, v in s.items() if type(v) is int and k != "cache_bytes"}


# sliding window, extra engine knobs, arch: the JAX package's TIERED_CASES
# that the port serves, and an int8 pool under arctic
TIERED_CASES = {
    "olmo_1b": (0, {}, "olmo-1b"),
    "window_8": (8, {}, "olmo-1b"),
    "int8_at_rest": (0, {"spill_dtype": "int8"}, "olmo-1b"),
    "int8_pool": (0, {"quantize_kv": True}, "olmo-1b"),
    "qwen3_moe": (0, {}, "qwen3-moe-235b-a22b"),
    "arctic_int8_pool": (0, {"quantize_kv": True}, "arctic-480b"),
}


@pytest.mark.parametrize("name", list(TIERED_CASES))
def test_spill_engine_matches_jax(name):
    window, extra, arch = TIERED_CASES[name]
    jcfg, tcfg, jparams, tparams = _bridged(window, arch)
    paged = dict(num_blocks=10, prefill_budget=8, **extra)  # 9 usable blocks
    out = {}
    for side, cls, cfg, params in (("jax", JaxEngine, jcfg, jparams), ("torch", InferenceEngine, tcfg, tparams)):
        for fused in (False, True):
            eng = _engine(cls, cfg, params, spill_bytes=8 << 20, fused=fused, **paged)
            reqs = _drive(eng)
            assert eng.allocator.blocks_in_use == 0
            out[side, fused] = ([list(r.generated) for r in reqs], [r.finish_reason for r in reqs], eng.stats())
    drop = _engine(InferenceEngine, tcfg, tparams, **paged)
    drop_tokens = [list(r.generated) for r in _drive(drop)]
    for fused in (False, True):
        (jt, jr, js), (tt, tr, ts) = out["jax", fused], out["torch", fused]
        assert tt == jt == drop_tokens and tr == jr == ["length"] * len(tr), f"fused={fused}"
        assert _int_stats(ts) == _int_stats(js), f"fused={fused}"
        assert ts["alloc_evictions_spilled"] > 0 and ts["restores"] > 0 and ts["spill_hit_tokens"] > 0
        assert ts["restores_pending"] == 0
        assert ts["prefill_tokens"] < drop.stats()["prefill_tokens"], "round 2 restores instead of prefilling"


def _restore_setup():
    """An engine, a spilled 3-block chain and a request admitted against it
    with ``restore_budget=1``, stepped once: one block restored, two
    swap-ins still pending."""
    _, tcfg, _, tparams = _bridged()
    eng = _engine(InferenceEngine, tcfg, tparams, max_batch=1, num_blocks=12, prefill_budget=8, restore_budget=1,
                  spill_bytes=1 << 20)
    p_low = list(range(2, 26)) + [30]  # 24 tokens = 3 full blocks at block size 8
    r0 = eng.submit(p_low, max_new_tokens=4)
    eng.run_until_drained()
    blks = eng.allocator.alloc(eng.allocator.num_free)  # churn: every cached chain spills
    eng.allocator.free(blks)
    assert len(eng.spill) >= 3, "the chain must be fully spilled"
    r1 = eng.submit(p_low, max_new_tokens=4)
    eng.step()  # admit: 3 swap-ins queued, the budget runs 1
    assert r1.pending_restores and len(eng._restore_q) == 2
    return eng, tcfg, tparams, p_low, r0, r1


def test_mid_restore_preemption_token_identical():
    eng, tcfg, tparams, p_low, r0, r1 = _restore_setup()
    rh = eng.submit([40, 41, 42], max_new_tokens=4, priority=5)
    eng.step()  # SLO preemption evicts the mid-restore victim
    assert r1.state == RequestState.WAITING and r1.preemptions == 1
    assert not eng._restore_q and not eng._restoring, "cancel left tasks queued"
    assert eng.stats()["restores_cancelled"] >= 1
    assert eng.stats()["prefix_demoted"] >= 1, "payloads must re-park in the pool"
    eng.run_until_drained()
    assert r1.state == RequestState.DONE and rh.state == RequestState.DONE
    assert r1.generated == r0.generated, "the resumed spill-hit decode diverged"
    ref = _engine(InferenceEngine, tcfg, tparams, max_batch=1)
    rr = ref.submit([40, 41, 42], max_new_tokens=4)
    ref.run_until_drained()
    assert rh.generated == rr.generated
    assert eng.allocator.blocks_in_use == 0
    assert not eng._restore_q and not eng._restoring
    assert all(not r.pending_restores for r in eng.done)
    assert eng.spill.bytes_used == sum(eng.spill._nbytes.values())


def test_mid_restore_abort_zero_residue():
    eng, _, _, p_low, r0, r1 = _restore_setup()
    assert len(eng.spill) == 0  # admission popped every spilled payload
    assert eng.abort(r1)
    assert r1.state == RequestState.DONE and r1.finish_reason == "aborted"
    assert not eng._restore_q and not eng._restoring and not r1.pending_restores
    assert eng.allocator.blocks_in_use == 0, "abort leaked blocks mid-restore"
    assert eng.stats()["restores_cancelled"] == 2
    assert len(eng.spill) == 2  # the two payloads never copied demoted back
    r2 = eng.submit(p_low, max_new_tokens=4)
    eng.run_until_drained()
    assert r2.generated == r0.generated
    assert eng.allocator.blocks_in_use == 0
    assert eng.stats()["spill_hit_tokens"] > 0


def test_spill_knob_validation():
    _, tcfg, _, tparams = _bridged()
    kw = dict(max_batch=2, max_seq=64, block_size=8, device="cpu")
    with pytest.raises(ValueError, match="spill_dtype"):
        InferenceEngine(tcfg, tparams, spill_dtype="fp4", **kw)
    with pytest.raises(ValueError, match="restore_budget"):
        InferenceEngine(tcfg, tparams, restore_budget=0, **kw)
    with pytest.warns(RuntimeWarning, match="spill_bytes needs the prefix cache"):
        off = InferenceEngine(tcfg, tparams, prefix_cache=False, spill_bytes=1 << 20, **kw)
    assert off.spill is None
    with pytest.warns(RuntimeWarning, match="re-quantize"):
        q8 = InferenceEngine(tcfg, tparams, cache_dtype=torch.float32, quantize_kv=True, spill_bytes=1 << 20,
                             spill_dtype="fp8", **kw)
    assert q8.spill is not None and q8.spill.mode == "cache"
