"""The port's dense slot cache against the JAX package's.

``models.prefill`` (whole prompts, right-padded with ``last_index``) on
smoke olmo-1b, gemma-7b (logit softcap) and olmo-1b with a sliding window
shorter than the prompt, against ``repro.models.prefill`` on the same
weights: logits and raw K/V within 1e-5.  Then the slot surgery of
``serving.kvcache`` (``decode_cache_from_prefill``, ``write_request_into_slot``,
``clear_slot``, ``make_engine_cache``) and ``graft_prefill_into_blocks``,
fed the same raw K/V as the JAX functions, leaf for leaf: fp32 caches to
1e-5, bf16 and int8 caches equal (the same rounding of the same values).
``cache_bytes``, ``supports_paged`` and ``supports_chunked_prefill`` must
equal the JAX package's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config.model import reduce_for_smoke as jax_reduce
from repro.configs import get_config as jax_get_config
from repro.models import init_params as jax_init_params
from repro.models import prefill as jax_prefill
from repro.models.cache import cache_bytes as jax_cache_bytes
from repro.models.cache import init_paged_cache as jax_init_paged_cache
from repro.models.cache import supports_paged as jax_supports_paged
from repro.models.model import supports_chunked_prefill as jax_supports_chunked
from repro.serving import kvcache as jkv
from repro_torch.bridge import params_from_jax
from repro_torch.config import reduce_for_smoke
from repro_torch.configs import get_config
from repro_torch.models import cache_bytes, init_paged_cache, prefill, supports_chunked_prefill, supports_paged
from repro_torch.serving import kvcache as tkv

torch.set_num_threads(2)

# (arch, sliding window or None, prompt length, padded length)
CASES = [("olmo-1b", None, 13, 16), ("gemma-7b", None, 9, 16), ("olmo-1b", 8, 21, 32)]
IDS = ["olmo-1b", "gemma-7b-softcap", "olmo-1b-window-8"]
TORCH_DTYPE = {jnp.float32: torch.float32, jnp.bfloat16: torch.bfloat16}


def _models(arch, window):
    jcfg, tcfg = jax_reduce(jax_get_config(arch)), reduce_for_smoke(get_config(arch))
    if window is not None:
        jcfg, tcfg = jcfg.replace(sliding_window=window), tcfg.replace(sliding_window=window)
    jparams = jax_init_params(jcfg, jax.random.PRNGKey(0), jnp.float32)
    tparams = params_from_jax(tcfg, jax.tree.map(np.asarray, jparams), device="cpu")
    return jcfg, tcfg, jparams, tparams


def _batch(jcfg, n, padded, seed=0):
    """Two prompts right-padded to ``padded`` tokens: one ``n`` long, one
    shorter, with their last real indices."""
    rng = np.random.default_rng(seed)
    toks = np.zeros((2, padded), np.int32)
    lens = [n, max(n - 4, 1)]
    for b, m in enumerate(lens):
        toks[b, :m] = rng.integers(2, jcfg.vocab_size, m)
    return toks, np.array([m - 1 for m in lens], np.int32)


def _close(t, j, atol=1e-5):
    np.testing.assert_allclose(t.float().numpy(), np.asarray(j, np.float32), atol=atol, rtol=0)


def _to_torch(tree):
    return {k: torch.from_numpy(np.array(v, np.float32)) for k, v in tree.items()}


@pytest.mark.parametrize("arch,window,n,padded", CASES, ids=IDS)
def test_prefill_matches_jax(arch, window, n, padded):
    jcfg, tcfg, jparams, tparams = _models(arch, window)
    toks, last = _batch(jcfg, n, padded)
    jl, jraw = jax_prefill(jcfg, jparams, {"tokens": jnp.asarray(toks), "last_index": jnp.asarray(last)})
    tl, traw = prefill(tcfg, tparams, {"tokens": torch.from_numpy(toks), "last_index": torch.from_numpy(last)})
    assert tl.shape == (2, tcfg.padded_vocab)
    _close(tl, jl)
    for name in ("k", "v"):
        assert traw[name].shape == (tcfg.num_layers, 2, padded, tcfg.num_kv_heads, tcfg.head_dim)
        _close(traw[name], jraw[name])
    # without last_index the logits are the last position's
    jl_end, _ = jax_prefill(jcfg, jparams, {"tokens": jnp.asarray(toks)})
    tl_end, _ = prefill(tcfg, tparams, {"tokens": torch.from_numpy(toks)})
    _close(tl_end, jl_end)


def test_prefill_query_chunks_match_whole_prompt():
    jcfg, tcfg, jparams, tparams = _models("olmo-1b", None)
    toks, last = _batch(jcfg, 16, 16)
    batch = {"tokens": torch.from_numpy(toks), "last_index": torch.from_numpy(last)}
    whole, raw = prefill(tcfg, tparams, batch)
    chunked, raw_c = prefill(tcfg, tparams, batch, q_chunk=4)
    jl, _ = jax_prefill(jcfg, jparams, {"tokens": jnp.asarray(toks), "last_index": jnp.asarray(last)}, q_chunk=4)
    _close(chunked, jl)
    torch.testing.assert_close(chunked, whole, atol=1e-5, rtol=0)
    torch.testing.assert_close(raw_c["k"], raw["k"], atol=0, rtol=0)


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("arch,window,n,padded", CASES, ids=IDS)
def test_slot_surgery_matches_jax(arch, window, n, padded, dtype):
    """One raw K/V (the JAX prefill's) through both packages' ring-cache
    surgery: a request's cache from its prefill (the window case wraps),
    written into slot 1 of an engine cache whose slot 0 holds another
    request, then slot 1 cleared.  The engine's one-step admission
    (``write_prefill_into_slot``, straight from the raw K/V) fills the same
    slots, also over a slot that a longer request left uncleared."""
    jcfg, tcfg, jparams, _ = _models(arch, window)
    tdt = TORCH_DTYPE[dtype]
    max_seq = 48
    caches = {}
    for slot_req, seed in ((0, 1), (1, 2)):
        toks, last = _batch(jcfg, n, padded, seed)
        _, jraw = jax_prefill(jcfg, jparams, {"tokens": jnp.asarray(toks[:1]), "last_index": jnp.asarray(last[:1])})
        jreq = jkv.decode_cache_from_prefill(jcfg, jraw, seq_filled=n, decode_len=max_seq)
        treq = tkv.decode_cache_from_prefill(tcfg, _to_torch(jraw), seq_filled=n, decode_len=max_seq)
        for name in ("k", "v", "pos"):
            assert tuple(treq[name].shape) == jreq[name].shape, name
            _close(treq[name], jreq[name], atol=0)
        caches[slot_req] = (jreq, treq, _to_torch(jraw))
    jeng = jkv.make_engine_cache(jcfg, 3, max_seq, dtype)
    teng = tkv.make_engine_cache(tcfg, 3, max_seq, tdt, device="cpu")
    assert {k: v.dtype for k, v in teng.items()} == {"k": tdt, "v": tdt, "pos": torch.int32}
    direct = tkv.make_engine_cache(tcfg, 3, max_seq, tdt, device="cpu")
    # slot 2 first holds a request 7 tokens longer, left uncleared
    long_toks, long_last = _batch(jcfg, n + 7, n + 7, 3)
    _, long_raw = jax_prefill(jcfg, jparams, {"tokens": jnp.asarray(long_toks[:1]),
                                              "last_index": jnp.asarray(long_last[:1])})
    tkv.write_prefill_into_slot(tcfg, direct, _to_torch(long_raw), 2, seq_filled=n + 7)
    for slot, (jreq, treq, traw) in caches.items():
        jeng = jkv.write_request_into_slot(jcfg, jeng, jreq, slot)
        assert tkv.write_request_into_slot(tcfg, teng, treq, slot) is teng  # in place
        assert tkv.write_prefill_into_slot(tcfg, direct, traw, slot, seq_filled=n) is direct
    tkv.write_prefill_into_slot(tcfg, direct, caches[1][2], 2, seq_filled=n)
    for name in ("k", "v", "pos"):
        assert torch.equal(direct[name][:, :2], teng[name][:, :2]), name
    filled = direct["pos"][:, 2] >= 0  # the stale rows past the prompt sit under position -1
    assert torch.equal(direct["pos"][:, 2], teng["pos"][:, 1])
    for name in ("k", "v"):
        assert torch.equal(direct[name][:, 2][filled], teng[name][:, 1][filled]), name

    def same():
        for name in ("k", "v", "pos"):
            if dtype == jnp.float32 or name == "pos":
                _close(teng[name], jeng[name])
            else:  # the same rounding of the same values
                assert torch.equal(teng[name], torch.from_numpy(np.asarray(jeng[name].astype(jnp.float32))).to(tdt))

    same()
    jeng = jkv.clear_slot(jcfg, jeng, 1)
    tkv.clear_slot(tcfg, teng, 1)
    same()
    assert bool((teng["pos"][:, 1] == -1).all()) and not bool((teng["pos"][:, 0] == -1).all())


@pytest.mark.parametrize("quantized", [False, "int8"], ids=["bf16", "int8"])
def test_graft_prefill_into_blocks_matches_jax(quantized):
    """A 21-token prefill padded to 32 into three blocks of 8 of a bf16 (or
    int8) pool: rows past ``seq_filled`` zero, the table untouched."""
    jcfg, tcfg, jparams, _ = _models("olmo-1b", None)
    toks, last = _batch(jcfg, 21, 32)
    _, jraw = jax_prefill(jcfg, jparams, {"tokens": jnp.asarray(toks[:1]), "last_index": jnp.asarray(last[:1])})
    blocks = [3, 1, 5]
    jpool = jax_init_paged_cache(jcfg, 7, 8, 2, 4, jnp.bfloat16, quantized=quantized)
    jpool = jkv.graft_prefill_into_blocks(jcfg, jpool, jraw, blocks, 21, 0)
    tpool = init_paged_cache(tcfg, 7, 8, 2, 4, torch.bfloat16, quantized=quantized, device="cpu")
    assert tkv.graft_prefill_into_blocks(tcfg, tpool, _to_torch(jraw), blocks, 21, 0) is tpool
    for name, leaf in tpool.items():
        ref = np.asarray(jpool[name].astype(jnp.float32)) if name != "tbl" else np.asarray(jpool[name])[0]
        if leaf.dtype == torch.bfloat16:
            assert torch.equal(leaf, torch.from_numpy(ref).to(torch.bfloat16)), name
        elif name.endswith("_scale"):
            _close(leaf, ref, atol=0)
        else:
            assert np.array_equal(leaf.numpy().astype(np.float32), ref.astype(np.float32)), name
    k = tpool["k"].float()
    assert bool((k[:, 5, 5:] == 0).all()) and bool((k[:, 5, :5] != 0).any())  # positions 21..23 zero
    assert bool((k[:, [0, 2, 4, 6]] == 0).all())  # blocks not allocated to the request


@pytest.mark.parametrize(
    "arch,window",
    [("olmo-1b", None), ("gemma-7b", None), ("olmo-1b", 8), ("mistral-nemo-12b", None), ("hymba-1.5b", None),
     ("rwkv6-7b", None)],
)
@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16], ids=["fp32", "bf16"])
def test_cache_bytes_and_families_match_jax(arch, window, dtype):
    jcfg, tcfg = jax_reduce(jax_get_config(arch)), reduce_for_smoke(get_config(arch))
    if window is not None:
        jcfg, tcfg = jcfg.replace(sliding_window=window), tcfg.replace(sliding_window=window)
    for B, seq in ((1, 16), (4, 128), (3, 5)):
        expect = jax_cache_bytes(jcfg, B, seq, dtype)
        assert cache_bytes(tcfg, B, seq, TORCH_DTYPE[dtype]) == expect
        made = tkv.make_engine_cache(tcfg, B, seq, TORCH_DTYPE[dtype], device="cpu")
        assert sum(t.numel() * t.element_size() for t in made.values()) == expect
    for name in ("olmo-1b", "rwkv6-7b", "bert-large", "stablelm-12b", "hymba-1.5b", "llama-3.2-vision-90b"):
        jc, tc = jax_get_config(name), get_config(name)
        assert supports_paged(tc) == jax_supports_paged(jc)
        assert supports_chunked_prefill(tc) == jax_supports_chunked(jc)


def test_prefill_refuses_other_families():
    """Every decoder family the JAX package serves has a prefill in the
    port; a family it has not (here audio, an encoder, and an unknown one)
    raises ``NotImplementedError`` naming it, before any weight is read."""
    base = reduce_for_smoke(get_config("olmo-1b"))
    for family in ("audio", "unknown"):
        with pytest.raises(NotImplementedError, match=family):
            prefill(base.replace(family=family), {}, {"tokens": torch.zeros((1, 4), dtype=torch.int32)})
