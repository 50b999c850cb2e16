"""Quantized KV pools of the PyTorch port against the JAX package.

* ``serving.kvquant.quantize`` bit for bit against the JAX ``quantize``
  (codes and scales) in int8 and fp8, on seeded normals, a row with one
  outlier and an all-zero row (the 1e-8 scale floor).
* The quantized paged cache's layout: pool dtypes, scale leaves and
  shapes as the JAX ``init_paged_cache(quantized=...)``.
* The plain dequantizing reads against the JAX references with scales,
  within 1e-5 (the same function, sums in another order).
* ``paged_chunk_attention`` / ``paged_decode_attention`` on quantized
  pools: the pools and scale leaves bit-equal to the JAX package's after
  the write, the outputs within 1e-5.
* The engine with ``quantize_kv="int8"|"fp8"`` against the JAX engine, in
  the legacy and the fused walk and with ``spec_decode="ngram"``: greedy
  tokens, finish reasons and every integer stat but ``cache_bytes`` (the
  port keeps one block table, the JAX engine one per layer).  The eos id
  lies outside the vocab.
* ``cache_bytes``: fp8 pools equal int8 pools, both below bf16.
* K1/K2's entry points refuse quantized pools.
"""

import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config.model import reduce_for_smoke as jax_reduce
from repro.configs import get_config as jax_get_config
from repro.kernels.paged_attention_ref import paged_attention_ref, paged_prefill_attention_ref
from repro.models import init_paged_cache as jax_init_paged_cache
from repro.models import init_params as jax_init_params
from repro.models.attention import paged_chunk_attention as jax_chunk_attention
from repro.models.attention import paged_decode_attention as jax_decode_attention
from repro.serving import InferenceEngine as JaxEngine
from repro.serving.kvquant import quantize as jax_quantize
from repro_torch.bridge import paged_cache_from_jax, params_from_jax
from repro_torch.config import reduce_for_smoke
from repro_torch.configs import get_config
from repro_torch.kernels import paged_attention as K
from repro_torch.models import init_paged_cache
from repro_torch.models.attention import paged_chunk_attention, paged_decode_attention
from repro_torch.serving import InferenceEngine, kv_storage_dtype, normalize_kv_quant, quantize

torch.set_num_threads(2)

MODES = ("int8", "fp8")
EOS_OUT = 1 << 30  # outside every vocab: requests run to their length
BS, NB, NBLK = 8, 4, 9


def _bits(a) -> np.ndarray:
    """Codes as comparable integers: int8 as it is, e4m3 by its byte."""
    if isinstance(a, torch.Tensor):
        return (a.view(torch.uint8) if a.dtype == torch.float8_e4m3fn else a).numpy()
    a = np.asarray(a)
    return a.view(np.uint8) if a.dtype.itemsize == 1 and a.dtype != np.int8 else a


def _rows(kind: str) -> np.ndarray:
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 24, 3, 16)).astype(np.float32) * 2.5
    if kind == "outlier":
        x[1, 5, 2, 7] = 900.0  # past e4m3's 448 once scaled: the clip before the cast
    elif kind == "zero":
        x[0, 3] = 0.0  # amax 0: the 1e-8 floor
    return x


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("kind", ["normal", "outlier", "zero"])
def test_quantize_bit_equal_to_jax(mode, kind):
    x = _rows(kind)
    jq, js = jax_quantize(jnp.asarray(x), mode)
    tq, ts = quantize(torch.from_numpy(x), mode)
    assert tq.dtype == kv_storage_dtype(mode) and ts.dtype == torch.float32
    assert np.array_equal(_bits(tq), _bits(jq))
    assert np.array_equal(ts.numpy(), np.asarray(js))
    if kind == "zero":
        assert float(ts[0, 3].max()) == pytest.approx(1e-8) and not _bits(tq)[0, 3].any()


def test_normalize_kv_quant():
    assert normalize_kv_quant(True) == "int8" and normalize_kv_quant(False) is None
    assert normalize_kv_quant("fp8") == "fp8"
    with pytest.raises(ValueError, match="quantize_kv"):
        normalize_kv_quant("int4")


def _configs(arch="olmo-1b"):
    return jax_reduce(jax_get_config(arch)), reduce_for_smoke(get_config(arch))


@pytest.mark.parametrize("mode", MODES)
def test_quantized_cache_layout(mode):
    jcfg, tcfg = _configs()
    jc = jax_init_paged_cache(jcfg, NBLK, BS, 2, NB, jnp.float32, quantized=mode)
    tc = init_paged_cache(tcfg, NBLK, BS, 2, NB, torch.float32, quantized=mode, device="cpu")
    assert set(tc) == set(jc) == {"k", "v", "tbl", "k_scale", "v_scale"}
    L, KV, hd = tcfg.num_layers, tcfg.num_kv_heads, tcfg.head_dim
    assert tc["k"].shape == tc["v"].shape == (L, NBLK, BS, KV, hd)
    assert tc["k_scale"].shape == tc["v_scale"].shape == (L, NBLK, BS, KV, 1)
    assert tc["k"].dtype == kv_storage_dtype(mode) and tc["k_scale"].dtype == torch.float32
    for name in ("k", "v", "k_scale", "v_scale"):
        assert tuple(jc[name].shape) == tuple(tc[name].shape), name
    assert tc["tbl"].shape == (2, NB)  # one table for every layer


def _quantized_pools(mode, seed, N=NBLK, KV=2, hd=16):
    rng = np.random.default_rng(seed)
    out = {}
    for name in ("k", "v"):
        q, s = jax_quantize(jnp.asarray(rng.standard_normal((N, BS, KV, hd)).astype(np.float32)), mode)
        out[name], out[f"{name}_scale"] = q, s
    return out


def _to_torch(jpools):
    return paged_cache_from_jax({n: np.asarray(a) for n, a in jpools.items()}, device="cpu")


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("kind", ["decode", "prefill"])
def test_plain_quantized_reads_match_jax(mode, kind):
    jp = _quantized_pools(mode, seed=5)
    tp = _to_torch(jp)
    rng = np.random.default_rng(6)
    H = 4
    tbl = np.array([[3, 1, 7, 0], [2, 5, 0, 0]], np.int32)
    if kind == "decode":
        q = rng.standard_normal((2, H, 16)).astype(np.float32)
        lens = np.array([27, 11], np.int32)
        ref = paged_attention_ref(jnp.asarray(q), jp["k"], jp["v"], jnp.asarray(tbl), jnp.asarray(lens),
                                  k_scale=jp["k_scale"], v_scale=jp["v_scale"])
        got = K.paged_attention_quantized(torch.from_numpy(q), tp["k"], tp["v"], tp["k_scale"], tp["v_scale"],
                                          torch.from_numpy(tbl), torch.from_numpy(lens))
    else:
        q = rng.standard_normal((2, 5, H, 16)).astype(np.float32)
        start = np.array([19, 6], np.int32)
        ref = paged_prefill_attention_ref(jnp.asarray(q), jp["k"], jp["v"], jnp.asarray(tbl), jnp.asarray(start),
                                          k_scale=jp["k_scale"], v_scale=jp["v_scale"])
        got = K.paged_prefill_attention_quantized(torch.from_numpy(q), tp["k"], tp["v"], tp["k_scale"],
                                                  tp["v_scale"], torch.from_numpy(tbl), torch.from_numpy(start))
    assert np.abs(got.numpy() - np.asarray(ref)).max() < 1e-5


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("kind", ["chunk", "decode"])
def test_quantized_write_and_read_match_jax(mode, kind):
    """One layer's attention on quantized pools: the write quantizes into
    the pools and scale leaves exactly as the JAX package does."""
    jcfg, tcfg = _configs()
    jparams = jax_init_params(jcfg, jax.random.PRNGKey(1), jnp.float32)
    tparams = params_from_jax(tcfg, jax.tree.map(np.asarray, jparams), device="cpu")
    jattn = jax.tree.map(lambda a: a[0], jparams["blocks"]["attn"])
    tattn = tparams["blocks"][0]["attn"]
    jpools = _quantized_pools(mode, seed=7, KV=jcfg.num_kv_heads, hd=jcfg.head_dim)
    tbl = np.array([[1, 2, 3, 0], [4, 5, 0, 0]], np.int32)
    jcache = dict(jpools, tbl=jnp.asarray(tbl))
    tcache = _to_torch(jpools)
    tcache["tbl"] = torch.from_numpy(tbl)
    rng = np.random.default_rng(8)
    if kind == "chunk":
        x = rng.standard_normal((2, 6, jcfg.d_model)).astype(np.float32)
        start = np.array([13, 2], np.int32)
        jout, jnew = jax_chunk_attention(jcfg, jattn, jnp.asarray(x), jcache, jnp.asarray(tbl), jnp.asarray(start))
        tout = paged_chunk_attention(tcfg, tattn, torch.from_numpy(x), tcache, torch.from_numpy(tbl),
                                     torch.from_numpy(start))
    else:
        x = rng.standard_normal((2, 1, jcfg.d_model)).astype(np.float32)
        pos = np.array([21, 9], np.int32)
        jout, jnew = jax_decode_attention(jcfg, jattn, jnp.asarray(x), jcache, jnp.asarray(pos))
        tout = paged_decode_attention(tcfg, tattn, torch.from_numpy(x), tcache, torch.from_numpy(pos))
    for name in ("k", "v", "k_scale", "v_scale"):
        assert np.array_equal(_bits(tcache[name]), _bits(jnew[name])), name
    assert np.abs(tout.numpy() - np.asarray(jout)).max() < 1e-5


def _prompts():
    rng = np.random.default_rng(11)
    prefix = [7, 3, 19, 42, 5, 88, 13, 2, 61, 17, 23, 99]
    tail = lambda n: [int(t) for t in rng.integers(2, 250, n)]  # noqa: E731
    return [prefix + tail(8), prefix + tail(5), tail(9), prefix[:10] + tail(3)]


def _engine(cls, cfg, params, **kw):
    base = dict(max_batch=2, max_seq=64, block_size=8, prefill_budget=8, eos_token=EOS_OUT)
    base.update(kw)
    base.update(cache_dtype=jnp.float32) if cls is JaxEngine else base.update(cache_dtype=torch.float32, device="cpu")
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        return cls(cfg, params, **base)


def _int_stats(s: dict) -> dict:
    return {k: v for k, v in s.items() if type(v) is int and k != "cache_bytes"}


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("spec", ["off", "ngram"])
def test_quantized_engine_matches_jax(mode, spec):
    jcfg, tcfg = _configs()
    jparams = jax_init_params(jcfg, jax.random.PRNGKey(0), jnp.float32)
    tparams = params_from_jax(tcfg, jax.tree.map(np.asarray, jparams), device="cpu")
    kw = dict(quantize_kv=mode, spec_decode=spec, spec_k=3)
    out = {}
    for side, cls, cfg, params in (("jax", JaxEngine, jcfg, jparams), ("torch", InferenceEngine, tcfg, tparams)):
        for fused in (False, True):
            eng = _engine(cls, cfg, params, fused=fused, **kw)
            reqs = [eng.submit(p, max_new_tokens=5) for p in _prompts()]
            eng.run_until_drained()
            assert eng.allocator.blocks_in_use == 0
            out[side, fused] = ([list(r.generated) for r in reqs], [r.finish_reason for r in reqs], eng.stats())
    for fused in (False, True):
        (jt, jr, js), (tt, tr, ts) = out["jax", fused], out["torch", fused]
        assert tt == jt and tr == jr == ["length"] * len(tr), f"fused={fused}"
        assert _int_stats(ts) == _int_stats(js), f"fused={fused}"
    assert out["torch", True][0] == out["torch", False][0]
    assert out["torch", False][2]["prefix_hit_tokens"] > 0


def test_quantized_cache_bytes():
    _, tcfg = _configs()
    tparams = params_from_jax(
        tcfg, jax.tree.map(np.asarray, jax_init_params(_configs()[0], jax.random.PRNGKey(0), jnp.float32)),
        device="cpu",
    )
    sizes = {}
    for mode in (None, "int8", "fp8"):
        eng = InferenceEngine(tcfg, tparams, max_batch=2, max_seq=64, block_size=8, cache_dtype=torch.bfloat16,
                              quantize_kv=mode or False, attn_impl="plain", device="cpu")
        sizes[mode] = eng.stats()["cache_bytes"]
    assert sizes["fp8"] == sizes["int8"] < sizes[None]


def test_kernel_entry_points_refuse_quantized_pools():
    tp = _to_torch(_quantized_pools("int8", seed=2))
    q = torch.zeros((1, 4, 16))
    tbl = torch.ones((1, 2), dtype=torch.int32)
    with pytest.raises(ValueError, match="quantized pools need scales"):
        K.paged_attention(q, tp["k"], tp["v"], tbl, torch.tensor([9], dtype=torch.int32))
    tp = _to_torch(_quantized_pools("fp8", seed=2))
    with pytest.raises(ValueError, match="quantized pools need scales"):
        K.paged_prefill_attention(q[:, None], tp["k"], tp["v"], tbl, torch.tensor([3], dtype=torch.int32))


def test_quantized_engine_warns_on_kernel_impl():
    _, tcfg = _configs()
    from repro_torch.models import init_params

    params = init_params(tcfg, 0, device="cpu")
    with pytest.warns(RuntimeWarning, match="no kernel yet"):
        InferenceEngine(tcfg, params, max_batch=2, max_seq=64, block_size=8, quantize_kv="fp8", device="cpu")
