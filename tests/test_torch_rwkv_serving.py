"""The port's ssm family (rwkv6-7b, RWKV6) on the serving path against the
JAX package's, on the CPU, at smoke size (``reduce_for_smoke``: 2 layers,
d_model 64, 4 heads of 16, WKV chunks of 16), on bridged weights.

* The steps of one layer: ``time_mix_step`` and ``channel_mix`` with a
  ``prev_x`` on three slots, and ``rwkv_block_prefill`` (the chunked scan:
  two chunks at S = 32, one chunk of S at S = 21) then
  ``rwkv_block_decode``: outputs to 4e-6 of their largest value, states
  to 2e-6.
* The model: ``prefill`` of two prompts written into a dense slot cache
  (``write_prefill_into_slot`` against the JAX ``decode_cache_from_prefill``
  and ``write_request_into_slot``), then 6 ``decode_step`` s fed the JAX
  run's greedy tokens: every step's logits and the states after the last
  one to 2e-5.
* The engine on the dense slot cache against the JAX engine on one manual
  clock, bf16 and fp32 caches: greedy tokens, finish reasons, every stat
  and the slot cache after the drain (a decode step computes idle slots
  too; freed slots are zeroed first).  ``cache_kind="paged"`` turns into
  ``"dense"`` without a warning, as in the JAX engine, and serves the same.
* The serve launcher on smoke rwkv6-7b prints ``cache_kind: dense``.
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
from repro.models import init_params as jax_init_params
from repro.models import prefill as jax_prefill
from repro.models import rwkv as jax_rwkv
from repro.serving import InferenceEngine as JaxEngine
from repro.serving import ManualClock as JaxClock
from repro.serving.kvcache import decode_cache_from_prefill as jax_from_prefill
from repro.serving.kvcache import make_engine_cache as jax_make_engine_cache
from repro.serving.kvcache import write_request_into_slot as jax_write_slot
from repro_torch.bridge import params_from_jax
from repro_torch.config import reduce_for_smoke
from repro_torch.configs import get_config
from repro_torch.models import blocks, decode_step, prefill, rwkv
from repro_torch.serving import InferenceEngine, RequestState
from repro_torch.serving.kvcache import decode_cache_from_prefill, make_engine_cache, write_prefill_into_slot
from repro_torch.serving.metrics import ManualClock

torch.set_num_threads(2)

ARCH = "rwkv6-7b"
EOS_OUT = 1 << 30  # outside the vocab: requests run to their length


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


def test_time_mix_step_and_channel_mix_with_prev_x(models):
    jcfg, tcfg, jparams, tparams = models
    jl, tl = _layer(jparams, 1), tparams["blocks"][1]
    rng = np.random.default_rng(4)
    B, D, H, n = 3, tcfg.d_model, tcfg.num_heads, tcfg.rwkv.head_size
    x = rng.standard_normal((B, 1, D)).astype(np.float32)
    prev = rng.standard_normal((B, D)).astype(np.float32)
    state = (0.3 * rng.standard_normal((B, H, n, n))).astype(np.float32)
    jout, (jlast, jstate) = jax_rwkv.time_mix_step(jcfg, jl["time_mix"], jnp.asarray(x), jnp.asarray(prev),
                                                   jnp.asarray(state))
    tout, (tlast, tstate) = rwkv.time_mix_step(tcfg, tl["time_mix"], torch.from_numpy(x), torch.from_numpy(prev),
                                               torch.from_numpy(state))
    assert _rel(tout, jout) < 4e-6 and _rel(tstate, jstate) < 2e-6
    assert np.array_equal(tlast.numpy(), np.asarray(jlast))
    xs = rng.standard_normal((B, 5, D)).astype(np.float32)
    # the token-shift mixes init at zero, where prev_x would not matter
    maa = {k: (0.5 * rng.standard_normal(D)).astype(np.float32) for k in ("maa_k", "maa_r")}
    jcm = dict(jl["channel_mix"], **{k: jnp.asarray(v) for k, v in maa.items()})
    tcm = dict(tl["channel_mix"], **{k: torch.from_numpy(v) for k, v in maa.items()})
    jout, jlast = jax_rwkv.channel_mix(jcfg, jcm, jnp.asarray(xs), prev_x=jnp.asarray(prev))
    tout, tlast = rwkv.channel_mix(tcfg, tcm, torch.from_numpy(xs), prev_x=torch.from_numpy(prev))
    assert _rel(tout, jout) < 4e-6 and np.array_equal(tlast.numpy(), xs[:, -1])
    # prev_x moves the first position only
    plain, _ = rwkv.channel_mix(tcfg, tcm, torch.from_numpy(xs))
    assert torch.equal(plain[:, 1:], tout[:, 1:]) and not torch.equal(plain[:, 0], tout[:, 0])


@pytest.mark.parametrize("S", [32, 21], ids=["S32_two_chunks", "S21_one_chunk"])
def test_rwkv_block_prefill_then_decode(models, S):
    jcfg, tcfg, jparams, tparams = models
    jl, tl = _layer(jparams), tparams["blocks"][0]
    rng = np.random.default_rng(S)
    x = rng.standard_normal((3, S, tcfg.d_model)).astype(np.float32)
    jx, jc = jax_blocks.rwkv_block_prefill(jcfg, jl, jnp.asarray(x))
    tx, tc = blocks.rwkv_block_prefill(tcfg, tl, torch.from_numpy(x))
    assert _rel(tx, jx) < 4e-6
    assert set(tc) == set(jc) == {"tm_x", "cm_x", "state"}
    for name in tc:
        assert _rel(tc[name], jc[name]) < 2e-6, name
    tok = rng.standard_normal((3, 1, tcfg.d_model)).astype(np.float32)
    pos = np.full(3, S, np.int32)
    jx, jc = jax_blocks.rwkv_block_decode(jcfg, jl, jnp.asarray(tok), jc, jnp.asarray(pos))
    tx, tc = blocks.rwkv_block_decode(tcfg, tl, torch.from_numpy(tok), tc, torch.from_numpy(pos))
    assert _rel(tx, jx) < 4e-6
    for name in tc:
        assert _rel(tc[name], jc[name]) < 2e-6, name


PROMPTS = (_prompt(32, 11), _prompt(13, 12))


def test_prefill_and_decode_steps_match_jax(models):
    jcfg, tcfg, jparams, tparams = models
    B = len(PROMPTS)
    jcache = jax_make_engine_cache(jcfg, B, 64, jnp.float32)
    tcache = make_engine_cache(tcfg, B, 64, torch.float32, device="cpu")
    assert set(tcache) == set(jcache) == {"tm_x", "cm_x", "state"}
    jlog = []
    for slot, p in enumerate(PROMPTS):
        lg, raw = jax_prefill(jcfg, jparams, {"tokens": jnp.asarray([p], jnp.int32)})
        jlog.append(lg[0])
        jcache = jax_write_slot(jcfg, jcache, jax_from_prefill(jcfg, raw, seq_filled=len(p), decode_len=64), slot)
        tl, traw = prefill(tcfg, tparams, {"tokens": torch.tensor([p], dtype=torch.int32)})
        assert _rel(tl[0], lg[0]) < 2e-5
        # the states pass through decode_cache_from_prefill, as in the JAX package
        assert set(decode_cache_from_prefill(tcfg, traw, seq_filled=len(p), decode_len=64)) == set(traw)
        write_prefill_into_slot(tcfg, tcache, traw, slot, seq_filled=len(p))
    pos = np.array([len(p) for p in PROMPTS], np.int32)
    tok = np.array([[int(np.argmax(np.asarray(lg)))] for lg in jlog], np.int32)
    for step in range(6):
        jl, jcache = jax_decode_step(jcfg, jparams, jcache, jnp.asarray(tok), jnp.asarray(pos))
        tl, tcache = decode_step(tcfg, tparams, tcache, torch.from_numpy(tok), torch.from_numpy(pos))
        assert _rel(tl, jl) < 2e-5, f"step {step}"
        tok = np.asarray(jnp.argmax(jl, axis=-1), np.int32)[:, None]
        pos = pos + 1
    for name in tcache:
        assert _rel(tcache[name], jcache[name]) < 2e-5, name


ENGINE_PROMPTS = [_prompt(n, 30 + i) for i, n in enumerate((32, 9, 21, 3, 45, 16, 28))]
DTYPES = {"fp32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}


@pytest.mark.parametrize("asked", ["dense", "paged"])
@pytest.mark.parametrize("dtype", ["bf16", "fp32"])
def test_engine_matches_jax_engine(models, asked, dtype):
    """Three slots; ``cache_kind="paged"`` is served on the dense slot cache
    with no warning."""
    jcfg, tcfg, jparams, tparams = models
    jdt, tdt = DTYPES[dtype]
    kw = dict(max_batch=3, max_seq=64, block_size=8, cache_kind=asked, eos_token=EOS_OUT)
    je = JaxEngine(jcfg, jparams, clock=JaxClock(), cache_dtype=jdt, **kw)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        te = InferenceEngine(tcfg, tparams, clock=ManualClock(), cache_dtype=tdt, device="cpu", **kw)
    assert te.cache_kind == je.cache_kind == "dense" and te.allocator is None and "tbl" not in te.cache
    max_new = [10, 6, 12, 8, 9, 5, 11]
    jreqs = [je.submit(p, max_new_tokens=m) for p, m in zip(ENGINE_PROMPTS, max_new)]
    treqs = [te.submit(p, max_new_tokens=m) for p, m in zip(ENGINE_PROMPTS, max_new)]
    je.run_until_drained()
    te.run_until_drained()
    assert all(r.state == RequestState.DONE for r in treqs)
    assert [r.generated for r in treqs] == [r.generated for r in jreqs]
    assert [r.finish_reason for r in treqs] == [r.finish_reason for r in jreqs]
    assert te.stats() == je.stats()
    for name, leaf in te.cache.items():
        # a decode step returns tm_x / cm_x in the compute dtype (fp32), in both packages
        assert leaf.dtype == torch.float32 and str(je.cache[name].dtype) == "float32", name
        assert _rel(leaf, je.cache[name]) < 2e-5, name


def test_serve_launcher_serves_rwkv(capsys):
    from repro_torch.launch.serve import main

    stats = main(["--device", "cpu", "--arch", ARCH, "--requests", "4", "--max-new", "4"])
    out = capsys.readouterr().out
    assert "rwkv6-7b" in out and "on cpu" in out and "'cache_kind': 'dense'" in out
    assert stats["cache_kind"] == "dense" and stats["requests_done"] == 4
