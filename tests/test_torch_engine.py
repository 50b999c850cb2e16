"""The PyTorch port's serving engine against the JAX ``InferenceEngine``.

Same weights (through ``repro_torch.bridge.params_from_jax``), same
prompts with a shared prefix (full-block prefix hits and a copy-on-write
partial tail), chunked prefill with a budget of 16 tokens per step, two
decode slots so later requests admit after earlier ones registered their
blocks.  fp32 pools on both sides, so a near-tie cannot flip an argmax:
greedy tokens and finish reasons must be identical.  These weights emit
token 137 early in several requests, so ``eos_token=137`` mixes EOS and
length finishes; an id outside the vocab makes every request run to its
length.
"""

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
from repro_torch.serving import InferenceEngine, RequestState

torch.set_num_threads(2)

PREFIX = [7, 3, 19, 42, 5, 88, 13, 2, 61, 17, 23, 99]  # 1.5 blocks of 8


def _prompts():
    rng = np.random.default_rng(11)
    tail = lambda n: [int(t) for t in rng.integers(2, 250, n)]  # noqa: E731
    return [
        PREFIX + tail(8),  # registers blocks 0 and 1
        PREFIX + tail(5),
        tail(9),
        PREFIX + tail(11),  # full hit on block 0, COW of block 1's first 4 tokens
        PREFIX[:10] + tail(3),
        PREFIX + tail(2),
    ]


def _serve(engine_cls, cfg, params, eos, **kw):
    eng = engine_cls(
        cfg, params, max_batch=2, max_seq=64, block_size=8, prefill_budget=16, eos_token=eos, **kw
    )
    reqs = [eng.submit(p, max_new_tokens=6) for p in _prompts()]
    eng.run_until_drained()
    return eng, reqs


@pytest.mark.parametrize("eos", [256, 137], ids=["eos_outside_vocab", "eos_137"])
def test_engine_matches_jax_engine(eos):
    jcfg = jax_reduce(jax_get_config("olmo-1b"))
    tcfg = reduce_for_smoke(get_config("olmo-1b"))
    jparams = jax_init_params(jcfg, jax.random.PRNGKey(0), jnp.float32)
    tparams = params_from_jax(tcfg, jax.tree.map(np.asarray, jparams), device="cpu")

    jeng, jreqs = _serve(JaxEngine, jcfg, jparams, eos, cache_dtype=jnp.float32)
    teng, treqs = _serve(InferenceEngine, tcfg, tparams, eos, cache_dtype=torch.float32, device="cpu")

    assert all(r.state == RequestState.DONE for r in treqs)
    assert [r.generated for r in treqs] == [r.generated for r in jreqs]
    assert [r.finish_reason for r in treqs] == [r.finish_reason for r in jreqs]
    js, ts = jeng.stats(), teng.stats()
    for key in ("prefix_hits", "prefix_partial_hits", "prefix_hit_tokens", "prefill_tokens", "decode_steps"):
        assert ts[key] == js[key], key
    assert ts["prefix_hit_tokens"] > 0 and ts["prefix_partial_hits"] > 0
    assert ts["alloc_blocks_in_use"] == 0
    assert ts["alloc_total_allocs"] == ts["alloc_total_frees"]
    reasons = {r.finish_reason for r in treqs}
    assert reasons == ({"length"} if eos == tcfg.padded_vocab else {"eos", "length"})
