"""The PyTorch port's dense and moe models on a paged cache against the JAX
package.

Both packages run the same weights (``repro_torch.bridge.params_from_jax``)
through two prefill chunks and one decode step on smoke-size configs; the
moe configs (qwen3-moe, arctic) at capacity factor 8, where no pair can be
dropped (``tests/test_paged.py`` holds the JAX package's own moe decode so).  With
fp32 pools the logits agree to 1e-4 absolute (same function, sums in
another order).  With bf16 pools the K/V pass through bf16 rounding on both
sides; a 1-ulp fp32 difference before the cast can move a value by one bf16
ulp (2^-8 relative), so that case is held to 1e-2.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config.model import reduce_for_smoke as jax_reduce
from repro.configs import get_config as jax_get_config
from repro.models import decode_step as jax_decode_step
from repro.models import init_paged_cache as jax_init_paged_cache
from repro.models import init_params as jax_init_params
from repro.models import prefill_step as jax_prefill_step
from repro.models.initializers import param_specs as jax_param_specs
from repro_torch.bridge import params_from_jax
from repro_torch.config import reduce_for_smoke
from repro_torch.configs import get_config
from repro_torch.models import decode_step, init_paged_cache, init_params, prefill_step

torch.set_num_threads(2)

BS, NB, BATCH = 8, 4, 2
PROMPT = 20
CHUNKS = (16, 4)  # two prefill chunks: the second starts mid-block


def _configs(arch, **overrides):
    jcfg = jax_reduce(jax_get_config(arch)).replace(**overrides)
    tcfg = reduce_for_smoke(get_config(arch)).replace(**overrides)
    if jcfg.moe is not None:  # capacity cannot bind: cf >= num_experts / top_k
        jcfg = jcfg.replace(moe=dataclasses.replace(jcfg.moe, capacity_factor=8.0))
        tcfg = tcfg.replace(moe=dataclasses.replace(tcfg.moe, capacity_factor=8.0))
    return jcfg, tcfg


def _run_jax(cfg, params, tokens, dtype):
    cache = jax_init_paged_cache(cfg, 1 + BATCH * NB, BS, BATCH, NB, dtype)
    row = jnp.arange(1, 1 + NB, dtype=jnp.int32)[None]  # request in slot 0
    outs, start = [], 0
    for c in CHUNKS:
        lg, cache = jax_prefill_step(
            cfg, params, cache, jnp.asarray(tokens[None, start : start + c]),
            jnp.asarray([start], jnp.int32), row,
        )
        outs.append(np.asarray(lg))
        start += c
    tbl = np.zeros((BATCH, NB), np.int32)
    tbl[0] = np.arange(1, 1 + NB)
    cache["tbl"] = jnp.broadcast_to(jnp.asarray(tbl)[None], (cfg.num_layers, BATCH, NB))
    tok = np.array([[tokens[PROMPT]], [0]], np.int32)  # slot 1 inactive: null row, pos 0
    lg, _ = jax_decode_step(cfg, params, cache, jnp.asarray(tok), jnp.asarray([PROMPT, 0], jnp.int32))
    outs.append(np.asarray(lg))
    return outs


def _run_torch(cfg, params, tokens, dtype):
    cache = init_paged_cache(cfg, 1 + BATCH * NB, BS, BATCH, NB, dtype, device="cpu")
    row = torch.arange(1, 1 + NB, dtype=torch.int32)[None]
    tok = torch.from_numpy(tokens.astype(np.int32))
    outs, start = [], 0
    for c in CHUNKS:
        lg, cache = prefill_step(
            cfg, params, cache, tok[None, start : start + c], torch.tensor([start], dtype=torch.int32), row
        )
        outs.append(lg.numpy())
        start += c
    cache["tbl"][0] = torch.arange(1, 1 + NB, dtype=torch.int32)
    step_tok = torch.tensor([[int(tokens[PROMPT])], [0]], dtype=torch.int32)
    lg, _ = decode_step(cfg, params, cache, step_tok, torch.tensor([PROMPT, 0], dtype=torch.int32))
    outs.append(lg.numpy())
    return outs


MODEL_CASES = [
    ("olmo-1b", {}),
    ("mistral-nemo-12b", {}),
    ("gemma-7b", {}),
    ("mistral-nemo-12b", {"sliding_window": 8}),
    ("gemma-7b", {"attn_logit_softcap": 30.0}),
    ("stablelm-12b", {}),  # parallel residual, partial rotary, layernorm
    ("qwen3-moe-235b-a22b", {}),  # routed experts, qk_norm, untied head
    ("arctic-480b", {}),  # routed experts beside a dense residual FFN
]


@pytest.mark.parametrize("arch,overrides", MODEL_CASES)
def test_prefill_and_decode_match_jax(arch, overrides):
    jcfg, tcfg = _configs(arch, **overrides)
    jparams = jax_init_params(jcfg, jax.random.PRNGKey(3), jnp.float32)
    tparams = params_from_jax(tcfg, jax.tree.map(np.asarray, jparams), device="cpu")
    tokens = np.random.default_rng(5).integers(0, jcfg.vocab_size, PROMPT + 1).astype(np.int32)
    ref = _run_jax(jcfg, jparams, tokens, jnp.float32)
    got = _run_torch(tcfg, tparams, tokens, torch.float32)
    for i, (a, b) in enumerate(zip(got, ref)):
        assert a.shape == b.shape
        err = float(np.max(np.abs(a - b)))
        assert err < 1e-4, f"{arch} {overrides} call {i}: logits differ by {err}"


def test_bf16_pools_match_jax():
    jcfg, tcfg = _configs("olmo-1b")
    jparams = jax_init_params(jcfg, jax.random.PRNGKey(4), jnp.float32)
    tparams = params_from_jax(tcfg, jax.tree.map(np.asarray, jparams), device="cpu")
    tokens = np.random.default_rng(6).integers(0, jcfg.vocab_size, PROMPT + 1).astype(np.int32)
    ref = _run_jax(jcfg, jparams, tokens, jnp.bfloat16)
    got = _run_torch(tcfg, tparams, tokens, torch.bfloat16)
    for a, b in zip(got, ref):
        assert float(np.max(np.abs(a - b))) < 1e-2


def _shapes(tree, prefix="") -> dict:
    """{dotted path: shape} of a tree of dicts whose leaves have ``.shape``
    (JAX ParamSpecs, tensors)."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_shapes(v, f"{prefix}{k}."))
        return out
    return {prefix[:-1]: tuple(tree.shape)}


@pytest.mark.parametrize("arch", ["olmo-1b", "mistral-nemo-12b", "gemma-7b", "qwen3-moe-235b-a22b", "arctic-480b"])
def test_init_params_matches_jax_layout(arch):
    """Same leaf names and shapes as the JAX tree (per layer), same init
    scales: embeddings std 0.02, projections std 1/sqrt(fan_in)."""
    jcfg, tcfg = _configs(arch)
    jspecs = jax_param_specs(jcfg)
    params = init_params(tcfg, 0, device="cpu")
    jblocks = {k: v[1:] for k, v in _shapes(jspecs.pop("blocks")).items()}
    tblocks = params.pop("blocks")
    assert _shapes(params) == _shapes(jspecs)
    assert len(tblocks) == tcfg.num_layers
    assert all(_shapes(layer) == jblocks for layer in tblocks)
    params["blocks"] = tblocks
    assert ("lm_head" in params) == ("lm_head" in jspecs)
    assert abs(float(params["embed"]["tok"].std()) - 0.02) < 2e-3
    wq = params["blocks"][0]["attn"]["wq"]
    std = 1.0 / np.sqrt(tcfg.d_model * tcfg.num_heads)  # fan-in of (D, H, hd) is D*H
    assert abs(float(wq.std()) / std - 0.987) < 0.05  # truncated at 3 sigma
    assert float(wq.abs().max()) <= 3 * std + 1e-6


def test_paged_cache_bytes_counts_the_cache():
    from repro_torch.models import paged_cache_bytes

    _, tcfg = _configs("mistral-nemo-12b")
    for dtype in (torch.float32, torch.bfloat16):
        cache = init_paged_cache(tcfg, 9, BS, BATCH, NB, dtype, device="cpu")
        held = sum(t.numel() * t.element_size() for t in cache.values())
        assert paged_cache_bytes(tcfg, 9, BS, BATCH, NB, dtype) == held
        assert cache["k"].shape == (tcfg.num_layers, 9, BS, tcfg.num_kv_heads, tcfg.head_dim)
        assert cache["tbl"].dtype == torch.int32 and not cache["tbl"].any()
