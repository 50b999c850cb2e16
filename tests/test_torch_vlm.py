"""The port's vlm family (llama-3.2-vision-90b: groups of 4 self layers and
1 cross layer onto image tokens) against the JAX package's, on the CPU, at
smoke size (``reduce_for_smoke``: one group of 5 layers, d_model 64, 4
query heads over 2 kv heads of 16, 8 image tokens) and a two-group variant
(10 layers), on bridged weights.

Random init leaves both ``tanh`` gates of every cross layer at 0, which
would make each cross layer the identity; every case sets them to nonzero
values in the numpy tree before bridging (``_perturbed``), and the
``use_bias`` and ``qk_norm`` variants get random biases and norm scales.

* The cross layer: ``cross_attention``, ``cross_block``,
  ``cross_block_prefill`` (output, ``ck``, ``cv``) and ``cross_block_decode``
  (output; the cache left as it is) in three variants: plain, biases
  (the decode step's q has none, as in the JAX package), q/k norms.
  fp32, outputs to 4e-6 of their largest value.
* The parameter tree: the specs' shapes and leaf names, and the bridge
  (group, then inner layer), value for value.
* ``prefill`` of two right-padded prompts (``last_index``) against the JAX
  prefill: logits and the raw cache leaf by leaf to 1e-5; then each prompt
  written into its slot and 6 ``decode_step`` s fed the JAX run's greedy
  tokens: logits to 2e-5 of their largest value, the caches after the last
  step to 1e-5.
* The port's own teacher forcing: a prefill of one token, then decode
  steps over a whole sequence, against ``forward``'s logits at every
  position, 5e-4 (the JAX package's ``test_decode_equivalence`` bar).
* ``forward`` and ``loss_fn`` against the JAX package in fp32 (logits 1e-4,
  loss 1e-6 relative) and bf16 compute (logits within twice the JAX bf16
  run's own distance from its fp32 run, 0.04-0.06 here; loss 2e-3
  relative: bf16 roundings of the same values in another order), under the torch
  attention and under K3 (its plain version on the CPU; the JAX package's
  Pallas kernel in interpret mode); ``fp8`` raises the JAX package's
  ``ValueError``.  Gradients of the loss under ``attn_impl="torch"``
  against ``jax.grad``, leaf by leaf to 1e-4 of each leaf's largest
  value, with and without ``remat="full"``.
* The synthetic batch carries ``vision_tokens``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config.model import reduce_for_smoke as jax_reduce
from repro.configs import get_config as jax_get_config
from repro.models import attention as jax_attention
from repro.models import blocks as jax_blocks
from repro.models import decode_step as jax_decode_step
from repro.models import forward as jax_forward
from repro.models import init_params as jax_init_params
from repro.models import prefill as jax_prefill
from repro.serving.kvcache import decode_cache_from_prefill as jax_from_prefill
from repro.serving.kvcache import make_engine_cache as jax_make_engine_cache
from repro.serving.kvcache import write_request_into_slot as jax_write_slot
from repro.train.step import loss_fn as jax_loss_fn
from repro_torch.bridge import params_from_jax
from repro_torch.config import reduce_for_smoke
from repro_torch.configs import get_config
from repro_torch.data import synthetic_batch
from repro_torch.models import attention, blocks, decode_step, forward, init_cache, param_specs, prefill
from repro_torch.serving.kvcache import make_engine_cache, write_prefill_into_slot
from repro_torch.train import loss_fn
from repro_torch.utils.tree import tree_leaves, tree_paths

torch.set_num_threads(2)

ARCH = "llama-3.2-vision-90b"
VARIANTS = {"plain": {}, "bias": {"use_bias": True}, "qk_norm": {"qk_norm": True}, "two_groups": {"num_layers": 10}}
GATES = {"gate": 0.9, "gate_mlp": -0.7}  # tanh 0.716 and -0.604
_CACHE: dict = {}


def _perturbed(tree, rng):
    """The numpy tree with nonzero cross gates, random biases and random
    q/k norm scales (init leaves them at 0, 0 and 1)."""
    out = {}
    for name, v in tree.items():
        if isinstance(v, dict):
            out[name] = _perturbed(v, rng)
        elif name in GATES:
            out[name] = np.full(v.shape, GATES[name], np.float32)
        elif name in ("bq", "bk", "bv", "bo"):
            out[name] = (0.05 * rng.standard_normal(v.shape)).astype(np.float32)
        elif name in ("q_norm", "k_norm"):
            out[name] = (1.0 + 0.2 * rng.standard_normal(v.shape)).astype(np.float32)
        else:
            out[name] = np.asarray(v)
    return out


def models(variant="plain"):
    """(jcfg, tcfg, jparams, tparams) of a variant, built once."""
    if variant not in _CACHE:
        kw = VARIANTS[variant]
        jcfg, tcfg = jax_reduce(jax_get_config(ARCH)).replace(**kw), reduce_for_smoke(get_config(ARCH)).replace(**kw)
        tree = _perturbed(jax.tree.map(np.asarray, jax_init_params(jcfg, jax.random.PRNGKey(0), jnp.float32)),
                          np.random.default_rng(5))
        _CACHE[variant] = (jcfg, tcfg, jax.tree.map(jnp.asarray, tree), params_from_jax(tcfg, tree, device="cpu"))
    return _CACHE[variant]


def _rel(got: torch.Tensor, ref) -> float:
    ref = np.asarray(ref, dtype=np.float32)
    return float(np.max(np.abs(got.detach().float().numpy() - ref))) / max(float(np.max(np.abs(ref))), 1e-30)


def _close(t, j, atol=1e-5):
    np.testing.assert_allclose(t.detach().float().numpy(), np.asarray(j, np.float32), atol=atol, rtol=0)


def _cross(jparams, group=0):
    return jax.tree.map(lambda a: a[group], jparams["blocks"]["cross"])


def _vision(cfg, B, seed=3):
    return np.random.default_rng(seed).standard_normal((B, cfg.vision.num_image_tokens, cfg.d_model)).astype(np.float32)


def _prompt(n, seed):
    return [int(t) for t in np.random.default_rng(seed).integers(2, 250, n)]


# ---------------------------------------------------------------------------
# the cross layer
# ---------------------------------------------------------------------------

LAYER_VARIANTS = ["plain", "bias", "qk_norm"]


@pytest.mark.parametrize("variant", LAYER_VARIANTS)
def test_cross_attention_matches_jax(variant):
    jcfg, tcfg, jparams, tparams = models(variant)
    x = np.random.default_rng(1).standard_normal((2, 7, tcfg.d_model)).astype(np.float32)
    vis = _vision(tcfg, 2)
    ref = jax_attention.cross_attention(jcfg, _cross(jparams)["attn"], jnp.asarray(x), jnp.asarray(vis))
    got = attention.cross_attention(tcfg, tparams["blocks"][0]["cross"]["attn"], torch.from_numpy(x),
                                    torch.from_numpy(vis))
    assert got.shape == ref.shape and _rel(got, ref) < 4e-6


@pytest.mark.parametrize("variant", LAYER_VARIANTS)
def test_cross_block_matches_jax(variant):
    jcfg, tcfg, jparams, tparams = models(variant)
    x = np.random.default_rng(2).standard_normal((2, 9, tcfg.d_model)).astype(np.float32)
    vis = _vision(tcfg, 2, seed=4)
    ref = jax_blocks.cross_block(jcfg, _cross(jparams), jnp.asarray(x), jnp.asarray(vis))
    got = blocks.cross_block(tcfg, tparams["blocks"][0]["cross"], torch.from_numpy(x), torch.from_numpy(vis))
    assert _rel(got, ref) < 4e-6
    assert _rel(got, x) > 1e-3  # the gates are open: the layer is not the identity


@pytest.mark.parametrize("variant", LAYER_VARIANTS)
def test_cross_block_prefill_matches_jax(variant):
    jcfg, tcfg, jparams, tparams = models(variant)
    x = np.random.default_rng(3).standard_normal((2, 6, tcfg.d_model)).astype(np.float32)
    vis = _vision(tcfg, 2, seed=5)
    jx, jc = jax_blocks.cross_block_prefill(jcfg, _cross(jparams), jnp.asarray(x), jnp.asarray(vis))
    tx, tc = blocks.cross_block_prefill(tcfg, tparams["blocks"][0]["cross"], torch.from_numpy(x), torch.from_numpy(vis))
    assert _rel(tx, jx) < 4e-6
    assert set(tc) == set(jc) == {"ck", "cv"}
    for name in tc:
        assert tc[name].shape == jc[name].shape == (2, tcfg.vision.num_image_tokens, tcfg.num_kv_heads, tcfg.head_dim)
        assert _rel(tc[name], jc[name]) < 2e-6, name


@pytest.mark.parametrize("variant", LAYER_VARIANTS)
def test_cross_block_decode_matches_jax(variant):
    """Three slots against random cached image K/V; the step leaves the
    cache untouched (in the JAX package it returns it as it is)."""
    jcfg, tcfg, jparams, tparams = models(variant)
    rng = np.random.default_rng(4)
    N, KV, hd = tcfg.vision.num_image_tokens, tcfg.num_kv_heads, tcfg.head_dim
    cache = {name: rng.standard_normal((3, N, KV, hd)).astype(np.float32) for name in ("ck", "cv")}
    x = rng.standard_normal((3, 1, tcfg.d_model)).astype(np.float32)
    jx, jc = jax_blocks.cross_block_decode(jcfg, _cross(jparams), jnp.asarray(x), jax.tree.map(jnp.asarray, cache))
    tcache = {name: torch.from_numpy(a.copy()) for name, a in cache.items()}
    tx = blocks.cross_block_decode(tcfg, tparams["blocks"][0]["cross"], torch.from_numpy(x), tcache)
    assert _rel(tx, jx) < 4e-6
    for name in cache:
        assert np.array_equal(tcache[name].numpy(), cache[name]) and np.array_equal(np.asarray(jc[name]), cache[name])


# ---------------------------------------------------------------------------
# the parameter tree
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("variant", ["plain", "two_groups"])
def test_param_specs_and_bridge_follow_the_groups(variant):
    jcfg, tcfg, jparams, tparams = models(variant)
    G, g = tcfg.num_layers // 5, 4
    assert len(tparams["blocks"]) == G and all(len(grp["self"]) == g for grp in tparams["blocks"])
    specs = param_specs(tcfg)
    spec_shapes = {p: tuple(s.shape) for p, s in zip(tree_paths(specs), tree_leaves(specs))}
    assert spec_shapes == {p: tuple(t.shape) for p, t in zip(tree_paths(tparams), tree_leaves(tparams))}
    assert set(tparams["blocks"][0]["cross"]) == {"norm1", "attn", "norm2", "mlp", "gate_mlp"}
    assert "gate" in tparams["blocks"][0]["cross"]["attn"] and "gate" not in tparams["blocks"][0]["self"][0]["attn"]
    jb = jparams["blocks"]
    for gi in range(G):
        for i in range(g):
            for path, t in zip(tree_paths(tparams["blocks"][gi]["self"][i]), tree_leaves(tparams["blocks"][gi]["self"][i])):
                ref = jb["self"]
                for k in path:
                    ref = ref[k]
                assert np.array_equal(t.numpy(), np.asarray(ref)[gi, i]), (gi, i, path)
        for path, t in zip(tree_paths(tparams["blocks"][gi]["cross"]), tree_leaves(tparams["blocks"][gi]["cross"])):
            ref = jb["cross"]
            for k in path:
                ref = ref[k]
            assert np.array_equal(t.numpy(), np.asarray(ref)[gi]), (gi, path)
    assert np.array_equal(tparams["lm_head"].numpy(), np.asarray(jparams["lm_head"]))


# ---------------------------------------------------------------------------
# prefill + decode_step
# ---------------------------------------------------------------------------

PROMPTS = (_prompt(13, 11), _prompt(9, 12))
STEPS = 6
MAX_SEQ = 32


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_prefill_and_decode_steps_match_jax(variant):
    jcfg, tcfg, jparams, tparams = models(variant)
    # both prompts right-padded to 16 in one call, logits at their last real token
    toks = np.zeros((2, 16), np.int32)
    for b, p in enumerate(PROMPTS):
        toks[b, : len(p)] = p
    last = np.array([len(p) - 1 for p in PROMPTS], np.int32)
    vis = _vision(tcfg, 2, seed=8)
    jl, jraw = jax_prefill(jcfg, jparams, {"tokens": jnp.asarray(toks), "last_index": jnp.asarray(last),
                                           "vision_tokens": jnp.asarray(vis)})
    tl, traw = prefill(tcfg, tparams, {"tokens": torch.from_numpy(toks), "last_index": torch.from_numpy(last),
                                       "vision_tokens": torch.from_numpy(vis)})
    _close(tl, jl)
    assert set(traw) == {"self", "cross"} and set(traw["self"]) == {"k", "v"} and set(traw["cross"]) == {"ck", "cv"}
    for part in traw:
        for name, t in traw[part].items():
            assert tuple(t.shape) == jraw[part][name].shape, (part, name)
            _close(t, jraw[part][name])
    # each prompt alone into its slot (the engine's admission), then decode
    B = len(PROMPTS)
    jcache = jax_make_engine_cache(jcfg, B, MAX_SEQ, jnp.float32)
    tcache = make_engine_cache(tcfg, B, MAX_SEQ, torch.float32, device="cpu")
    jlog = []
    for slot, p in enumerate(PROMPTS):
        one = {"tokens": jnp.asarray([p], jnp.int32), "vision_tokens": jnp.asarray(vis[slot : slot + 1])}
        lg, raw = jax_prefill(jcfg, jparams, one)
        jlog.append(lg[0])
        jcache = jax_write_slot(jcfg, jcache, jax_from_prefill(jcfg, raw, seq_filled=len(p), decode_len=MAX_SEQ), slot)
        _, traw = prefill(tcfg, tparams, {"tokens": torch.tensor([p], dtype=torch.int32),
                                          "vision_tokens": torch.from_numpy(vis[slot : slot + 1])})
        write_prefill_into_slot(tcfg, tcache, traw, slot, seq_filled=len(p))
    pos = np.array([len(p) for p in PROMPTS], np.int32)
    tok = np.array([[int(np.argmax(np.asarray(lg)))] for lg in jlog], np.int32)
    for step in range(STEPS):
        jl, jcache = jax_decode_step(jcfg, jparams, jcache, jnp.asarray(tok), jnp.asarray(pos))
        tl, tcache = decode_step(tcfg, tparams, tcache, torch.from_numpy(tok), torch.from_numpy(pos))
        assert _rel(tl, jl) < 2e-5, f"step {step}"
        tok = np.asarray(jnp.argmax(jl, axis=-1), np.int32)[:, None]
        pos = pos + 1
    for part in tcache:
        for name, t in tcache[part].items():
            assert tuple(t.shape) == jcache[part][name].shape, (part, name)
            _close(t, jcache[part][name])


@pytest.mark.parametrize("variant", ["plain", "qk_norm", "two_groups"])
def test_decode_matches_teacher_forcing(variant):
    """The port's decode steps over a whole sequence (the image K/V from a
    one-token prefill) against its own forward's logits at every position."""
    _, tcfg, _, tparams = models(variant)
    S = 24
    rng = np.random.default_rng(9)
    tokens = torch.from_numpy(rng.integers(0, tcfg.vocab_size, (1, S)).astype(np.int32))
    vis = torch.from_numpy(_vision(tcfg, 1, seed=10))
    with torch.no_grad():
        ref, _ = forward(tcfg, tparams, {"tokens": tokens, "vision_tokens": vis})
    cache = init_cache(tcfg, 1, S, torch.float32, device="cpu")
    _, raw = prefill(tcfg, tparams, {"tokens": tokens[:, :1], "vision_tokens": vis})
    for name, t in raw["cross"].items():
        cache["cross"][name].copy_(t)
    errs = []
    for t in range(S):
        lg, cache = decode_step(tcfg, tparams, cache, tokens[:, t : t + 1], torch.full((1,), t, dtype=torch.int32))
        errs.append(float((lg - ref[:, t]).abs().max()))
    assert max(errs) < 5e-4, errs


# ---------------------------------------------------------------------------
# forward, loss, gradients
# ---------------------------------------------------------------------------


def _batch(cfg, B=2, S=16, seed=6):
    rng = np.random.default_rng(seed)
    tok = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    return {"tokens": tok, "labels": np.roll(tok, -1, axis=1), "vision_tokens": _vision(cfg, B, seed + 1)}


@pytest.mark.parametrize(
    "variant,jax_impl,impl,dtype",
    [("plain", "xla", "torch", "fp32"), ("plain", "flash", "flash", "fp32"), ("two_groups", "xla", "torch", "fp32"),
     ("plain", "xla", "torch", "bf16"), ("two_groups", "flash", "flash", "bf16"), ("bias", "xla", "torch", "fp32")],
    ids=["fp32-torch", "fp32-flash", "two-groups-fp32", "bf16-torch", "two-groups-bf16-flash", "bias-fp32"],
)
def test_forward_and_loss_match_jax(variant, jax_impl, impl, dtype):
    jcfg, tcfg, jparams, tparams = models(variant)
    jdt, tdt = {"fp32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}[dtype]
    batch = _batch(tcfg)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    ref, jaux = jax_forward(jcfg, jparams, jb, attn_impl=jax_impl, compute_dtype=jdt)
    jl, _ = jax_loss_fn(jcfg, jparams, jb, attn_impl=jax_impl, compute_dtype=jdt)
    with torch.no_grad():  # flash is forward only
        got, aux = forward(tcfg, tparams, tb, attn_impl=impl, compute_dtype=tdt)
        tl, _ = loss_fn(tcfg, tparams, tb, attn_impl=impl, compute_dtype=tdt)
    assert got.shape == ref.shape and float(aux) == float(jaux) == 0.0
    if dtype == "fp32":
        logits_tol, loss_rel = 1e-4, 1e-6
    else:  # bf16: twice what bf16 itself moves the JAX logits off its fp32 run
        ref32, _ = jax_forward(jcfg, jparams, jb, attn_impl="xla", compute_dtype=jnp.float32)
        logits_tol, loss_rel = 2 * float(np.abs(np.asarray(ref, np.float32) - np.asarray(ref32)).max()), 2e-3
    assert float(np.abs(got.numpy() - np.asarray(ref, np.float32)).max()) < logits_tol
    assert float(tl) == pytest.approx(float(jl), rel=loss_rel)


def test_fp8_is_refused_as_in_jax():
    from repro_torch.config import PrecisionConfig, RunConfig
    from repro_torch.train import init_train_state, make_train_step

    jcfg, tcfg, jparams, tparams = models()

    class Ctx:  # any fp8 context: the family is refused before it is read
        pass

    with pytest.raises(ValueError, match="fp8 training is not supported for family=vlm"):
        forward(tcfg, tparams, {k: torch.from_numpy(v) for k, v in _batch(tcfg).items()}, fp8=Ctx())
    # the train step falls back to bf16 (no fp8 state), as the reference's does for an unsupported family
    run = RunConfig(arch=ARCH, precision=PrecisionConfig(fp8=True))
    assert init_train_state(tcfg, run, device="cpu").fp8 is None
    assert callable(make_train_step(tcfg, run))


@pytest.mark.parametrize("remat", ["none", "full"])
def test_gradients_match_jax_grad(remat):
    jcfg, tcfg, jparams, tparams = models("two_groups")
    batch = _batch(tcfg, S=12, seed=13)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    jgrad = jax.grad(lambda p: jax_loss_fn(jcfg, p, jb, remat=remat, compute_dtype=jnp.float32)[0])(jparams)
    params = tparams
    leaves = tree_leaves(params)
    for t in leaves:
        t.requires_grad_(True)
        t.grad = None
    try:
        loss, _ = loss_fn(tcfg, params, {k: torch.from_numpy(v) for k, v in batch.items()}, remat=remat,
                          compute_dtype=torch.float32)
        loss.backward()
        bridged = params_from_jax(tcfg, jax.tree.map(np.asarray, jgrad), device="cpu")
        for path, t, ref in zip(tree_paths(params), leaves, tree_leaves(bridged)):
            scale = max(float(ref.abs().max()), 1e-12)
            assert float((t.grad - ref).abs().max()) / scale < 1e-4, path
        gates = [tparams["blocks"][gi]["cross"]["gate_mlp"].grad for gi in range(2)]
        assert all(float(g.abs().max()) > 0 for g in gates)  # the gates learn
    finally:
        for t in leaves:
            t.requires_grad_(False)
            t.grad = None


def test_synthetic_batch_has_vision_tokens():
    _, tcfg, _, _ = models()
    a = synthetic_batch(tcfg, step=3, global_batch=2, seq_len=16, seed=1, device="cpu")
    b = synthetic_batch(tcfg, step=3, global_batch=2, seq_len=16, seed=1, device="cpu")
    c = synthetic_batch(tcfg, step=4, global_batch=2, seq_len=16, seed=1, device="cpu")
    v = a["vision_tokens"]
    assert v.dtype == torch.float32 and v.shape == (2, tcfg.vision.num_image_tokens, tcfg.d_model)
    assert torch.equal(v, b["vision_tokens"]) and not torch.equal(v, c["vision_tokens"])
    assert abs(float(v.mean())) < 0.2 and 0.8 < float(v.std()) < 1.2
    loss, _ = loss_fn(tcfg, models()[3], a)
    assert np.isfinite(float(loss))
