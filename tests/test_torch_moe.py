"""The port's MoE family (``models/moe.py``, the moe blocks, the engine on
qwen3-moe and arctic) against the JAX package's, on the CPU.

* ``moe_ffn`` against JAX ``moe_ffn`` on bridged smoke weights at the
  published capacity factor 1.25, where capacity binds: T = 128 routes in
  two groups of 64, T = 96 in one; one shared expert; the non-gated GELU.
  The inputs share a component, so the router prefers some experts and
  pairs are dropped (the test counts them).  ``out`` to 4e-6 of its
  largest value (32 fp32 spacings there; the same terms summed in another
  order), ``aux`` to 1e-6 relative.
* The routing itself: each token's set of experts and which of its pairs
  fit the capacity equal the JAX router's one-hot dispatch exactly;
  ``capacity`` equals the JAX ``_capacity``.
* The moe blocks' prefill, chunk and decode steps against the JAX blocks
  on one layer: outputs to 4e-6 of their largest value, the K/V written to
  1e-6.
* The engine at cf 1.25 (capacity binds: the routed batches hold 16 to 64
  lanes against 12 to 40 slots), legacy and fused walks: greedy tokens and
  finish reasons equal to the JAX engine's, pairs dropped in both runs.
  This holds the lanes that are not tokens (idle decode slots, a fused
  batch's pad lanes) to the ids and positions the JAX engine routes.
* The serve launcher on smoke qwen3-moe.
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
from repro.models import blocks as jax_blocks
from repro.models import init_paged_cache as jax_init_paged_cache
from repro.models import init_params as jax_init_params
from repro.models import moe as jax_moe
from repro.serving import InferenceEngine as JaxEngine
from repro_torch.bridge import params_from_jax
from repro_torch.config import reduce_for_smoke
from repro_torch.configs import get_config
from repro_torch.models import blocks, init_paged_cache
from repro_torch.models import moe
from repro_torch.models.cache import layer_cache
from repro_torch.serving import InferenceEngine

torch.set_num_threads(2)

ARCHS = ("qwen3-moe-235b-a22b", "arctic-480b")
EOS_OUT = 1 << 30  # outside every vocab: requests run to their length


def _configs(arch, **moe_overrides):
    jcfg, tcfg = jax_reduce(jax_get_config(arch)), reduce_for_smoke(get_config(arch))
    return tuple(c.replace(moe=dataclasses.replace(c.moe, **moe_overrides)) for c in (jcfg, tcfg))


def _bridged(arch, *, activation=None, **moe_overrides):
    jcfg, tcfg = _configs(arch, **moe_overrides)
    if activation is not None:
        jcfg, tcfg = jcfg.replace(activation=activation), tcfg.replace(activation=activation)
    jparams = jax_init_params(jcfg, jax.random.PRNGKey(0), jnp.float32)
    return jcfg, tcfg, jparams, params_from_jax(tcfg, jax.tree.map(np.asarray, jparams), device="cpu")


def _err(got: torch.Tensor, ref) -> float:
    """Largest difference relative to the reference's largest value."""
    ref = np.asarray(ref)
    return float(np.max(np.abs(got.numpy() - ref))) / max(float(np.max(np.abs(ref))), 1e-30)


REL = 4e-6


def _layer(jparams, layer=0):
    return jax.tree.map(lambda a: a[layer], jparams["blocks"])


def _skewed(shape, seed):
    """Activations that share one component: the router prefers a few
    experts, so capacity binds."""
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(shape) + 2.0 * rng.standard_normal(shape[-1])).astype(np.float32)


class _Drops:
    """Counts the (token, expert) pairs ``moe.route`` drops while active."""

    def __init__(self, monkeypatch):
        self.pairs = self.dropped = 0
        inner = moe.route

        def counting(cfg, router_w, xg):
            r = inner(cfg, router_w, xg)
            self.pairs += r.keep.numel()
            self.dropped += int((~r.keep).sum())
            return r

        monkeypatch.setattr(moe, "route", counting)


# ---------------------------------------------------------------------------
# moe_ffn and the routing
# ---------------------------------------------------------------------------

FFN_CASES = {
    "qwen3_T128_grouped": ("qwen3-moe-235b-a22b", 128, {}, None),
    "qwen3_T96": ("qwen3-moe-235b-a22b", 96, {}, None),
    "arctic_T128_grouped": ("arctic-480b", 128, {}, None),
    "arctic_T96": ("arctic-480b", 96, {}, None),
    "qwen3_shared_expert": ("qwen3-moe-235b-a22b", 96, {"num_shared_experts": 1}, None),
    "qwen3_gelu": ("qwen3-moe-235b-a22b", 128, {}, "gelu"),
    "arctic_shared_gelu": ("arctic-480b", 64, {"num_shared_experts": 1}, "gelu"),
}


@pytest.mark.parametrize("name", list(FFN_CASES))
def test_moe_ffn_matches_jax(name, monkeypatch):
    arch, T, overrides, activation = FFN_CASES[name]
    jcfg, tcfg, jparams, tparams = _bridged(arch, activation=activation, **overrides)
    assert tcfg.moe.capacity_factor == 1.25 and tcfg.moe.group_size == 64
    x = _skewed((2, T // 2, tcfg.d_model), seed=T)
    jout, jaux = jax_moe.moe_ffn(jcfg, _layer(jparams)["moe"], jnp.asarray(x))
    drops = _Drops(monkeypatch)
    out, aux = moe.moe_ffn(tcfg, tparams["blocks"][0]["moe"], torch.from_numpy(x))
    assert out.shape == x.shape
    assert _err(out, jout) < REL
    assert abs(float(aux) - float(jaux)) <= 1e-6 * abs(float(jaux))
    assert drops.pairs == T * tcfg.moe.top_k and drops.dropped > 0, "capacity must bind in this case"


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("T", [40, 64, 96])
def test_routing_and_drops_equal_jax(arch, T):
    """Each token's experts and kept pairs equal the JAX dispatch's, which
    counts priority over the flattened (T k, E) one-hot in token order."""
    jcfg, tcfg, jparams, tparams = _bridged(arch)
    x = _skewed((T, tcfg.d_model), seed=T + 1)
    p = _layer(jparams)["moe"]
    _, onehot, jaux = jax_moe._route(jcfg, p["router"], jnp.asarray(x))
    flat = onehot.reshape(T * jcfg.moe.top_k, -1)
    pos = jnp.cumsum(flat, axis=0) - 1.0
    C = jax_moe._capacity(jcfg.moe, T)
    jkeep = np.asarray(((pos < C) & (flat > 0)).reshape(T, jcfg.moe.top_k, -1).any(axis=1))  # (T, E)
    jsets = np.asarray(onehot.sum(axis=1)) > 0  # (T, E)
    r = moe.route(tcfg, tparams["blocks"][0]["moe"]["router"], torch.from_numpy(x)[None])
    E = tcfg.moe.num_experts
    sets = torch.zeros((T, E), dtype=torch.bool).scatter_(1, r.experts[0], True).numpy()
    kept = torch.zeros((T, E), dtype=torch.bool).scatter_(1, r.experts[0], r.keep[0]).numpy()
    assert np.array_equal(sets, jsets)
    assert np.array_equal(kept, jkeep)
    assert abs(float(r.aux[0]) - float(jaux)) <= 1e-6 * float(jaux)
    assert bool((~r.keep).any()) and not np.array_equal(kept, sets), "capacity must bind in this case"


def test_capacity_matches_jax():
    _, tcfg = _configs("qwen3-moe-235b-a22b")
    full = get_config("qwen3-moe-235b-a22b").moe
    for m in (tcfg.moe, full):
        for cf in (0.5, 1.0, 1.25, 2.0, 8.0, 16.0):
            mm = dataclasses.replace(m, capacity_factor=cf)
            for T in (1, 4, 5, 16, 64, 96, 128, 512, 2048):
                assert moe.capacity(mm, T) == jax_moe._capacity(mm, T)
    assert moe.capacity(full, 128) == 12  # the card's moe_path case: cf 1.25, 128 tokens
    assert moe.capacity(dataclasses.replace(full, capacity_factor=16.0), 512) == 512  # C = T: cannot bind


# ---------------------------------------------------------------------------
# the blocks
# ---------------------------------------------------------------------------

BS, NB = 8, 4


@pytest.mark.parametrize("arch", ARCHS)
def test_moe_blocks_match_jax(arch, monkeypatch):
    """One layer: a blocking prefill of two prompts, two chunks of one
    request through its block table (the second reads the first's K/V),
    then a decode step with an idle slot, all at cf 1.25."""
    jcfg, tcfg, jparams, tparams = _bridged(arch)
    jp, tp = _layer(jparams), tparams["blocks"][0]
    D = tcfg.d_model
    drops = _Drops(monkeypatch)

    x = _skewed((2, 24, D), seed=1)
    jx, jkv = jax_blocks.moe_block_prefill(jcfg, jp, jnp.asarray(x))
    tx, tkv = blocks.moe_block_prefill(tcfg, tp, torch.from_numpy(x))
    assert _err(tx, jx) < REL
    for n in ("k", "v"):
        assert float(np.max(np.abs(tkv[n].numpy() - np.asarray(jkv[n])))) < 1e-6

    jcache = jax.tree.map(lambda a: a[0], jax_init_paged_cache(jcfg, 1 + 2 * NB, BS, 2, NB, jnp.float32))
    tcache = layer_cache(init_paged_cache(tcfg, 1 + 2 * NB, BS, 2, NB, torch.float32, device="cpu"), 0)
    row = np.arange(1, 1 + NB, dtype=np.int32)[None]
    for start, c in ((0, 16), (16, 8)):
        x = _skewed((1, c, D), seed=10 + start)
        jx, jcache = jax_blocks.moe_block_chunk(jcfg, jp, jnp.asarray(x), jcache, jnp.asarray(row),
                                                jnp.asarray([start], jnp.int32))
        tx = blocks.moe_block_chunk(tcfg, tp, torch.from_numpy(x), tcache, torch.from_numpy(row),
                                    torch.tensor([start], dtype=torch.int32), attn_impl="plain")
        assert _err(tx, jx) < REL, f"chunk at {start}"
        for n in ("k", "v"):
            assert float(np.max(np.abs(tcache[n].numpy() - np.asarray(jcache[n])))) < 1e-6

    tbl = np.zeros((2, NB), np.int32)
    tbl[0] = row[0]  # slot 1 idle: a null row at position 0
    jcache["tbl"] = jnp.asarray(tbl)
    tcache["tbl"].copy_(torch.from_numpy(tbl))
    x = _skewed((2, 1, D), seed=3)
    pos = np.array([24, 0], np.int32)
    jx, _ = jax_blocks.moe_block_decode(jcfg, jp, jnp.asarray(x), jcache, jnp.asarray(pos))
    tx = blocks.moe_block_decode(tcfg, tp, torch.from_numpy(x), tcache, torch.from_numpy(pos), attn_impl="plain")
    assert _err(tx, jx) < REL
    assert drops.dropped > 0


def test_bridge_carries_the_moe_subtree():
    """``params_from_jax`` copies the nested ``moe`` tree and arctic's
    ``dense_mlp`` / ``norm_dense`` leaf for leaf, layer by layer, and
    ``init_params`` lays the tree out the same way."""
    from repro_torch.models import init_params

    for arch in ARCHS:
        jcfg, tcfg, jparams, tparams = _bridged(arch)
        want = {"norm1", "attn", "norm2", "moe"} | ({"dense_mlp", "norm_dense"} if tcfg.moe.dense_residual else set())
        fresh = init_params(tcfg, 0, device="cpu")
        for layer in range(tcfg.num_layers):
            tl, jl, fl = tparams["blocks"][layer], _layer(jparams, layer), fresh["blocks"][layer]
            assert set(tl) == set(fl) == want
            assert set(tl["moe"]) == set(fl["moe"]) == {"router", "w_gate", "w_up", "w_down"}
            for sub in want - {"attn"}:
                for leaf, a in jl[sub].items():
                    assert np.array_equal(tl[sub][leaf].numpy(), np.asarray(a)), (arch, layer, sub, leaf)
                    assert fl[sub][leaf].shape == tl[sub][leaf].shape
        E, D, F = tcfg.moe.num_experts, tcfg.d_model, tcfg.moe.expert_d_ff
        assert tuple(tparams["blocks"][0]["moe"]["w_down"].shape) == (E, F, D)
        # fan-in of an (E, D, F) expert weight is E * D, as the JAX package counts it
        w = fresh["blocks"][0]["moe"]["w_up"]
        assert abs(float(w.std()) * np.sqrt(E * D) - 0.987) < 0.05


# ---------------------------------------------------------------------------
# the engine where capacity binds
# ---------------------------------------------------------------------------

BINDING_PROMPTS = [
    [int(t) for t in np.random.default_rng(s).integers(2, 250, n)] for s, n in enumerate((20, 33, 9, 27, 14, 40))
]


def test_binding_capacity_engine_matches_jax(monkeypatch):
    """cf 1.25, prefill budget 16, 4 slots: legacy chunks of 16 tokens,
    fused mixed batches of up to 4 x 16 lanes and 4-row decode steps route
    the lanes that are not tokens with the tokens.  Both walks equal the
    JAX engine's walk of the same name, token for token."""
    jcfg, tcfg, jparams, tparams = _bridged("qwen3-moe-235b-a22b")
    assert tcfg.moe.capacity_factor == 1.25
    kw = dict(max_batch=4, max_seq=96, block_size=8, prefill_budget=16, eos_token=EOS_OUT)
    runs = {}
    drops = _Drops(monkeypatch)
    for fused in (False, True):
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", RuntimeWarning)
            jeng = JaxEngine(jcfg, jparams, fused=fused, cache_dtype=jnp.float32, **kw)
            teng = InferenceEngine(tcfg, tparams, fused=fused, cache_dtype=torch.float32, device="cpu", **kw)
        for side, eng in (("jax", jeng), ("torch", teng)):
            dropped0 = drops.dropped
            reqs = [eng.submit(p, max_new_tokens=8) for p in BINDING_PROMPTS]
            eng.run_until_drained()
            assert eng.allocator.blocks_in_use == 0
            runs[side, fused] = ([list(r.generated) for r in reqs], [r.finish_reason for r in reqs])
            if side == "torch":
                assert drops.dropped > dropped0, f"no pair was dropped in the fused={fused} run"
        assert runs["torch", fused] == runs["jax", fused], f"fused={fused}"
        assert set(runs["torch", fused][1]) == {"length"}


def test_serve_launcher_serves_qwen3_moe(capsys):
    from repro_torch.launch.serve import main

    stats = main(["--device", "cpu", "--arch", "qwen3-moe-235b-a22b", "--requests", "5", "--max-new", "4",
                  "--shared-prefix", "16", "--prefill-budget", "16", "--fused"])
    out = capsys.readouterr().out
    assert "qwen3-moe-235b-a22b" in out and "on cpu" in out
    assert stats["requests_done"] == 5 and stats["alloc_blocks_in_use"] == 0
    assert stats["prefix_hit_tokens"] > 0 and stats["fused"]
