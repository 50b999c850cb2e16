"""The port's speculative decoding against the JAX package's, on the CPU.

* ``ngram_draft`` and ``make_draft_config`` equal the JAX functions.
* ``truncate_block_rows`` zeroes exactly the rows the JAX function zeroes
  (random pools and ranges, ``end <= start`` rows, lanes past the table).
* ``verify_step`` against JAX ``verify_step`` (``attn_impl="xla"`` and the
  Pallas kernel in interpret mode) on the same bridged weights, fp32 pools:
  the logits of every lane agree to 1e-4 (sums in another order), as
  ``test_torch_model.py`` holds ``prefill_step``; the pools to 1e-5.
* ``decode_step`` on the dense ring cache against JAX's, with a window
  shorter than the run so the ring wraps: logits to 1e-4 every step.
* ``spec_accept``: on greedy rows ``n_acc`` and ``final`` equal JAX's
  exactly (invalid positions, full acceptance and its bonus); sampled rows
  follow the target law (empirical frequencies within 0.04 of it, as
  ``tests/test_spec_decode.py`` holds the JAX function).
* ``DraftModel``: greedy drafts and their one-hot laws equal JAX's through
  catch-up, rollback and a cold replay.
* The spec engine against the JAX spec engine, legacy and fused walks, and
  against the port's plain legacy walk: greedy tokens, finish reasons and
  every integer stat but ``cache_bytes`` (the port keeps one block table,
  the JAX engine one per layer) equal.  fp32 pools; the eos id lies
  outside the vocab unless a case names one.  The moe cases (qwen3-moe
  with the n-gram drafter, arctic with a half-depth arctic draft) run at
  capacity factor 8, where no pair can be dropped.
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
from repro.models import decode_step as jax_decode_step
from repro.models import init_cache as jax_init_cache
from repro.models import init_paged_cache as jax_init_paged_cache
from repro.models import init_params as jax_init_params
from repro.models import prefill_step as jax_prefill_step
from repro.models import verify_step as jax_verify_step
from repro.serving import InferenceEngine as JaxEngine
from repro.serving.kvcache import truncate_block_rows as jax_truncate_block_rows
from repro.serving.sampler import spec_accept as jax_spec_accept
from repro.serving.spec_decode import DraftModel as JaxDraftModel
from repro.serving.spec_decode import make_draft_config as jax_make_draft_config
from repro.serving.spec_decode import ngram_draft as jax_ngram_draft
from repro_torch.bridge import params_from_jax
from repro_torch.config import reduce_for_smoke
from repro_torch.configs import get_config
from repro_torch.models import decode_step, init_cache, init_paged_cache, prefill_step, verify_step
from repro_torch.serving import InferenceEngine
from repro_torch.serving.kvcache import truncate_block_rows
from repro_torch.serving.sampler import spec_accept
from repro_torch.serving.spec_decode import DraftModel, make_draft_config, ngram_draft

torch.set_num_threads(2)

EOS_OUT = 1 << 30  # outside every vocab: requests run to their length


def _bridged(arch, key=0, **overrides):
    jcfg = jax_reduce(jax_get_config(arch)).replace(**overrides)
    tcfg = reduce_for_smoke(get_config(arch)).replace(**overrides)
    if jcfg.moe is not None:  # capacity cannot bind: cf >= num_experts / top_k
        jcfg = jcfg.replace(moe=dataclasses.replace(jcfg.moe, capacity_factor=8.0))
        tcfg = tcfg.replace(moe=dataclasses.replace(tcfg.moe, capacity_factor=8.0))
    jparams = jax_init_params(jcfg, jax.random.PRNGKey(key), jnp.float32)
    return jcfg, tcfg, jparams, params_from_jax(tcfg, jax.tree.map(np.asarray, jparams), device="cpu")


# ---------------------------------------------------------------------------
# the drafters' pure-Python parts
# ---------------------------------------------------------------------------


def _contexts():
    rng = np.random.default_rng(5)
    ctxs = [
        [1, 2, 3, 4, 1, 2, 3, 4, 1, 2],  # a cycle
        [9] * 6,  # a run
        [7, 8, 5, 0, 8, 3, 7, 8],  # the longest suffix wins
        [3, 4, 9, 3, 4],  # a match near the end extrapolates its period
        [1, 2, 3, 4, 5],  # no repeat
        [5],
        [],
    ]
    for _ in range(40):
        n = int(rng.integers(2, 30))
        ctxs.append([int(t) for t in rng.integers(0, int(rng.integers(2, 6)), n)])
    return ctxs


def test_ngram_draft_matches_jax():
    proposed = 0
    for ctx in _contexts():
        for k in (0, 1, 3, 4):
            for max_ngram in (1, 2, 3):
                got = ngram_draft(ctx, k, max_ngram=max_ngram)
                assert got == jax_ngram_draft(ctx, k, max_ngram=max_ngram), (ctx, k, max_ngram)
                proposed += bool(got)
    assert proposed > 100  # the contexts repeat: most calls propose
    assert ngram_draft([9] * 6, 4) == [9, 9, 9, 9]
    assert ngram_draft([1, 2, 3, 4, 1, 2, 3, 4, 1, 2], 3) == [3, 4, 1]


@pytest.mark.parametrize("arch", ["olmo-1b", "mistral-nemo-12b", "gemma-7b"])
def test_make_draft_config_matches_jax(arch):
    jcfg, tcfg = jax_get_config(arch), get_config(arch)
    for n in (None, 1, 3):
        j, t = jax_make_draft_config(jcfg, num_layers=n), make_draft_config(tcfg, num_layers=n)
        assert (t.name, t.num_layers, t.padded_vocab, t.family, t.d_model) == (
            j.name, j.num_layers, j.padded_vocab, j.family, j.d_model
        )
    assert make_draft_config(tcfg).num_layers == tcfg.num_layers // 2


# ---------------------------------------------------------------------------
# truncate_block_rows
# ---------------------------------------------------------------------------


def test_truncate_block_rows_matches_jax():
    rng = np.random.default_rng(3)
    L, N, bs, KV, hd, B, nb = 2, 12, 4, 2, 3, 5, 3
    for trial in range(6):
        k = rng.standard_normal((L, N, bs, KV, hd)).astype(np.float32)
        v = rng.standard_normal((L, N, bs, KV, hd)).astype(np.float32)
        tbl = rng.integers(1, N, (B, nb)).astype(np.int32)
        tbl[1, 2:] = 0  # null padding past a short request's blocks
        span = 5
        start = rng.integers(0, nb * bs, B).astype(np.int32)
        end = start + rng.integers(-2, span + 2, B).astype(np.int32)
        start[0], end[0] = 3, 3  # empty range
        start[2], end[2] = 7, 4  # end < start
        start[3], end[3] = nb * bs - 2, nb * bs + 3  # lanes past the table
        jout = jax_truncate_block_rows(
            {"k": jnp.asarray(k), "v": jnp.asarray(v)}, jnp.asarray(tbl), jnp.asarray(start), jnp.asarray(end),
            span=span,
        )
        tk, tv = torch.from_numpy(k.copy()), torch.from_numpy(v.copy())
        out = truncate_block_rows(
            {"k": tk, "v": tv}, torch.from_numpy(tbl), torch.from_numpy(start), torch.from_numpy(end), span=span
        )
        assert out["k"] is tk and out["v"] is tv  # in place
        np.testing.assert_array_equal(tk.numpy(), np.asarray(jout["k"]))
        np.testing.assert_array_equal(tv.numpy(), np.asarray(jout["v"]))
        assert (tk.numpy() != k).any(axis=(0, 3, 4)).sum() > 0 or trial  # something was zeroed
    # the rows of live lanes, and nothing else outside the null block
    k = np.ones((1, 4, 4, 1, 1), np.float32)
    tk = torch.from_numpy(k.copy())
    truncate_block_rows({"k": tk, "v": tk.clone()}, torch.tensor([[2, 3]], dtype=torch.int32),
                        torch.tensor([2], dtype=torch.int32), torch.tensor([6], dtype=torch.int32), span=5)
    zeroed = {(b, o) for b in range(1, 4) for o in range(4) if tk[0, b, o, 0, 0] == 0}
    assert zeroed == {(2, 2), (2, 3), (3, 0), (3, 1)}


# ---------------------------------------------------------------------------
# verify_step and the dense ring cache's decode_step
# ---------------------------------------------------------------------------

BS, NB, NBLK = 8, 4, 9
HIST = (10, 13)  # each request's prefilled history; its verify window starts there
K = 4


@pytest.mark.parametrize("jax_impl", ["xla", "pallas"])
def test_verify_step_matches_jax(jax_impl):
    jcfg, tcfg, jparams, tparams = _bridged("olmo-1b", key=3)
    rng = np.random.default_rng(9)
    rows = np.array([[1, 2, 3, 0], [4, 5, 6, 0]], np.int32)
    hists = [rng.integers(0, jcfg.vocab_size, n).astype(np.int32) for n in HIST]
    tokens = rng.integers(0, jcfg.vocab_size, (2, K + 1)).astype(np.int32)
    start = np.array(HIST, np.int32)

    jcache = jax_init_paged_cache(jcfg, NBLK, BS, 2, NB, jnp.float32)
    tcache = init_paged_cache(tcfg, NBLK, BS, 2, NB, torch.float32, device="cpu")
    for b, h in enumerate(hists):
        _, jcache = jax_prefill_step(
            jcfg, jparams, jcache, jnp.asarray(h[None]), jnp.asarray([0], jnp.int32), jnp.asarray(rows[b : b + 1])
        )
        prefill_step(tcfg, tparams, tcache, torch.from_numpy(h[None]), torch.tensor([0], dtype=torch.int32),
                     torch.from_numpy(rows[b : b + 1]))
    jlogits, jcache = jax_verify_step(
        jcfg, jparams, jcache, jnp.asarray(tokens), jnp.asarray(start), jnp.asarray(rows), attn_impl=jax_impl
    )
    tlogits, tcache = verify_step(
        tcfg, tparams, tcache, torch.from_numpy(tokens), torch.from_numpy(start), torch.from_numpy(rows)
    )
    assert tlogits.shape == (2, K + 1, tcfg.padded_vocab)
    err = float(np.max(np.abs(tlogits.numpy() - np.asarray(jlogits))))
    assert err < 1e-4, f"logits differ by {err}"
    for name in ("k", "v"):
        got = tcache[name][:, 1:7].numpy()
        assert np.abs(got - np.asarray(jcache[name])[:, 1:7]).max() < 1e-5, name


@pytest.mark.parametrize("arch,overrides", [("olmo-1b", {}), ("olmo-1b", {"sliding_window": 8}),
                                            ("gemma-7b", {"attn_logit_softcap": 30.0})])
def test_dense_cache_decode_matches_jax(arch, overrides):
    """The ring holds W = min(window, seq_len) slots: with a window of 8
    and 14 steps it wraps; two rows decode at different positions."""
    jcfg, tcfg, jparams, tparams = _bridged(arch, key=1, **overrides)
    B, seq_len, steps = 2, 24, 14
    rng = np.random.default_rng(4)
    toks = rng.integers(0, jcfg.vocab_size, (steps, B, 1)).astype(np.int32)
    jcache = jax_init_cache(jcfg, B, seq_len, jnp.float32)
    tcache = init_cache(tcfg, B, seq_len, torch.float32, device="cpu")
    assert tcache["k"].shape == tuple(np.asarray(jcache["k"]).shape)
    assert (tcache["pos"] == -1).all()
    jdecode = jax.jit(lambda c, t, q: jax_decode_step(jcfg, jparams, c, t, q))
    for t in range(steps):
        pos = np.array([t, t + 3], np.int32)
        jl, jcache = jdecode(jcache, jnp.asarray(toks[t]), jnp.asarray(pos))
        tl, tcache = decode_step(tcfg, tparams, tcache, torch.from_numpy(toks[t]), torch.from_numpy(pos))
        err = float(np.max(np.abs(tl.numpy() - np.asarray(jl))))
        assert err < 1e-4, f"step {t}: logits differ by {err}"
    np.testing.assert_array_equal(tcache["pos"].numpy(), np.asarray(jcache["pos"]))
    assert np.abs(tcache["k"].numpy() - np.asarray(jcache["k"])).max() < 1e-5


# ---------------------------------------------------------------------------
# spec_accept
# ---------------------------------------------------------------------------


def test_spec_accept_matches_jax_on_greedy_rows():
    B, V = 6, 64
    rng = np.random.default_rng(2)
    logits = rng.standard_normal((B, K + 1, V)).astype(np.float32)
    argmax = logits.argmax(-1)
    drafts = argmax[:, :K].astype(np.int32).copy()
    valid = np.ones((B, K), bool)
    drafts[0, 0] = (argmax[0, 0] + 1) % V  # the first draft wrong
    drafts[1, 2] = (argmax[1, 2] + 1) % V  # the third wrong
    # row 2: every draft right, the bonus comes from lane K
    valid[3, 1:] = False  # one valid draft, right, then no window
    valid[4] = False  # no window at all: a plain step
    valid[5, 3] = False  # three right, the fourth not drafted
    temps = np.zeros((B,), np.float32)
    top_ks = np.array([0, 3, 0, 0, 5, 0], np.int32)  # greedy rows ignore top-k
    q = np.eye(V, dtype=np.float32)[drafts]  # one-hot laws
    jn, jf = jax_spec_accept(
        jnp.asarray(logits), jnp.asarray(drafts), jnp.asarray(q), jnp.asarray(valid), jnp.asarray(temps),
        jnp.asarray(top_ks), jax.random.PRNGKey(0),
    )
    for probs in (None, torch.from_numpy(q)):
        tn, tf = spec_accept(
            torch.from_numpy(logits), torch.from_numpy(drafts), probs, torch.from_numpy(valid),
            torch.from_numpy(temps), torch.from_numpy(top_ks), torch.Generator().manual_seed(0),
        )
        assert tn.tolist() == np.asarray(jn).tolist() == [0, 2, K, 1, 0, 3]
        assert tf.tolist() == np.asarray(jf).tolist()
        assert tf.tolist() == [argmax[b, n] for b, n in enumerate(tn.tolist())]


def test_spec_accept_follows_the_target_law():
    """A deliberately bad one-hot draft (token 0 every time): the first
    emitted token of each row must still follow softmax(logits)."""
    V, N = 8, 4000
    g = torch.Generator().manual_seed(2)
    logits1 = torch.randn((1, 2, V), generator=g)
    logits = logits1.expand(N, 2, V).contiguous()
    drafts = torch.zeros((N, 1), dtype=torch.int32)
    for probs in (None, torch.nn.functional.one_hot(drafts.long(), V).float()):
        n_acc, final = spec_accept(
            logits, drafts, probs, torch.ones((N, 1), dtype=torch.bool), torch.ones(N), torch.zeros(N, dtype=torch.int32),
            torch.Generator().manual_seed(7),
        )
        emitted = torch.where(n_acc >= 1, torch.zeros_like(final), final)
        freq = torch.bincount(emitted.long(), minlength=V).float() / N
        p = torch.softmax(logits1[0, 0], -1)
        assert float((freq - p).abs().max()) < 0.04, (freq, p)


# ---------------------------------------------------------------------------
# DraftModel
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("which", ["self", "make_draft_config"])
def test_draft_model_matches_jax_through_rollback(which):
    """The target as its own drafter, and a ``make_draft_config`` draft
    whose JAX weights ``params_from_jax`` bridges (the draft tree is a
    parameter tree of fewer layers)."""
    jcfg, tcfg, jparams, tparams = _bridged("olmo-1b", key=2, num_layers=4)
    if which == "make_draft_config":
        jcfg, tcfg = jax_make_draft_config(jcfg), make_draft_config(tcfg)
        jparams = jax_init_params(jcfg, jax.random.PRNGKey(6), jnp.float32)
        tparams = params_from_jax(tcfg, jax.tree.map(np.asarray, jparams), device="cpu")
        assert len(tparams["blocks"]) == tcfg.num_layers == 2
        np.testing.assert_array_equal(tparams["blocks"][1]["attn"]["wq"].numpy(),
                                      np.asarray(jparams["blocks"]["attn"]["wq"][1]))
    jdm = JaxDraftModel(jcfg, jparams, max_batch=2, max_seq=64)
    tdm = DraftModel(tcfg, tparams, max_batch=2, max_seq=64, device="cpu")
    ctx = [5, 9, 12, 7, 3]
    steps = [
        ("draft", 0, ctx, 3),
        ("rollback", 0, len(ctx)),  # the target rejected everything
        ("draft", 0, ctx + [42], 3),  # the correction extends the context
        ("rollback", 0, len(ctx) + 2),
        ("draft", 0, ctx + [42, 11, 8], 4),
        ("draft", 1, [30, 31], 2),  # another slot, its own cache
        ("reset", 0),
        ("draft", 0, ctx + [42], 3),  # a cold replay
    ]
    out = []
    for step in steps:
        op, slot, *rest = step
        if op != "draft":
            for dm in (jdm, tdm):
                getattr(dm, op)(slot, *rest)
        else:
            (jd, jq), (td, tq) = jdm.draft(slot, *rest), tdm.draft(slot, *rest)
            assert td == jd and len(td) == rest[1]
            assert tq.shape == (len(td), tcfg.padded_vocab)
            np.testing.assert_array_equal(tq, np.asarray(jq))  # greedy: one-hot
            assert all(tq[i, td[i]] == 1.0 for i in range(len(td)))
            assert list(tdm.lens) == list(jdm.lens)
            out.append(td)
    assert out[1] == out[-1], "rollback + catch-up diverged from a cold start"


# ---------------------------------------------------------------------------
# the engine
# ---------------------------------------------------------------------------

PROMPTS = [[7, 3, 9, 4] * 4 + [5], [5, 9, 12, 5, 9, 12, 5, 9, 12, 2], [30, 31]]
SHARED = [7, 3, 9, 4, 11, 2, 6, 8, 13, 5, 10, 12, 14, 15, 16, 17]
PREFIX_PROMPTS = [SHARED + [30 + i, 40, 41, 40, 41, 40, 41] for i in range(3)]


def _engine(cls, cfg, params, **kw):
    base = dict(max_batch=2, max_seq=64, block_size=8, eos_token=EOS_OUT)
    base.update(kw)
    if cls is JaxEngine:
        base["cache_dtype"] = jnp.float32
    else:
        base.update(cache_dtype=torch.float32, device="cpu")
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        return cls(cfg, params, **base)


def _drain(eng, prompts=PROMPTS, max_new=6):
    reqs = [eng.submit(p, max_new_tokens=max_new) for p in prompts]
    eng.run_until_drained()
    return reqs


def _eos_probe_token(tcfg, tparams):
    """The fourth greedy token of PROMPTS[0] under plain decoding: as the
    eos id it stops the request inside a verify window."""
    eng = _engine(InferenceEngine, tcfg, tparams)
    (r,) = _drain(eng, [PROMPTS[0]], max_new=8)
    return r.generated[3]


# name: (arch, overrides, mode, engine kwargs, drive).  mode "draft" drafts
# with make_draft_config's depth and bridged random weights, "self" with
# the target itself (draft_cfg = cfg, draft_params = params).
ENGINE_CASES = {
    "olmo_ngram": ("olmo-1b", {}, "ngram", {}, _drain),
    "olmo_draft": ("olmo-1b", {}, "draft", {}, _drain),
    "olmo_window_8_ngram": ("olmo-1b", {"sliding_window": 8}, "ngram", {},
                            lambda eng: _drain(eng, max_new=12)),
    "olmo_window_8_self_draft": ("olmo-1b", {"sliding_window": 8}, "self", {},
                                 lambda eng: _drain(eng, max_new=12)),
    "mistral_gqa_draft": ("mistral-nemo-12b", {}, "draft", {}, _drain),
    "gemma_softcap_30_self_draft": ("gemma-7b", {"attn_logit_softcap": 30.0}, "self", {}, _drain),
    "prefix_budget_4": ("olmo-1b", {}, "ngram", dict(prefix_cache=True, prefill_budget=4),
                        lambda eng: _drain(eng, PREFIX_PROMPTS)),
    "max_new_2": ("olmo-1b", {}, "ngram", {}, lambda eng: _drain(eng, max_new=2)),
    "eos_mid_window": ("olmo-1b", {}, "self", {"eos_token": "probe"}, lambda eng: _drain(eng, max_new=8)),
    # capacity 7 blocks: with the 4 positions of headroom one 17-token
    # request (4 blocks) and one 10-token request (3 blocks) fit at once
    "tight_blocks": ("olmo-1b", {}, "ngram", dict(num_blocks=8), lambda eng: _drain(eng, max_new=10)),
    # the moe family at capacity factor 8: the verify windows route like
    # one-token decodes only where capacity cannot bind
    "qwen3_moe_ngram": ("qwen3-moe-235b-a22b", {}, "ngram", {}, _drain),
    "arctic_draft": ("arctic-480b", {}, "draft", {}, _drain),
}


def _int_stats(s: dict) -> dict:
    return {k: v for k, v in s.items() if type(v) is int and k != "cache_bytes"}


@pytest.mark.parametrize("name", list(ENGINE_CASES))
def test_spec_engine_matches_jax(name):
    arch, overrides, mode, kw, drive = ENGINE_CASES[name]
    jcfg, tcfg, jparams, tparams = _bridged(arch, **overrides)
    kw = dict(kw)
    if kw.get("eos_token") == "probe":
        kw["eos_token"] = _eos_probe_token(tcfg, tparams)
    spec = {side: dict(spec_decode="draft" if mode == "self" else mode, spec_k=K) for side in ("jax", "torch")}
    if mode == "self":
        spec["jax"].update(draft_cfg=jcfg, draft_params=jparams)
        spec["torch"].update(draft_cfg=tcfg, draft_params=tparams)
    elif mode == "draft":
        jd_cfg, td_cfg = jax_make_draft_config(jcfg), make_draft_config(tcfg)
        jd_params = jax_init_params(jd_cfg, jax.random.PRNGKey(7), jnp.float32)
        spec["jax"].update(draft_params=jd_params)
        spec["torch"].update(draft_params=params_from_jax(td_cfg, jax.tree.map(np.asarray, jd_params), device="cpu"))

    plain = drive(_engine(InferenceEngine, tcfg, tparams, **kw))
    out = {}
    for side, cls, cfg, params in (("jax", JaxEngine, jcfg, jparams), ("torch", InferenceEngine, tcfg, tparams)):
        for fused in (False, True):
            eng = _engine(cls, cfg, params, fused=fused, **kw, **spec[side])
            reqs = drive(eng)
            assert all(r.state.name == "DONE" for r in reqs)
            s = eng.stats()
            assert s["alloc_blocks_in_use"] == 0 and s["alloc_total_allocs"] == s["alloc_total_frees"]
            out[side, fused] = ([list(r.generated) for r in reqs], [r.finish_reason for r in reqs], s)
    tokens, reasons, stats = out["torch", False]
    assert tokens == [list(r.generated) for r in plain], "speculative decoding changed the greedy tokens"
    assert reasons == [r.finish_reason for r in plain]
    for fused in (False, True):
        assert out["torch", fused][:2] == out["jax", fused][:2] == (tokens, reasons), f"fused={fused}"
        js, ts = _int_stats(out["jax", fused][2]), _int_stats(out["torch", fused][2])
        common = js.keys() & ts.keys()
        assert {"spec_steps", "verify_tokens", "drafted_tokens", "accepted_tokens", "dispatches_total",
                "host_syncs_total", "decode_steps", "tokens_out"} <= common
        assert {k: ts[k] for k in common} == {k: js[k] for k in common}, f"fused={fused}"
        for key in ("acceptance_rate", "accepted_per_step"):
            assert out["torch", fused][2][key] == out["jax", fused][2][key]
    if mode == "self" and name != "eos_mid_window":  # an EOS cut leaves accepted drafts uncommitted
        assert stats["acceptance_rate"] == 1.0  # the target drafts for itself, fp32 on both sides
    if name == "eos_mid_window":
        assert reasons[0] == "eos" and len(tokens[0]) == 4 and tokens[0][-1] == kw["eos_token"]
    if name == "prefix_budget_4":
        assert stats["prefix_hit_tokens"] >= 16 and stats["drafted_tokens"] > 0
    if name == "max_new_2":
        assert all(len(t) == 2 for t in tokens)
    if name == "tight_blocks":
        # the headroom fills the pool: the third request waits for blocks
        assert stats["alloc_peak_in_use"] == stats["alloc_capacity"] == 7


def test_spec_headroom_enforced_at_submit():
    """Admission reserves spec_k positions of rollback headroom (the JAX
    package's test of the same name, with an eos id outside the vocab so
    the request runs to its length)."""
    _, tcfg, _, tparams = _bridged("olmo-1b")
    eng = _engine(InferenceEngine, tcfg, tparams, max_batch=1, max_seq=32, spec_decode="ngram", spec_k=4)
    with pytest.raises(ValueError, match="headroom"):
        eng.submit(list(range(2, 22)), max_new_tokens=10)  # fits only without spec
    r = eng.submit(list(range(2, 18)), max_new_tokens=10)  # 26 + 4 <= 32
    eng.run_until_drained()
    assert len(r.generated) == 10 and r.finish_reason == "length"


def test_verify_tokens_do_not_deflate_prefix_hit_rate():
    """Verify windows accrue to ``verify_tokens``, never to
    ``prefill_tokens``: the prefix hit rate equals the spec-off run's."""
    _, tcfg, _, tparams = _bridged("olmo-1b")
    kw = dict(prefix_cache=True, prefill_budget=4)
    off = _engine(InferenceEngine, tcfg, tparams, **kw)
    on = _engine(InferenceEngine, tcfg, tparams, spec_decode="ngram", spec_k=4, **kw)
    for eng in (off, on):
        _drain(eng, PREFIX_PROMPTS)
    s_off, s_on = off.stats(), on.stats()
    assert s_on["spec_steps"] > 0 and s_on["verify_tokens"] > 0
    total_prompt = sum(len(p) for p in PREFIX_PROMPTS)
    for s in (s_off, s_on):
        assert s["prefill_tokens"] + s["prefix_hit_tokens"] == total_prompt, s
    assert s_on["prefill_tokens"] == s_off["prefill_tokens"]
    assert s_on["prefix_hit_rate"] == s_off["prefix_hit_rate"] > 0
    assert "verify_tokens" not in s_off  # spec-off stats carry no spec keys
