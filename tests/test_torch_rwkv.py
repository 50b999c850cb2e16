"""The port's RWKV6 model (the ssm family) against the JAX package's, on the
CPU, at smoke size (``reduce_for_smoke(get_config("rwkv6-7b"))``: 2 layers,
d_model 64, 4 heads of 16, chunk 16).

Both packages run the same weights (``repro_torch.bridge.params_from_jax``)
in fp32: the time mix (from a zero and from a carried state, over two
chunks and over a ragged length that falls back to one chunk), the decode
step, the channel mix, the three blocks, ``forward`` and ``loss_fn`` with
``wkv_impl="chunked"`` and ``"kernel"`` (K5's plain version on the CPU),
and one train step from one bridged state.  The same functions with sums
in another order: outputs and logits agree to 1e-4 absolute (values of
order 1; the WKV scan alone to 1e-4, as ``tests/test_kernels.py`` holds
it), states to 1e-4, losses to 1e-6 relative, parameters after the step to
1e-6.  ``"kernel"`` refuses gradients and a carried state, and the ssm
family refuses an FP8 context, as in the JAX package.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config import ParallelConfig as JaxParallelConfig
from repro.config import PrecisionConfig as JaxPrecisionConfig
from repro.config import RunConfig as JaxRunConfig
from repro.config import TrainConfig as JaxTrainConfig
from repro.config.model import reduce_for_smoke as jax_reduce
from repro.configs import get_config as jax_get_config
from repro.models import blocks as jax_blocks
from repro.models import forward as jax_forward
from repro.models import init_params as jax_init_params
from repro.models import rwkv as jax_rwkv
from repro.train.step import init_train_state as jax_init_train_state
from repro.train.step import loss_fn as jax_loss_fn
from repro.train.step import make_train_step as jax_make_train_step
from repro_torch.bridge import params_from_jax, train_state_from_jax
from repro_torch.config import ParallelConfig, PrecisionConfig, RunConfig, TrainConfig, reduce_for_smoke
from repro_torch.configs import get_config
from repro_torch.fp8 import make_fp8_ctx
from repro_torch.kernels.rwkv6_scan import wkv6
from repro_torch.models import blocks, forward, init_params, param_specs, rwkv
from repro_torch.train import init_train_state, loss_fn, make_train_step
from repro_torch.utils.tree import tree_leaves, tree_paths

torch.set_num_threads(2)

ARCH = "rwkv6-7b"
B, S, LR = 2, 32, 1e-3
TOL = 1e-4


@pytest.fixture(scope="module")
def models():
    jcfg, tcfg = jax_reduce(jax_get_config(ARCH)), reduce_for_smoke(get_config(ARCH))
    jparams = jax_init_params(jcfg, jax.random.PRNGKey(3), jnp.float32)
    # a bonus 25x the init's (normal x 0.02), so that the diagonal term shows in the outputs
    jparams["blocks"]["time_mix"]["bonus"] = jparams["blocks"]["time_mix"]["bonus"] * 25.0
    tparams = params_from_jax(tcfg, jax.tree.map(np.asarray, jparams), device="cpu")
    return jcfg, tcfg, jparams, tparams


def _layer(jparams, layer=0):
    return jax.tree.map(lambda a: a[layer], jparams["blocks"])


def _x(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _np(t):
    return t.detach().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def _close(got, ref, tol=TOL):
    got, ref = _np(got), _np(ref)
    assert got.shape == ref.shape
    err = float(np.abs(got - ref).max())
    assert err < tol, err


def test_param_tree_matches_jax(models):
    jcfg, tcfg, jparams, tparams = models
    from repro.models.initializers import param_specs as jax_param_specs

    jspecs = jax_param_specs(jcfg)
    tspecs = param_specs(tcfg)
    for path, t in zip(tree_paths(tparams), tree_leaves(tparams)):
        node = jspecs
        for key in path:
            node = node[key] if isinstance(key, str) else node
        stacked = path[0] == "blocks"
        assert tuple(node.shape[1:] if stacked else node.shape) == tuple(t.shape), path
    assert len(tree_leaves(tspecs)) == len(tree_leaves(tparams))
    assert tuple(tparams["blocks"][0]["time_mix"]["maa_w2"].shape) == (5, tcfg.rwkv.lora_rank_mix, tcfg.d_model)
    full = sum(int(np.prod(s.shape)) for s in tree_leaves(param_specs(get_config(ARCH))))
    assert full == 7_577_018_368
    # random init: the reference's init kinds (decay base in [-6, -1], ones, zeros)
    p = init_params(tcfg, 0, device="cpu")["blocks"][1]["time_mix"]
    assert float(p["decay"].min()) == -6.0 and float(p["decay"].max()) == pytest.approx(-1.0)
    assert bool((p["ln_x_scale"] == 1).all()) and bool((p["maa_x"] == 0).all())


@pytest.mark.parametrize("seq,carried", [(32, False), (32, True), (24, True)])
def test_time_mix_matches_jax(models, seq, carried):
    jcfg, tcfg, jparams, tparams = models
    D, H, n = jcfg.d_model, jcfg.num_heads, jcfg.rwkv.head_size
    x = _x((B, seq, D), 1)
    prev = _x((B, D), 2) if carried else None
    state = 0.3 * _x((B, H, n, n), 3) if carried else None
    jp = _layer(jparams)["time_mix"]
    tp = tparams["blocks"][0]["time_mix"]
    jout, (jlast, jstate) = jax_rwkv.time_mix(
        jcfg, jp, jnp.asarray(x), prev_x=None if prev is None else jnp.asarray(prev),
        state=None if state is None else jnp.asarray(state),
    )
    tout, (tlast, tstate) = rwkv.time_mix(
        tcfg, tp, torch.from_numpy(x), prev_x=None if prev is None else torch.from_numpy(prev),
        state=None if state is None else torch.from_numpy(state),
    )
    _close(tout, jout)
    _close(tlast, jlast, 1e-12)
    _close(tstate, jstate)
    if not carried:  # K5 from a zero state: the same outputs, no state
        kout, (_, kstate) = rwkv.time_mix(tcfg, tp, torch.from_numpy(x), wkv_impl="kernel")
        _close(kout, jout)
        assert kstate is None


def test_time_mix_step_and_channel_mix_match_jax(models):
    jcfg, tcfg, jparams, tparams = models
    D, H, n = jcfg.d_model, jcfg.num_heads, jcfg.rwkv.head_size
    x, prev, state = _x((B, 1, D), 4), _x((B, D), 5), 0.3 * _x((B, H, n, n), 6)
    jl, tl = _layer(jparams, 1), tparams["blocks"][1]
    jout, (jlast, jstate) = jax_rwkv.time_mix_step(jcfg, jl["time_mix"], jnp.asarray(x), jnp.asarray(prev), jnp.asarray(state))
    tout, (tlast, tstate) = rwkv.time_mix_step(tcfg, tl["time_mix"], torch.from_numpy(x), torch.from_numpy(prev), torch.from_numpy(state))
    _close(tout, jout)
    _close(tstate, jstate)
    xs = _x((B, S, D), 7)
    for prev_x in (None, prev):
        jout, jlast = jax_rwkv.channel_mix(jcfg, jl["channel_mix"], jnp.asarray(xs), prev_x=None if prev_x is None else jnp.asarray(prev_x))
        tout, tlast = rwkv.channel_mix(tcfg, tl["channel_mix"], torch.from_numpy(xs), prev_x=None if prev_x is None else torch.from_numpy(prev_x))
        _close(tout, jout)
        _close(tlast, jlast, 1e-12)


def test_blocks_match_jax(models):
    jcfg, tcfg, jparams, tparams = models
    D = jcfg.d_model
    x = _x((B, S, D), 8)
    jl, tl = _layer(jparams), tparams["blocks"][0]
    jx = jax_blocks.rwkv_block(jcfg, jl, jnp.asarray(x))
    for impl in ("chunked", "kernel"):
        _close(blocks.rwkv_block(tcfg, tl, torch.from_numpy(x), wkv_impl=impl), jx)
    jx, jcache = jax_blocks.rwkv_block_prefill(jcfg, jl, jnp.asarray(x))
    tx, tcache = blocks.rwkv_block_prefill(tcfg, tl, torch.from_numpy(x))
    _close(tx, jx)
    for k in ("tm_x", "cm_x", "state"):
        _close(tcache[k], jcache[k])
    tok = _x((B, 1, D), 9)
    jx, jcache = jax_blocks.rwkv_block_decode(jcfg, jl, jnp.asarray(tok), jcache, jnp.asarray([S, S], jnp.int32))
    tx, tcache = blocks.rwkv_block_decode(tcfg, tl, torch.from_numpy(tok), tcache, torch.tensor([S, S]))
    _close(tx, jx)
    for k in ("tm_x", "cm_x", "state"):
        _close(tcache[k], jcache[k])


def _batch(vocab, seed=0):
    tok = np.random.default_rng(seed).integers(0, vocab, (B, S)).astype(np.int32)
    return {"tokens": tok, "labels": np.roll(tok, -1, axis=1)}


@pytest.mark.parametrize("wkv_impl", ["chunked", "kernel"])
def test_forward_and_loss_match_jax(models, wkv_impl):
    jcfg, tcfg, jparams, tparams = models
    batch = _batch(jcfg.vocab_size, 10)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    jlogits, jaux = jax_forward(jcfg, jparams, jb, compute_dtype=jnp.float32)
    jl, (jce, _) = jax_loss_fn(jcfg, jparams, jb, compute_dtype=jnp.float32, z_loss=1e-4, remat="full")
    with torch.no_grad():
        tlogits, taux = forward(tcfg, tparams, tb, compute_dtype=torch.float32, wkv_impl=wkv_impl)
        tl, (tce, _) = loss_fn(tcfg, tparams, tb, compute_dtype=torch.float32, z_loss=1e-4, remat="full", wkv_impl=wkv_impl)
    _close(tlogits, jlogits)
    assert float(taux) == float(jaux) == 0.0
    assert float(tl) == pytest.approx(float(jl), rel=1e-6)
    assert float(tce) == pytest.approx(float(jce), rel=1e-6)


def test_train_step_matches_jax():
    """One fp32 step from one state, one step in (AdamW moments and lr > 0)."""
    jcfg, tcfg = jax_reduce(jax_get_config(ARCH)), reduce_for_smoke(get_config(ARCH))
    tr = dict(global_batch=B, seq_len=S, learning_rate=LR, warmup_steps=1, total_steps=10)
    prec = dict(compute_dtype="float32")
    jrun = JaxRunConfig(arch=ARCH, train=JaxTrainConfig(**tr), parallel=JaxParallelConfig(remat="full"),
                        precision=JaxPrecisionConfig(**prec))
    trun = RunConfig(arch=ARCH, train=TrainConfig(**tr), parallel=ParallelConfig(remat="full"),
                     precision=PrecisionConfig(**prec))
    batches = [_batch(jcfg.vocab_size, s) for s in (11, 12)]
    jstate = jax_init_train_state(jcfg, jrun, jax.random.PRNGKey(0))
    jstep = jax.jit(jax_make_train_step(jcfg, jrun))
    jstate, _ = jstep(jstate, {k: jnp.asarray(v) for k, v in batches[0].items()})
    tstate = train_state_from_jax(tcfg, jax.tree.map(np.asarray, jstate), device="cpu")
    before = [t.clone() for t in tree_leaves(tstate.params)]
    jstate, jm = jstep(jstate, {k: jnp.asarray(v) for k, v in batches[1].items()})
    tstate, tm = make_train_step(tcfg, trun)(tstate, {k: torch.from_numpy(v) for k, v in batches[1].items()})
    assert float(tm["lr"]) == pytest.approx(float(jm["lr"]), rel=1e-6) and float(tm["lr"]) > 0
    assert float(tm["loss"]) == pytest.approx(float(jm["loss"]), rel=1e-6)
    assert float(tm["grad_norm"]) == pytest.approx(float(jm["grad_norm"]), rel=1e-5)
    ref = tree_leaves(params_from_jax(tcfg, jax.tree.map(np.asarray, jstate.params), device="cpu"))
    got = tree_leaves(tstate.params)
    diff = max(float((a - b).abs().max()) for a, b in zip(got, ref))
    moved = float(torch.cat([(a - b).abs().flatten() for a, b in zip(got, before)]).mean())
    assert moved > LR / 2 and diff < 1e-6


def test_kernel_refuses_gradients_and_states(models):
    jcfg, tcfg, jparams, tparams = models
    tb = {k: torch.from_numpy(v) for k, v in _batch(jcfg.vocab_size, 13).items()}
    leaves = tree_leaves(tparams)
    for t in leaves:
        t.requires_grad_(True)
    try:
        with pytest.raises(RuntimeError, match="forward only"):
            loss_fn(tcfg, tparams, tb, compute_dtype=torch.float32, wkv_impl="kernel")
        loss, _ = loss_fn(tcfg, tparams, tb, compute_dtype=torch.float32)  # the chunked scan differentiates
        g = torch.autograd.grad(loss, leaves, allow_unused=True)
        assert g[tree_paths(tparams).index(("blocks", 0, "time_mix", "bonus"))] is not None
    finally:
        for t in leaves:
            t.requires_grad_(False)
    x = torch.zeros((B, S, jcfg.d_model))
    state = torch.zeros((B, jcfg.num_heads, 16, 16))
    with pytest.raises(ValueError, match="zero state"):
        rwkv.time_mix(tcfg, tparams["blocks"][0]["time_mix"], x, state=state, wkv_impl="kernel")
    with pytest.raises(ValueError, match="wkv_impl"):
        forward(tcfg, tparams, tb, wkv_impl="pallas")


def test_a_scan_passed_as_wkv_impl_takes_k5s_place(models):
    """A callable ``wkv_impl`` is called once per layer with K5's arguments;
    handed K5 itself, the forward is the ``"kernel"`` forward bit for bit."""
    jcfg, tcfg, jparams, tparams = models
    tb = {k: torch.from_numpy(v) for k, v in _batch(jcfg.vocab_size, 15).items()}
    calls = []

    def scan(r, k, v, logw, u, *, chunk):
        calls.append((tuple(r.shape), tuple(u.shape), chunk))
        return wkv6(r, k, v, logw, u, chunk=chunk)

    with torch.no_grad():
        got = forward(tcfg, tparams, tb, compute_dtype=torch.float32, wkv_impl=scan)[0]
        ref = forward(tcfg, tparams, tb, compute_dtype=torch.float32, wkv_impl="kernel")[0]
    assert torch.equal(got, ref)
    H, n = tcfg.num_heads, tcfg.rwkv.head_size
    assert calls == [((B, S, H, n), (H, n), tcfg.rwkv.chunk_size)] * tcfg.num_layers
    x = torch.zeros((B, S, jcfg.d_model))
    with pytest.raises(ValueError, match="zero state"):
        rwkv.time_mix(tcfg, tparams["blocks"][0]["time_mix"], x, state=torch.zeros((B, H, n, n)), wkv_impl=scan)


def test_fp8_is_refused_for_the_ssm_family(models):
    """As the JAX package: an FP8 context raises, and an fp8 run config
    trains without one (the ssm family has no quantizable projections)."""
    jcfg, tcfg, jparams, tparams = models
    dense = reduce_for_smoke(get_config("olmo-1b"))
    ctx = make_fp8_ctx(dense, PrecisionConfig(fp8=True), init_train_state(dense, RunConfig(arch="olmo-1b", precision=PrecisionConfig(fp8=True)), device="cpu").fp8)
    tb = {k: torch.from_numpy(v) for k, v in _batch(jcfg.vocab_size, 14).items()}
    with pytest.raises(ValueError, match="fp8"):
        forward(tcfg, tparams, tb, fp8=ctx)
    run = RunConfig(arch=ARCH, precision=PrecisionConfig(fp8=True))
    jrun = JaxRunConfig(arch=ARCH, precision=JaxPrecisionConfig(fp8=True))
    assert init_train_state(tcfg, run, device="cpu").fp8 is None
    assert jax_init_train_state(jcfg, jrun, jax.random.PRNGKey(0)).fp8 is None
