"""The port's training path against the JAX package's, on the CPU.

Both packages start from one state: the JAX package initialises and takes
one step (so the AdamW moments, the step counter and the FP8 amax history
are mid-training), ``repro_torch.bridge.train_state_from_jax`` copies that
state into the port, and both take three more steps on the same numpy
batches.  Tolerances, by what differs between the two:

* fp32 compute: the same functions with sums in another order.  Losses
  agree to 1e-6 relative, parameters to 1e-6 absolute.  AdamW normalises
  each update, so a parameter moves by about the learning rate (1e-3) per
  step whatever its gradient: a wrong weight-decay rule (1e-4 per step on
  the norm scales of mistral-nemo-12b) or a wrong learning rate shows far
  above that.
* bf16 compute (and FP8, which quantizes bf16 activations): the two
  frameworks round the bf16 stream at different places, so a gradient that
  is close to zero may change sign and move its parameter by 2 lr the other
  way.  Losses agree to 1e-3 relative (2e-3 with FP8), gradient norms to
  5e-2, every parameter to 2 lr per step, and the mean parameter difference
  stays under lr / 10.  With FP8 an e4m3 code next to a rounding boundary
  may take its neighbour when its bf16 input differs in the last bit, which
  moves more gradients: lr / 5.
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
from repro.models import forward as jax_forward
from repro.models import init_params as jax_init_params
from repro.train.step import init_train_state as jax_init_train_state
from repro.train.step import loss_fn as jax_loss_fn
from repro.train.step import make_train_step as jax_make_train_step
from repro_torch.bridge import params_from_jax, train_state_from_jax
from repro_torch.config import ParallelConfig, PrecisionConfig, RunConfig, TrainConfig, reduce_for_smoke
from repro_torch.configs import get_config
from repro_torch.data import make_batch_fn, synthetic_batch
from repro_torch.models import forward
from repro_torch.train import init_train_state, loss_fn, make_train_step
from repro_torch.utils.tree import tree_leaves, tree_paths

torch.set_num_threads(2)

B, S, LR = 4, 32, 1e-3


def _configs(arch):
    return jax_reduce(jax_get_config(arch)), reduce_for_smoke(get_config(arch))


def _batches(vocab, n, seed=0, batch=B, seq=S):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        tok = rng.integers(0, vocab, (batch, seq)).astype(np.int32)
        out.append({"tokens": tok, "labels": np.roll(tok, -1, axis=1)})
    return out


def _jax(b):
    return {k: jnp.asarray(v) for k, v in b.items()}


def _torch(b):
    return {k: torch.from_numpy(v) for k, v in b.items()}


@pytest.mark.parametrize(
    "jax_impl,impl,arch",
    [("xla", "torch", "olmo-1b"), ("flash", "flash", "olmo-1b"), ("xla", "torch", "bert-large")],
    ids=["xla-torch", "flash-flash", "bert-large"],
)
def test_forward_logits_match_jax(jax_impl, impl, arch):
    jcfg, tcfg = _configs(arch)
    jparams = jax_init_params(jcfg, jax.random.PRNGKey(1), jnp.float32)
    tparams = params_from_jax(tcfg, jax.tree.map(np.asarray, jparams), device="cpu")
    batch = _batches(jcfg.vocab_size, 1, seed=2, batch=2)[0]
    ref, _ = jax_forward(jcfg, jparams, _jax(batch), attn_impl=jax_impl, compute_dtype=jnp.float32)
    with torch.no_grad():  # flash is forward only
        got, aux = forward(tcfg, tparams, _torch(batch), attn_impl=impl, compute_dtype=torch.float32)
    assert got.shape == ref.shape and float(aux) == 0.0
    assert float(np.abs(got.numpy() - np.asarray(ref)).max()) < 1e-4  # fp32: sums in another order


def test_loss_fn_matches_jax():
    jcfg, tcfg = _configs("mistral-nemo-12b")
    jparams = jax_init_params(jcfg, jax.random.PRNGKey(2), jnp.float32)
    tparams = params_from_jax(tcfg, jax.tree.map(np.asarray, jparams), device="cpu")
    batch = _batches(jcfg.vocab_size, 1, seed=3)[0]
    kw = dict(remat="full", z_loss=1e-4)
    jl, (jce, _) = jax_loss_fn(jcfg, jparams, _jax(batch), compute_dtype=jnp.float32, **kw)
    tl, (tce, _) = loss_fn(tcfg, tparams, _torch(batch), compute_dtype=torch.float32, **kw)
    assert float(tl) == pytest.approx(float(jl), rel=1e-6)
    assert float(tce) == pytest.approx(float(jce), rel=1e-6)
    tl0, _ = loss_fn(tcfg, tparams, _torch(batch), compute_dtype=torch.float32, remat="full")
    assert float(tl) > float(tl0)  # the z-loss term


TRAIN_CASES = [
    # arch, precision overrides, microbatches, tight (fp32) tolerances
    ("olmo-1b", {"compute_dtype": "float32"}, 1, True),
    ("olmo-1b", {}, 1, False),  # bf16 compute
    ("olmo-1b", {"fp8": True, "fp8_gemm": "pallas"}, 1, False),
    ("olmo-1b", {}, 2, False),
    ("mistral-nemo-12b", {"compute_dtype": "float32"}, 1, True),  # norm scales: the decay rank rule
    ("bert-large", {"compute_dtype": "float32"}, 1, True),  # encoder: biases, learned positions, no mask
]


@pytest.mark.parametrize("arch,prec,nmb,tight", TRAIN_CASES)
def test_train_steps_match_jax(arch, prec, nmb, tight):
    jcfg, tcfg = _configs(arch)
    tr = dict(global_batch=B, seq_len=S, learning_rate=LR, warmup_steps=2, total_steps=10)
    jrun = JaxRunConfig(
        arch=arch, train=JaxTrainConfig(**tr), parallel=JaxParallelConfig(remat="full", num_microbatches=nmb),
        precision=JaxPrecisionConfig(**prec),
    )
    tprec = dict(prec, fp8_gemm="kernel") if prec.get("fp8") else prec  # JAX "pallas" is the port's "kernel"
    trun = RunConfig(
        arch=arch, train=TrainConfig(**tr), parallel=ParallelConfig(remat="full", num_microbatches=nmb),
        precision=PrecisionConfig(**tprec),
    )
    batches = _batches(jcfg.vocab_size, 4)
    jstate = jax_init_train_state(jcfg, jrun, jax.random.PRNGKey(0))
    jstep = jax.jit(jax_make_train_step(jcfg, jrun))
    jstate, _ = jstep(jstate, _jax(batches[0]))  # mid-training: moments, step 1, amax history
    tstate = train_state_from_jax(tcfg, jax.tree.map(np.asarray, jstate), device="cpu")
    tstep = make_train_step(tcfg, trun)
    before = [t.clone() for t in tree_leaves(tstate.params)]
    for batch in batches[1:]:
        jstate, jm = jstep(jstate, _jax(batch))
        tstate, tm = tstep(tstate, _torch(batch))
        assert float(tm["lr"]) == pytest.approx(float(jm["lr"]), rel=1e-6)
        assert float(tm["loss"]) == pytest.approx(float(jm["loss"]), rel=1e-6 if tight else (2e-3 if prec.get("fp8") else 1e-3))
        assert float(tm["grad_norm"]) == pytest.approx(float(jm["grad_norm"]), rel=1e-5 if tight else 5e-2)
    assert int(tstate.opt.step) == int(jstate.opt.step) == 4
    ref = tree_leaves(params_from_jax(tcfg, jax.tree.map(np.asarray, jstate.params), device="cpu"))
    got = tree_leaves(tstate.params)
    diff = torch.cat([(a - b).abs().flatten() for a, b in zip(got, ref)])
    moved = torch.cat([(a - b).abs().flatten() for a, b in zip(got, before)])
    assert float(moved.mean()) > LR / 2  # the steps moved the parameters
    if tight:
        # a key bias shifts every score of a query row alike, which softmax
        # cancels: its gradient is rounding noise, which AdamW normalises
        # into moves of up to lr a step, so it is held to 2 lr a step
        paths = tree_paths(tstate.params)
        shift = torch.tensor([p[-1] == "bk" for p, a in zip(paths, got) for _ in range(a.numel())])
        assert float(diff[~shift].max()) < 1e-6
        assert not shift.any() or float(diff[shift].max()) <= 2 * LR * 3
    else:
        assert float(diff.max()) <= 2 * LR * 3 and float(diff.mean()) < (LR / 5 if prec.get("fp8") else LR / 10)
    if prec.get("fp8"):
        assert int(tstate.fp8.step) == int(jstate.fp8.step) == 4
        # an amax is one element of a bf16 activation three steps on: it
        # moves by a few bf16 ulps (2^-8 relative each) as the parameters do
        for k, h in tstate.fp8.amax_history.items():
            np.testing.assert_allclose(h.numpy(), np.asarray(jstate.fp8.amax_history[k]), rtol=0.1)
            np.testing.assert_allclose(tstate.fp8.scale[k].numpy(), np.asarray(jstate.fp8.scale[k]), rtol=0.1)


def test_a_gemm_passed_as_fp8_gemm_takes_k4s_place():
    """A callable ``fp8_gemm`` is called for every quantized GEMM of the step
    (forward, recompute, both backward products) with K4's arguments; handed
    K4 itself, the step is the ``"kernel"`` step bit for bit."""
    from repro_torch.fp8 import fp8_gemm, fp8_sites

    cfg = reduce_for_smoke(get_config("olmo-1b"))
    calls = []

    def gemm(a, b, sa, sb):
        calls.append((a.dtype, b.dtype))
        return fp8_gemm(a, b, sa, sb)

    def step(impl):
        run = RunConfig(arch="olmo-1b", train=TrainConfig(warmup_steps=0), parallel=ParallelConfig(remat="full"),
                        precision=PrecisionConfig(fp8=True, fp8_gemm=impl))
        state = init_train_state(cfg, run, 0, device="cpu")
        batch = synthetic_batch(cfg, step=0, global_batch=2, seq_len=16, device="cpu")
        return make_train_step(cfg, run)(state, batch)

    got, gm = step(gemm)
    ref, rm = step("kernel")
    assert float(gm["loss"]) == float(rm["loss"]) and float(gm["grad_norm"]) == float(rm["grad_norm"])
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(got.params), tree_leaves(ref.params)))
    assert len(calls) == 4 * cfg.num_layers * len(fp8_sites(cfg))
    with pytest.raises(ValueError, match="fp8_gemm"):
        step("pallas")


def test_first_step_applies_no_update():
    """With warmup the rate at step 0 is 0: the first step changes nothing
    but the moments and the counters."""
    cfg = reduce_for_smoke(get_config("olmo-1b"))
    run = RunConfig(arch="olmo-1b", train=TrainConfig(warmup_steps=2), precision=PrecisionConfig(fp8=True))
    state = init_train_state(cfg, run, 0, device="cpu")
    before = [t.clone() for t in tree_leaves(state.params)]
    batch = synthetic_batch(cfg, step=0, global_batch=2, seq_len=16, device="cpu")
    state, m = make_train_step(cfg, run)(state, batch)
    assert float(m["lr"]) == 0.0 and np.isfinite(float(m["loss"]))
    assert all(torch.equal(a, b) for a, b in zip(before, tree_leaves(state.params)))
    assert int(state.opt.step) == 1 and int(state.fp8.step) == 1
    assert all(bool((h[:, 0] > 0).all()) for h in state.fp8.amax_history.values())


def test_synthetic_batch_is_deterministic():
    cfg = reduce_for_smoke(get_config("olmo-1b"))
    fn = make_batch_fn(cfg, global_batch=8, seq_len=256, seed=3, device="cpu")
    a, b, c = fn(5), fn(5), fn(6)
    assert torch.equal(a["tokens"], b["tokens"]) and not torch.equal(a["tokens"], c["tokens"])
    assert not torch.equal(a["tokens"], synthetic_batch(cfg, step=5, global_batch=8, seq_len=256, seed=4, device="cpu")["tokens"])
    t = a["tokens"]
    assert t.dtype == torch.int32 and t.shape == (8, 256)
    assert int(t.min()) >= 0 and int(t.max()) < cfg.vocab_size
    assert torch.equal(a["labels"], torch.roll(t, -1, dims=1))
    counts = torch.bincount(t.flatten().long(), minlength=cfg.vocab_size)
    assert int(counts[0]) > int(counts[cfg.vocab_size // 2])  # Zipf: low ranks are common
    follows = (t[:, 1:] == (t[:, :-1] * 31 % cfg.vocab_size)).float().mean()
    assert 0.1 < float(follows) < 0.5  # the 0.3 mix of the shifted base token


def test_launcher_runs_on_cpu(capsys, tmp_path):
    from repro_torch.launch.train import main

    records = main(["--device", "cpu", "--steps", "2", "--batch", "2", "--seq", "16", "--fp8", "--microbatches", "2",
                    "--ckpt-dir", str(tmp_path)])
    assert [r["step"] for r in records] == [0, 1]
    assert all(np.isfinite(r["loss"]) and r["tokens_per_s"] > 0 for r in records)
    out = capsys.readouterr().out
    assert "fp8: ON" in out and "tok/s" in out
    assert "failures=0 restores=0" in out and "effective_pue" in out


def test_launcher_recovers_from_a_node_failure(capsys, tmp_path):
    """``--ckpt-every 2 --fail-at 3``: node 1 fails at step 3, the runner
    restores step 2's checkpoint and replays step 2 with the same loss."""
    from repro_torch.launch.train import main

    records = main(["--device", "cpu", "--steps", "5", "--batch", "2", "--seq", "16", "--ckpt-every", "2",
                    "--fail-at", "3", "--ckpt-dir", str(tmp_path)])
    assert [r["step"] for r in records] == [0, 1, 2, 2, 3, 4]
    assert records[2]["loss"] == records[3]["loss"]
    out = capsys.readouterr().out
    assert "failures=1 restores=1" in out and "6 steps in" in out and "[train] energy:" in out
    assert sorted(p.name for p in (tmp_path / "olmo-1b").iterdir()) == ["step_00000004", "step_00000005"]


def test_launcher_reruns_into_one_ckpt_dir(capsys, tmp_path):
    """A second run into the same ``--ckpt-dir`` removes the first run's
    checkpoints: its failure at step 3 restores its own step 2, not the
    first run's newest step."""
    from repro_torch.launch.train import main

    first = main(["--device", "cpu", "--steps", "8", "--batch", "2", "--seq", "16", "--ckpt-every", "2",
                  "--ckpt-dir", str(tmp_path)])
    assert sorted(p.name for p in (tmp_path / "olmo-1b").iterdir()) == ["step_00000006", "step_00000008"]
    capsys.readouterr()
    second = main(["--device", "cpu", "--steps", "5", "--batch", "2", "--seq", "16", "--ckpt-every", "2",
                   "--fail-at", "3", "--ckpt-dir", str(tmp_path)])
    assert [r["step"] for r in second] == [0, 1, 2, 2, 3, 4]
    assert [r["loss"] for r in second] == [first[i]["loss"] for i in (0, 1, 2, 2, 3, 4)]
    out = capsys.readouterr().out
    assert "removed 2 checkpoints of an earlier run" in out and "failures=1 restores=1" in out
    assert sorted(p.name for p in (tmp_path / "olmo-1b").iterdir()) == ["step_00000004", "step_00000005"]


class _Geometry:
    """A ``(1, 2)`` ``("data", "model")`` mesh's geometry: what building a
    sharded step reads (no ranks)."""

    mesh_dim_names = ("data", "model")
    shape = (1, 2)

    def size(self, dim: int) -> int:
        return self.shape[dim]


_GEOMETRY = _Geometry()


@pytest.mark.parametrize(
    "what",
    ["grad_compression", "mesh", "remat_dots"],
)
def test_options_outside_the_slice_raise(what):
    """Sharded training runs every family (``test_torch_sharded_train.py``,
    ``test_torch_sharded_{moe,hybrid,audio,ssm,vlm}.py``): each family's
    config passes the family check and meets the mesh's (an object that is
    no ``("data", "model")`` mesh), with sequence parallelism too, which
    builds a step on a ``("data", "model")`` mesh's geometry; a mesh
    without rules raises.  Gradient compression and the "dots" remat policy are
    ported: a compression method the JAX package does not have raises, as
    does such a remat policy, and the "dots" step equals the "full" one bit
    for bit (``test_torch_collectives.py`` holds the compressed steps)."""
    cfg = reduce_for_smoke(get_config("olmo-1b"))
    if what == "grad_compression":
        run = RunConfig(arch="olmo-1b", parallel=ParallelConfig(grad_compression="fp4"))
        with pytest.raises(ValueError, match="grad_compression"):
            make_train_step(cfg, run)
        with pytest.raises(ValueError, match="grad_compression"):
            init_train_state(cfg, run, device="cpu")
    elif what == "mesh":
        from repro_torch.parallel.sharding import training_rules

        run = RunConfig(arch="olmo-1b")
        rules = training_rules(run.parallel)
        for arch in ("olmo-1b", "qwen3-moe-235b-a22b", "hymba-1.5b", "hubert-xlarge", "rwkv6-7b",
                     "llama-3.2-vision-90b"):
            with pytest.raises(ValueError, match=r"\('data', 'model'\) mesh"):
                make_train_step(reduce_for_smoke(get_config(arch)), run, rules, mesh=object())
            seq = RunConfig(arch=arch, parallel=ParallelConfig(sequence_parallel=True))
            with pytest.raises(ValueError, match=r"\('data', 'model'\) mesh"):
                make_train_step(reduce_for_smoke(get_config(arch)), seq, rules, mesh=object())
            assert callable(make_train_step(reduce_for_smoke(get_config(arch)), seq, rules, mesh=_GEOMETRY))
        with pytest.raises(ValueError, match="rules and a mesh"):
            make_train_step(cfg, run, mesh=object())
    else:
        batch = synthetic_batch(cfg, step=0, global_batch=2, seq_len=8, device="cpu")
        out = {}
        for remat in ("full", "dots", "dots_everything"):
            run = RunConfig(arch="olmo-1b", train=TrainConfig(warmup_steps=0), parallel=ParallelConfig(remat=remat))
            state = init_train_state(cfg, run, device="cpu")
            if remat == "dots_everything":
                with pytest.raises(ValueError, match="remat"):
                    make_train_step(cfg, run)(state, batch)
            else:
                out[remat] = make_train_step(cfg, run)(state, batch)
        (full, fm), (dots, dm) = out["full"], out["dots"]
        assert float(fm["loss"]) == float(dm["loss"]) and float(fm["grad_norm"]) == float(dm["grad_norm"])
        assert all(torch.equal(a, b) for a, b in zip(tree_leaves(full.params), tree_leaves(dots.params)))
