"""Shared helpers of the training-forward parity tests (``test_torch_moe_train.py``,
``test_torch_hybrid_train.py``, ``test_torch_audio.py``, ``test_torch_remat.py``).

``compare_train_steps`` is ``test_torch_train.py``'s
``test_train_steps_match_jax`` pattern for any family: the JAX package
initialises and takes one step (so the AdamW moments, the step counter and
the FP8 amax history are mid-training), ``train_state_from_jax`` copies that
state into the port, and both take three more steps on the same numpy
batches.  Tolerances, by what differs between the two (as there):

* fp32 compute: the same functions with sums in another order.  Losses
  and aux losses agree to 1e-6 relative, gradient norms to 1e-5,
  parameters to 1e-6 absolute.
* bf16 compute (and FP8, which quantizes bf16 activations): the two
  frameworks round the bf16 stream at different places, so a gradient that
  is close to zero may change sign and move its parameter by 2 lr the other
  way.  Losses agree to 1e-3 relative (2e-3 with FP8), gradient norms to
  5e-2, every parameter to 2 lr per step, and the mean parameter difference
  stays under lr / 10 (lr / 5 with FP8).
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
from repro.models import init_params as jax_init_params
from repro.train.step import init_train_state as jax_init_train_state
from repro.train.step import make_train_step as jax_make_train_step
from repro_torch.bridge import params_from_jax, train_state_from_jax
from repro_torch.config import ParallelConfig, PrecisionConfig, RunConfig, TrainConfig, reduce_for_smoke
from repro_torch.configs import get_config
from repro_torch.train import make_train_step
from repro_torch.utils.tree import tree_leaves, tree_paths

B, S, LR = 4, 32, 1e-3


def configs(arch, **overrides):
    """The JAX and port smoke configs of ``arch``, each with ``overrides``."""
    return tuple(c.replace(**overrides) if overrides else c
                 for c in (jax_reduce(jax_get_config(arch)), reduce_for_smoke(get_config(arch))))


def bridged(jcfg, tcfg, seed=1):
    """JAX parameters from ``seed`` and the port's copy of them (CPU)."""
    jparams = jax_init_params(jcfg, jax.random.PRNGKey(seed), jnp.float32)
    return jparams, params_from_jax(tcfg, jax.tree.map(np.asarray, jparams), device="cpu")


def batches(cfg, n, seed=0, batch=B, seq=S):
    """``n`` numpy batches: tokens (or, for the audio family, standard
    normal frames) and random labels; for the vlm family also standard
    normal ``vision_tokens`` (B, ``cfg.vision.num_image_tokens``, D), drawn
    after the labels."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        if cfg.family == "audio":
            b = {"frames": rng.standard_normal((batch, seq, cfg.d_model)).astype(np.float32)}
        else:
            b = {"tokens": rng.integers(0, cfg.vocab_size, (batch, seq)).astype(np.int32)}
        b["labels"] = rng.integers(0, cfg.vocab_size, (batch, seq)).astype(np.int32)
        if cfg.family == "vlm":
            shape = (batch, cfg.vision.num_image_tokens, cfg.d_model)
            b["vision_tokens"] = rng.standard_normal(shape).astype(np.float32)
        out.append(b)
    return out


def to_jax(b):
    return {k: jnp.asarray(v) for k, v in b.items()}


def to_torch(b):
    return {k: torch.from_numpy(v) for k, v in b.items()}


def compare_train_steps(arch, jcfg, tcfg, prec, tight, *, nmb=1, remat="full", seed=0, grad_compression="none"):
    """Three train steps of both packages from one bridged mid-training
    state, held to the module docstring's tolerances.  ``prec`` is the
    JAX ``PrecisionConfig``'s overrides; its ``fp8_gemm="pallas"`` is the
    port's ``"kernel"``.  ``grad_compression`` compresses both packages'
    gradients, the residual bridged with the state."""
    tr = dict(global_batch=B, seq_len=S, learning_rate=LR, warmup_steps=2, total_steps=10)
    jrun = JaxRunConfig(arch=arch, train=JaxTrainConfig(**tr),
                        parallel=JaxParallelConfig(remat=remat, num_microbatches=nmb,
                                                   grad_compression=grad_compression),
                        precision=JaxPrecisionConfig(**prec))
    tprec = dict(prec, fp8_gemm="kernel") if prec.get("fp8") else prec
    trun = RunConfig(arch=arch, train=TrainConfig(**tr),
                     parallel=ParallelConfig(remat=remat, num_microbatches=nmb, grad_compression=grad_compression),
                     precision=PrecisionConfig(**tprec))
    data = batches(jcfg, 4, seed=seed)
    jstate = jax_init_train_state(jcfg, jrun, jax.random.PRNGKey(seed))
    jstep = jax.jit(jax_make_train_step(jcfg, jrun))
    jstate, _ = jstep(jstate, to_jax(data[0]))  # mid-training: moments, step 1, amax history
    tstate = train_state_from_jax(tcfg, jax.tree.map(np.asarray, jstate), device="cpu")
    tstep = make_train_step(tcfg, trun)
    before = [t.clone() for t in tree_leaves(tstate.params)]
    fp8 = bool(prec.get("fp8"))
    loss_rel = 1e-6 if tight else (2e-3 if fp8 else 1e-3)
    for batch in data[1:]:
        jstate, jm = jstep(jstate, to_jax(batch))
        tstate, tm = tstep(tstate, to_torch(batch))
        assert float(tm["lr"]) == pytest.approx(float(jm["lr"]), rel=1e-6)
        assert float(tm["loss"]) == pytest.approx(float(jm["loss"]), rel=loss_rel)
        assert float(tm["aux_loss"]) == pytest.approx(float(jm["aux_loss"]), rel=loss_rel, abs=1e-12)
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
        assert float(diff.max()) <= 2 * LR * 3 and float(diff.mean()) < (LR / 5 if fp8 else LR / 10)
    if fp8:
        assert int(tstate.fp8.step) == int(jstate.fp8.step) == 4
        # an amax is one element of a bf16 activation three steps on: it
        # moves by a few bf16 ulps as the parameters do
        for k, h in tstate.fp8.amax_history.items():
            np.testing.assert_allclose(h.numpy(), np.asarray(jstate.fp8.amax_history[k]), rtol=0.1)
            np.testing.assert_allclose(tstate.fp8.scale[k].numpy(), np.asarray(jstate.fp8.scale[k]), rtol=0.1)
    return tstate, jstate
