"""The ``"dots"`` and ``"dots_no_batch"`` remat policies of the port's
training forward, on the CPU at smoke size.

* For every family (dense, moe, hybrid, audio, ssm, vlm), with and without
  fp8 where the family takes it: the loss, every gradient and the fp8
  amaxes under each policy equal the port's own under ``"none"`` bit for
  bit.  A policy changes what the backward keeps, never a value.
* The policies keep what they say: in the backward of one olmo layer,
  ``"full"`` recomputes the forward's ``mm`` products and ``"dots"`` none
  of them; ``"dots_no_batch"`` recomputes the attention's ``bmm`` products
  and ``"dots"`` none.
* The loss and gradients under each policy against JAX's ``value_and_grad``
  under the same policy on bridged weights: fp32 compute to 1e-6 relative
  (gradients to 1e-5 of each leaf's largest), and with fp8 (bf16 compute,
  the port's ``"kernel"``, JAX's ``"ref"`` GEMM: both exact products with
  fp32 sums) the loss to 2e-3 and each layer's observed amaxes to 0.1, as
  ``test_torch_train.py`` holds them: an amax is one element of a bf16
  activation downstream of e4m3 casts, and a cast whose bf16 input differs
  in its last bit between the frameworks may take the neighbouring code,
  2^-3 apart.
  A key bias's gradient is rounding noise (softmax cancels a shift of a
  query row's scores), so it is held to 1e-6 of the model's largest
  gradient instead of its own.
* A train state dropped after a remat step is freed at once: the first
  ``torch.utils.checkpoint`` call of a process imports ``torch._dynamo``,
  whose frames would otherwise keep the calling stack, the state included,
  in a reference cycle until the cyclic collector runs (``make_train_step``
  imports it first); a caller that measured the state with
  ``utils.tree.tree_size_bytes`` or ``flatten_with_paths`` held it in one
  too (a nested walk that called itself).  In a fresh process with the
  collector off.
"""

import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch_parity import batches, bridged, configs, to_jax, to_torch

from repro.config import PrecisionConfig as JaxPrecisionConfig
from repro.fp8 import make_fp8_ctx as jax_make_fp8_ctx
from repro.fp8 import make_fp8_state as jax_make_fp8_state
from repro.train.step import loss_fn as jax_loss_fn
from repro_torch.config import PrecisionConfig
from repro_torch.fp8 import make_fp8_ctx, make_fp8_state
from repro_torch.train import loss_fn
from repro_torch.utils.tree import tree_leaves, tree_paths

torch.set_num_threads(2)

POLICIES = ("dots", "dots_no_batch")
FAMILIES = {"dense": "olmo-1b", "moe": "qwen3-moe-235b-a22b", "hybrid": "hymba-1.5b", "audio": "hubert-xlarge",
            "ssm": "rwkv6-7b", "vlm": "llama-3.2-vision-90b"}
CASES = [(fam, False) for fam in FAMILIES] + [(fam, True) for fam in ("dense", "moe", "hybrid", "audio")]


def _batch(cfg, seed=0):
    b = to_torch(batches(cfg, 1, seed=seed, batch=2)[0])
    if cfg.family == "vlm":
        g = torch.Generator().manual_seed(seed)
        b["vision_tokens"] = torch.randn((2, cfg.vision.num_image_tokens, cfg.d_model), generator=g)
    return b


def _loss_grads(cfg, params, batch, remat, fp8):
    """(loss, gradients, amaxes or None) of the port's ``loss_fn``: bf16
    compute with the fp8 GEMMs (K4's plain version here), else fp32."""
    prec = PrecisionConfig(fp8=True, fp8_gemm="kernel")
    ctx = make_fp8_ctx(cfg, prec, make_fp8_state(cfg, prec, "cpu")) if fp8 else None
    leaves = tree_leaves(params)
    for t in leaves:
        t.requires_grad_(True)
    try:
        loss, aux = loss_fn(cfg, params, batch, remat=remat, compute_dtype=torch.bfloat16 if fp8 else torch.float32,
                            fp8=ctx)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    finally:
        for t in leaves:
            t.requires_grad_(False)
    return loss.detach(), grads, (aux[2] if fp8 else None)


@pytest.mark.parametrize("family,fp8", CASES, ids=[f"{f}-fp8" if q else f for f, q in CASES])
def test_policies_equal_none_bit_for_bit(family, fp8):
    _, cfg = configs(FAMILIES[family])
    from repro_torch.models import init_params

    params = init_params(cfg, 0, "cpu")
    batch = _batch(cfg)
    ref_loss, ref_grads, ref_amax = _loss_grads(cfg, params, batch, "none", fp8)
    for remat in POLICIES:
        loss, grads, amax = _loss_grads(cfg, params, batch, remat, fp8)
        assert torch.equal(loss, ref_loss), remat
        for g, r in zip(grads, ref_grads):
            assert (g is None and r is None) or torch.equal(g, r), remat
        if fp8:
            assert all(torch.equal(amax[k], ref_amax[k]) for k in ref_amax), remat


class _Count(TorchDispatchMode):
    """Counts the calls of each aten op."""

    def __init__(self):
        super().__init__()
        self.calls: dict = {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.calls[func] = self.calls.get(func, 0) + 1
        return func(*args, **(kwargs or {}))


def test_policies_keep_the_products():
    from repro_torch.models import blocks, init_params

    _, cfg = configs("olmo-1b")
    p = init_params(cfg, 0, "cpu")["blocks"][0]
    x = torch.randn((2, 32, cfg.d_model))
    mm, bmm = torch.ops.aten.mm.default, torch.ops.aten.bmm.default
    counts = {}
    for remat in ("none", "full") + POLICIES:
        from repro_torch.models.model import SAVED_PRODUCTS
        from torch.utils.checkpoint import checkpoint, create_selective_checkpoint_contexts

        xr = x.clone().requires_grad_(True)
        block = lambda x: blocks.dense_block(cfg, p, x)  # noqa: E731
        if remat == "none":
            y = block(xr)
        elif remat == "full":
            y = checkpoint(block, xr, use_reentrant=False)
        else:
            y = checkpoint(block, xr, use_reentrant=False,
                           context_fn=lambda: create_selective_checkpoint_contexts(SAVED_PRODUCTS[remat]))
        with _Count() as c:
            y.sum().backward()
        counts[remat] = c.calls
    forward_mm = counts["full"].get(mm, 0) - counts["none"].get(mm, 0)
    forward_bmm = counts["full"].get(bmm, 0) - counts["none"].get(bmm, 0)
    assert forward_mm > 0 and forward_bmm > 0  # "full" recomputes the forward's products
    assert counts["dots"].get(mm, 0) == counts["none"].get(mm, 0)  # "dots" recomputes none
    assert counts["dots"].get(bmm, 0) == counts["none"].get(bmm, 0)
    assert counts["dots_no_batch"].get(mm, 0) == counts["none"].get(mm, 0)
    assert counts["dots_no_batch"].get(bmm, 0) == counts["full"].get(bmm, 0)  # the batched ones recomputed


def _jax_loss_grads(jcfg, jparams, batch, remat, fp8):
    prec = JaxPrecisionConfig(fp8=True, fp8_gemm="ref")
    compute = jnp.bfloat16 if fp8 else jnp.float32

    def f(p):
        ctx = jax_make_fp8_ctx(jcfg, prec, jax_make_fp8_state(jcfg, prec)) if fp8 else None
        loss, aux = jax_loss_fn(jcfg, p, batch, remat=remat, compute_dtype=compute, fp8=ctx)
        return loss, (aux[2] if fp8 else None)

    (loss, amax), grads = jax.jit(jax.value_and_grad(f, has_aux=True))(jparams)
    return loss, grads, amax


JAX_CASES = [(fam, remat, False) for fam in ("dense", "moe", "hybrid", "audio") for remat in POLICIES] + [
    ("hybrid", "dots", True), ("moe", "dots_no_batch", True)]


@pytest.mark.parametrize("family,remat,fp8", JAX_CASES,
                         ids=[f"{f}-{r}" + ("-fp8" if q else "") for f, r, q in JAX_CASES])
def test_policies_match_jax(family, remat, fp8):
    jcfg, tcfg = configs(FAMILIES[family])
    jparams, tparams = bridged(jcfg, tcfg)
    np_batch = batches(jcfg, 1, seed=1, batch=2)[0]
    jloss, jgrads, jamax = _jax_loss_grads(jcfg, jparams, to_jax(np_batch), remat, fp8)
    loss, grads, amax = _loss_grads(tcfg, tparams, to_torch(np_batch), remat, fp8)
    if fp8:
        assert float(loss) == pytest.approx(float(jloss), rel=2e-3)
        for k, v in amax.items():
            np.testing.assert_allclose(v.numpy(), np.asarray(jamax[k]), rtol=0.1)
        return
    assert float(loss) == pytest.approx(float(jloss), rel=1e-6)
    from repro_torch.bridge import params_from_jax

    ref = tree_leaves(params_from_jax(tcfg, jax.tree.map(np.asarray, jgrads), device="cpu"))
    largest = max(float(r.abs().max()) for r in ref)
    for path, g, r in zip(tree_paths(tparams), grads, ref):
        scale = 0.1 * largest if path[-1] == "bk" else float(r.abs().max())
        assert float((g - r).abs().max()) <= 1e-5 * scale, path


# one train step in a fresh process with the cyclic collector off: whether a
# parameter of the state is still alive after ``del``
DROPPED_STATE = """
import gc, sys, weakref
gc.disable()
from repro_torch.config import ParallelConfig, RunConfig, TrainConfig, reduce_for_smoke
from repro_torch.configs import get_config
from repro_torch.data import synthetic_batch
from repro_torch.train import init_train_state, make_train_step
from repro_torch.utils.tree import flatten_with_paths, tree_size_bytes

arch, remat = sys.argv[1:3]
cfg = reduce_for_smoke(get_config(arch))
run = RunConfig(arch=arch, train=TrainConfig(warmup_steps=0), parallel=ParallelConfig(remat=remat))
state = init_train_state(cfg, run, device="cpu")
step = make_train_step(cfg, run)
state, metrics = step(state, synthetic_batch(cfg, step=0, global_batch=2, seq_len=32, device="cpu"))
assert tree_size_bytes(state.params) > 0 and len(flatten_with_paths(state)) > 0
leaf = weakref.ref(state.params["embed"]["tok"])
del state, metrics
print("alive" if leaf() is not None else "freed", "torch._dynamo" in sys.modules)
"""


@pytest.mark.parametrize("arch,remat", [("olmo-1b", "full"), ("rwkv6-7b", "none")])
def test_dropped_state_is_freed_without_the_collector(arch, remat):
    """rwkv6-7b's chunked WKV scan checkpoints each chunk whatever the remat
    policy, so its first step hits the import too."""
    root = Path(__file__).resolve().parents[1]
    env = dict(os.environ, PYTHONPATH=str(root / "src"))
    out = subprocess.run([sys.executable, "-c", DROPPED_STATE, arch, remat], env=env, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.split() == ["freed", "True"], out.stdout
