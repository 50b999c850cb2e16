"""The port's op-level cost model (``repro_torch.launch.cost``) against the
JAX package's jaxpr cost model (``repro.launch.jaxpr_cost``), on the CPU.

* The reference's own cases (``tests/test_cost_models.py``): exact matmul
  FLOPs and bytes, equal to the JAX model's; a 10-iteration loop at least
  10 times one iteration (the port has no scan: a Python loop's ops are
  each seen); the gradient under ``torch.utils.checkpoint`` more than 2.5
  times the forward, as under ``jax.checkpoint``.
* Full width on the meta device against the JAX model on abstract values:
  olmo-1b's and mistral-nemo-12b's forward at 4 x 2048 (bf16 compute) and
  olmo-1b's train step (remat full): FLOPs within 2%, HBM bytes within 10%
  (the JAX model also charges its layer scan's carry, about 1%).
* The peak live memory: views and in-place writes are not counted twice, a
  freed temporary gives its bytes back; an fp8 operand widened by the
  plain GEMM's cast keeps its one byte a product reads.
"""

import jax
import jax.numpy as jnp
import pytest
import torch

from repro.config import ParallelConfig as JaxParallelConfig
from repro.config import PrecisionConfig as JaxPrecisionConfig
from repro.config import RunConfig as JaxRunConfig
from repro.config import TrainConfig as JaxTrainConfig
from repro.configs import get_config as jax_get_config
from repro.launch.jaxpr_cost import estimate_cost as jax_estimate_cost
from repro.models import abstract_params as jax_abstract_params
from repro.models import forward as jax_forward
from repro.train.step import abstract_train_state, make_train_step as jax_make_train_step
from repro_torch.config import ParallelConfig, PrecisionConfig, RunConfig, ShapeConfig, TrainConfig
from repro_torch.configs import get_config
from repro_torch.fp8 import fp8_gemm_plain
from repro_torch.launch.cost import estimate_cost, storage_bytes
from repro_torch.launch.dryrun import build_train, meta_params
from repro_torch.launch.specs import meta
from repro_torch.models import forward

torch.set_num_threads(2)

F32 = torch.float32


def test_exact_matmul():
    est = estimate_cost(lambda x, y: x @ y, meta((128, 256), F32), meta((256, 64), F32))
    assert est["flops"] == 2 * 128 * 256 * 64
    assert est["hbm_bytes"] == (128 * 256 + 256 * 64 + 128 * 64) * 4  # both operands + output
    theirs = jax_estimate_cost(lambda x, y: x @ y, jax.ShapeDtypeStruct((128, 256), jnp.float32),
                               jax.ShapeDtypeStruct((256, 64), jnp.float32))
    assert (est["flops"], est["hbm_bytes"]) == (theirs["flops"], theirs["hbm_bytes"])


def test_loop_counts_every_iteration():
    def looped(w, x):
        for _ in range(10):
            x = x @ w
        return x

    est = estimate_cost(looped, meta((64, 64), F32), meta((64, 64), F32))
    assert est["flops"] >= 10 * 2 * 64**3
    one = estimate_cost(lambda w, x: x @ w, meta((64, 64), F32), meta((64, 64), F32))
    assert est["flops"] == 10 * one["flops"]


def test_checkpoint_counts_the_recompute():
    def fwd(w):
        return torch.sum(torch.tanh(w @ w) @ w)

    def grad(w):
        w = w.detach().requires_grad_(True)
        with torch.enable_grad():
            loss = torch.utils.checkpoint.checkpoint(fwd, w, use_reentrant=False)
            return torch.autograd.grad(loss, w)[0]

    base, g = estimate_cost(fwd, meta((64, 64), F32)), estimate_cost(grad, meta((64, 64), F32))
    assert g["flops"] > 2.5 * base["flops"]  # forward, recompute, backward
    w = jax.ShapeDtypeStruct((64, 64), jnp.float32)
    jax_fwd = lambda w: jnp.sum(jnp.tanh(w @ w) @ w)  # noqa: E731
    assert base["flops"] == jax_estimate_cost(jax_fwd, w)["flops"]
    assert g["flops"] > 2.5 * jax_estimate_cost(jax_fwd, w)["flops"]


def test_peak_follows_storages():
    x = meta((1024, 1024), F32)  # 4 MiB

    def fn(x):
        t = x * 2  # +4 MiB
        v = t.view(-1)[:10]  # a view: no new storage
        t.add_(1)  # in place: no new storage
        del t, v  # freed
        return x + 1  # +4 MiB again, after the temporary is gone

    est = estimate_cost(fn, x)
    assert est["peak_bytes"] == 2 * 4 * 2**20
    assert storage_bytes([x, x[:3], x.T]) == 4 * 2**20


def test_fp8_operands_keep_their_width():
    a, b = meta((256, 512), torch.float8_e4m3fn), meta((512, 128), torch.float8_e4m3fn)
    s = meta((), F32)
    est = estimate_cost(fp8_gemm_plain, a, b, s, s)
    product = 2 * 256 * 512 * 128
    assert product + 256 * 128 <= est["flops"] < product + 256 * 128 + 8  # the product, its scaling, the scale's
    assert est["hbm_bytes"] == 256 * 512 + 512 * 128 + 256 * 128 * 4  # one byte an fp8 operand element
    scaled = estimate_cost(lambda a, b: a.float() @ b.float(), a, b)
    assert scaled["hbm_bytes"] == est["hbm_bytes"]


B, S = 4, 2048


def _close(ours, theirs):
    assert ours["flops"] == pytest.approx(theirs["flops"], rel=0.02)
    assert ours["hbm_bytes"] == pytest.approx(theirs["hbm_bytes"], rel=0.10)


@pytest.mark.parametrize("arch", ["olmo-1b", "mistral-nemo-12b"])
def test_forward_matches_jaxpr_cost(arch):
    cfg, jcfg = get_config(arch), jax_get_config(arch)
    batch = {"tokens": meta((B, S), torch.int32), "labels": meta((B, S), torch.int32)}
    ours = estimate_cost(lambda p, b: forward(cfg, p, b, compute_dtype=torch.bfloat16)[0],
                         meta_params(cfg, F32), batch)
    jbatch = {k: jax.ShapeDtypeStruct((B, S), jnp.int32) for k in batch}
    theirs = jax_estimate_cost(lambda p, b: jax_forward(jcfg, p, b, compute_dtype=jnp.bfloat16)[0],
                               jax_abstract_params(jcfg, jnp.float32), jbatch)
    _close(ours, theirs)


def test_train_step_matches_jaxpr_cost():
    cfg, jcfg = get_config("olmo-1b"), jax_get_config("olmo-1b")
    run = RunConfig(arch="olmo-1b", train=TrainConfig(global_batch=B, seq_len=S), parallel=ParallelConfig(remat="full"),
                    precision=PrecisionConfig())
    step, args = build_train(cfg, run, ShapeConfig("t", S, B, "train"))
    ours = estimate_cost(step, *args)
    jrun = JaxRunConfig(arch="olmo-1b", train=JaxTrainConfig(global_batch=B, seq_len=S),
                        parallel=JaxParallelConfig(remat="full"), precision=JaxPrecisionConfig())
    jbatch = {k: jax.ShapeDtypeStruct((B, S), jnp.int32) for k in ("tokens", "labels")}
    theirs = jax_estimate_cost(jax_make_train_step(jcfg, jrun), abstract_train_state(jcfg, jrun), jbatch)
    _close(ours, theirs)
    # the step's state (fp32 parameters and two moments) is live throughout, gradients and activations on top
    assert ours["peak_bytes"] > 3 * 4 * cfg.param_count()
