"""The port's hybrid training forward (hymba) against the JAX package's, on
the CPU at smoke size.

* ``ssm_mix`` under autograd: the gradients of a random projection of its
  output, with respect to the input and every SSM parameter, against
  ``jax.grad`` of the JAX ``ssm_mix`` on the same values, fp32, each
  within 1e-5 of the reference gradient's largest magnitude; at a length
  that is a multiple of ``chunk_size`` (the chunked scan, the state carried
  from chunk to chunk) and at one that is not (the one-chunk fallback).
* ``forward``'s logits on bridged weights, fp32 compute, to 1e-4, in both
  attention implementations (the port's ``"flash"`` is K3's plain version
  here), with hymba's sliding window shorter than the sequence.
* Three train steps from one bridged mid-training state
  (``torch_parity.compare_train_steps``): fp32 (tight), bf16 and fp8 (the
  attention projections and the MLP quantized; the SSM heads not).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import batches, bridged, compare_train_steps, configs, to_jax, to_torch

from repro.models import forward as jax_forward
from repro.models import ssm as jax_ssm
from repro_torch.models import forward
from repro_torch.models import ssm

torch.set_num_threads(2)

ARCH = "hymba-1.5b"


@pytest.mark.parametrize("seq", [32, 24], ids=["chunked", "one-chunk"])
def test_ssm_mix_gradients_match_jax(seq):
    jcfg, tcfg = configs(ARCH)
    assert (seq % tcfg.ssm.chunk_size == 0) == (seq == 32)
    jparams, tparams = bridged(jcfg, tcfg)
    jp = jax.tree.map(lambda a: a[0], jparams["blocks"]["ssm"])  # layer 0
    tp = tparams["blocks"][0]["ssm"]
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, seq, jcfg.d_model)).astype(np.float32)
    cot = rng.standard_normal((2, seq, jcfg.d_model)).astype(np.float32)

    def jloss(p, x):
        return jnp.sum(jax_ssm.ssm_mix(jcfg, p, x)[0] * cot)

    jl, (jgp, jgx) = jax.jit(jax.value_and_grad(jloss, argnums=(0, 1)))(jp, jnp.asarray(x))
    tx = torch.from_numpy(x).requires_grad_(True)
    names = sorted(tp)
    leaves = [tp[n].requires_grad_(True) for n in names]
    loss = torch.sum(ssm.ssm_mix(tcfg, tp, tx)[0] * torch.from_numpy(cot))
    grads = torch.autograd.grad(loss, [tx] + leaves)
    assert float(loss.detach()) == pytest.approx(float(jl), rel=1e-5)
    for name, g, ref in zip(["x"] + names, grads, [jgx] + [jgp[n] for n in names]):
        ref = np.asarray(ref)
        assert float(np.abs(ref).max()) > 0, name
        assert float(np.abs(g.numpy() - ref).max()) <= 1e-5 * float(np.abs(ref).max()), name


@pytest.mark.parametrize("jax_impl,impl", [("xla", "torch"), ("flash", "flash")], ids=["xla-torch", "flash-flash"])
def test_forward_logits_match_jax(jax_impl, impl):
    jcfg, tcfg = configs(ARCH)
    assert tcfg.sliding_window and tcfg.sliding_window < 48
    jparams, tparams = bridged(jcfg, tcfg)
    batch = batches(jcfg, 1, seed=2, batch=2, seq=48)[0]
    ref, raux = jax_forward(jcfg, jparams, to_jax(batch), attn_impl=jax_impl, compute_dtype=jnp.float32)
    with torch.no_grad():
        got, aux = forward(tcfg, tparams, to_torch(batch), attn_impl=impl, compute_dtype=torch.float32)
    assert got.shape == ref.shape and float(aux) == float(raux) == 0.0
    assert float(np.abs(got.numpy() - np.asarray(ref)).max()) < 1e-4  # fp32: sums in another order


@pytest.mark.parametrize(
    "prec,tight",
    [({"compute_dtype": "float32"}, True), ({}, False), ({"fp8": True, "fp8_gemm": "pallas"}, False)],
    ids=["fp32", "bf16", "fp8"],
)
def test_train_steps_match_jax(prec, tight):
    jcfg, tcfg = configs(ARCH)
    tstate, _ = compare_train_steps(ARCH, jcfg, tcfg, prec, tight)
    if prec.get("fp8"):  # attention and MLP sites only: the SSM projections stay unquantized
        assert {k.split("/")[0] for k in tstate.fp8.scale} == {
            "attn_q", "attn_k", "attn_v", "attn_o", "ffn_up", "ffn_gate", "ffn_down"}
