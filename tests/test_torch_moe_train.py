"""The port's moe training forward (qwen3-moe, arctic) against the JAX
package's, on the CPU at smoke size.

* ``forward``'s logits and aux loss on bridged weights, fp32 compute, at
  the published capacity factor 1.25, where capacity binds: logits to
  1e-4, aux (the layers' load-balance losses over ``num_layers``) to 1e-6
  relative.  arctic adds its dense residual FFN.
* Three train steps from one bridged mid-training state
  (``torch_parity.compare_train_steps``), ``aux_loss`` held with the loss:
  fp32 (tight), bf16, and fp8 (JAX ``"pallas"``, the port's ``"kernel"``,
  the quantized attention projections and arctic's dense FFN).  The bf16
  and fp8 cases route at the published capacity factor 1.25, where
  capacity binds.  The tight case does not bind (cf = E / k: every expert
  takes a whole group): a near tie in a token's top-k may flip under
  fp32 sum-order noise as the parameters move, and with capacity binding
  one flip shifts the slot of every later token of the two experts it
  moves between, and so their drops, which moves many tokens' outputs
  far past the tight limits (it does at cf 1.25 here).  Unbound, a flip
  moves one token's output.  The bf16 limits absorb such moves.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import batches, bridged, compare_train_steps, configs, to_jax, to_torch

from repro.models import forward as jax_forward
from repro_torch.models import forward

torch.set_num_threads(2)


def _configs(arch, cf=1.25):
    """Smoke configs at capacity factor ``cf``; None: capacity never binds."""
    jcfg, tcfg = configs(arch)
    if cf is None:
        cf = jcfg.moe.num_experts / jcfg.moe.top_k
    return tuple(c.replace(moe=dataclasses.replace(c.moe, capacity_factor=cf)) for c in (jcfg, tcfg))


@pytest.mark.parametrize("arch", ["qwen3-moe-235b-a22b", "arctic-480b"])
def test_forward_logits_and_aux_match_jax(arch):
    jcfg, tcfg = _configs(arch)
    jparams, tparams = bridged(jcfg, tcfg)
    batch = batches(jcfg, 1, seed=2)[0]
    ref, raux = jax_forward(jcfg, jparams, to_jax(batch), compute_dtype=jnp.float32)
    with torch.no_grad():
        got, aux = forward(tcfg, tparams, to_torch(batch), compute_dtype=torch.float32)
    assert got.shape == ref.shape
    assert float(np.abs(got.numpy() - np.asarray(ref)).max()) < 1e-4  # fp32: sums in another order
    assert float(aux) > 0 and float(aux) == pytest.approx(float(raux), rel=1e-6)


def test_aux_is_the_layer_mean_of_the_load_balance_losses():
    """``forward``'s aux equals the mean over layers of ``moe_ffn``'s aux
    on each layer's input, and enters ``loss_fn``'s loss."""
    from repro_torch.models import blocks
    from repro_torch.models.layers import apply_norm
    from repro_torch.models.moe import moe_ffn
    from repro_torch.train import loss_fn

    jcfg, tcfg = _configs("qwen3-moe-235b-a22b")
    _, params = bridged(jcfg, tcfg)
    batch = to_torch(batches(tcfg, 1, seed=3)[0])
    with torch.no_grad():
        _, aux = forward(tcfg, params, batch, compute_dtype=torch.float32)
        x = params["embed"]["tok"][batch["tokens"].long()]
        layer_aux = []
        for p in params["blocks"]:
            h = apply_norm(tcfg, p["norm1"], x)
            a = blocks.self_attention(tcfg, p["attn"], h)
            layer_aux.append(moe_ffn(tcfg, p["moe"], apply_norm(tcfg, p["norm2"], x + a))[1])
            x = blocks.moe_block(tcfg, p, x)[0]
        loss, (ce, aux2) = loss_fn(tcfg, params, batch, compute_dtype=torch.float32)
    assert float(aux) == pytest.approx(float(sum(layer_aux)) / tcfg.num_layers, rel=1e-6)
    assert float(aux2) == float(aux) and float(loss) == pytest.approx(float(ce) + float(aux), rel=1e-7)


MOE_TRAIN_CASES = [
    # arch, precision overrides, tight (fp32) tolerances
    ("qwen3-moe-235b-a22b", {"compute_dtype": "float32"}, True),
    ("qwen3-moe-235b-a22b", {}, False),  # bf16 compute
    ("qwen3-moe-235b-a22b", {"fp8": True, "fp8_gemm": "pallas"}, False),
    ("arctic-480b", {"fp8": True, "fp8_gemm": "pallas"}, False),  # the dense residual FFN quantized
]


@pytest.mark.parametrize("arch,prec,tight", MOE_TRAIN_CASES)
def test_train_steps_match_jax(arch, prec, tight):
    jcfg, tcfg = _configs(arch, cf=None if tight else 1.25)
    tstate, _ = compare_train_steps(arch, jcfg, tcfg, prec, tight)
    if prec.get("fp8"):
        sites = {k.split("/")[0] for k in tstate.fp8.scale}
        assert ("ffn_up" in sites) == tcfg.moe.dense_residual  # qwen3's routed experts stay unquantized


def test_expert_gradients_flow_through_dispatch_and_combine():
    """Every expert stack, the router and the attention get gradients; the
    router's comes through the gates and the aux loss."""
    from repro_torch.train import loss_fn
    from repro_torch.utils.tree import tree_leaves, tree_paths

    jcfg, tcfg = _configs("qwen3-moe-235b-a22b")
    _, params = bridged(jcfg, tcfg)
    batch = to_torch(batches(tcfg, 1, seed=4)[0])
    leaves = tree_leaves(params)
    for t in leaves:
        t.requires_grad_(True)
    loss, _ = loss_fn(tcfg, params, batch, compute_dtype=torch.float32)
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    for path, g in zip(tree_paths(params), grads):
        assert g is not None and bool(torch.isfinite(g).all()), path
        if path[-1] in ("router", "w_up", "w_gate", "w_down", "wq"):
            assert float(g.abs().max()) > 0, path
