"""The port's FP8 path against the JAX package's, on the CPU.

* ``quantize`` is bit-identical (both multiply in fp32, clip, and narrow
  with round-to-nearest-even), compared as uint8 views.
* ``compute_scale`` and ``update_fp8_state`` are exact: the same fp32
  division and maximum on the same values.
* ``fp8_gemm_plain`` against the Pallas ``fp8_gemm`` (interpret mode): fp8
  products are exact in fp32, only the order of the fp32 sums differs, so
  the outputs agree to 1e-5 relative.  The JAX oracle divides by
  ``sa*sb`` where both kernels multiply by the reciprocal: one ulp more.
* ``fp8_dot`` and its gradients against ``jax.grad`` of the reference's
  ``fp8_dot`` with the Pallas GEMM: the same quantized operands and the
  same e5m2 gradient quantization, so again only the sum order differs
  (1e-5 relative in fp32; 1e-2 where dx is rounded to bf16).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config.model import reduce_for_smoke as jax_reduce
from repro.configs import get_config as jax_get_config
from repro.fp8 import fp8_dot as jax_fp8_dot
from repro.fp8 import fp8_gemm as jax_fp8_gemm
from repro.fp8 import scale_keys as jax_scale_keys
from repro.fp8.quantize import E4M3 as J_E4M3
from repro.fp8.quantize import E5M2 as J_E5M2
from repro.fp8.quantize import Fp8State as JaxFp8State
from repro.fp8.quantize import compute_scale as jax_compute_scale
from repro.fp8.quantize import quantize as jax_quantize
from repro.fp8.quantize import update_fp8_state as jax_update_fp8_state
from repro_torch.config import PrecisionConfig, reduce_for_smoke
from repro_torch.configs import get_config
from repro_torch.fp8 import (
    E4M3,
    E5M2,
    Fp8State,
    compute_scale,
    fp8_dot,
    fp8_gemm,
    fp8_gemm_plain,
    make_fp8_ctx,
    make_fp8_state,
    quantize,
    scale_keys,
    update_fp8_state,
)
from repro_torch.fp8 import gemm
from repro_torch.models import forward, init_params

torch.set_num_threads(2)

PAIRS = {"e4m3": (J_E4M3, E4M3), "e5m2": (J_E5M2, E5M2)}


def _wide(rng, shape):
    """Values over many binades, both signs, some beyond every fp8 max."""
    return (rng.standard_normal(shape) * np.exp(rng.uniform(-10, 12, shape))).astype(np.float32)


def _to_torch_fp8(q) -> torch.Tensor:
    t = torch.from_numpy(np.array(q).view(np.uint8))  # a writable copy
    return t.view(E4M3 if q.dtype == J_E4M3 else E5M2)


@pytest.mark.parametrize("fmt", ["e4m3", "e5m2"])
@pytest.mark.parametrize("in_dtype", ["float32", "bfloat16"])
def test_quantize_bit_identical(fmt, in_dtype):
    jdt, tdt = PAIRS[fmt]
    rng = np.random.default_rng(0)
    x = _wide(rng, (4096,))
    x[:4] = [1e30, -1e30, 0.0, -0.0]  # saturation both ways, signed zeros
    for s in (np.float32(1.0), np.float32(3.7), np.float32(448.0 / 2.5), np.float32(1e-3)):
        jx = jnp.asarray(x, getattr(jnp, in_dtype))
        tx = torch.from_numpy(x).to(getattr(torch, in_dtype))
        a = np.asarray(jax_quantize(jx, jnp.asarray(s), jdt)).view(np.uint8)
        b = quantize(tx, torch.tensor(s), tdt).view(torch.uint8).numpy()
        assert (a != b).sum() == 0, f"scale {s}: {(a != b).sum()} codes differ"


def test_compute_scale_and_update_match_jax():
    rng = np.random.default_rng(1)
    amax = np.abs(_wide(rng, (64,)))
    amax[:2] = 0.0  # the never-observed guard
    for fmt in ("e4m3", "e5m2"):
        jdt, tdt = PAIRS[fmt]
        for margin in (0.0, 1.0):
            a = np.asarray(jax_compute_scale(jnp.asarray(amax), jdt, margin))
            b = compute_scale(torch.from_numpy(amax), tdt, margin).numpy()
            np.testing.assert_array_equal(a, b)

    keys, L, window = ["attn_q/x", "attn_q/w"], 3, 4
    hist = {k: np.abs(_wide(rng, (L, window))) for k in keys}
    scale = {k: np.abs(_wide(rng, (L,))) for k in keys}
    jstate = JaxFp8State({k: jnp.asarray(v) for k, v in hist.items()}, {k: jnp.asarray(v) for k, v in scale.items()}, jnp.int32(5))
    tstate = Fp8State({k: torch.from_numpy(v) for k, v in hist.items()}, {k: torch.from_numpy(v) for k, v in scale.items()}, torch.tensor(5, dtype=torch.int32))
    for _ in range(3):  # older observations age out of the window
        obs = {k: np.abs(_wide(rng, (L,))) for k in keys}
        jstate = jax_update_fp8_state(jstate, {k: jnp.asarray(v) for k, v in obs.items()}, dtype=J_E4M3, margin=1.0)
        tstate = update_fp8_state(tstate, {k: torch.from_numpy(v) for k, v in obs.items()}, dtype=E4M3, margin=1.0)
    for k in keys:
        np.testing.assert_array_equal(np.asarray(jstate.amax_history[k]), tstate.amax_history[k].numpy())
        np.testing.assert_array_equal(np.asarray(jstate.scale[k]), tstate.scale[k].numpy())
    assert int(jstate.step) == int(tstate.step) == 8


def _operands(rng, M, K, N, fa, fb):
    a, b = rng.standard_normal((M, K)).astype(np.float32), rng.standard_normal((K, N)).astype(np.float32)
    out = []
    for x, fmt in ((a, fa), (b, fb)):
        jdt, _ = PAIRS[fmt]
        s = np.float32(float(jax_compute_scale(jnp.max(jnp.abs(jnp.asarray(x))), jdt)))
        out.append((jax_quantize(jnp.asarray(x), jnp.asarray(s), jdt), s))
    return out


@pytest.mark.parametrize("M,K,N", [(100, 70, 36), (150, 130, 40)])
@pytest.mark.parametrize("fa,fb", [("e4m3", "e4m3"), ("e5m2", "e4m3"), ("e4m3", "e5m2"), ("e5m2", "e5m2")])
def test_fp8_gemm_plain_matches_pallas(M, K, N, fa, fb):
    rng = np.random.default_rng(M + K + N)
    (qa, sa), (qb, sb) = _operands(rng, M, K, N, fa, fb)
    ref = np.asarray(jax_fp8_gemm(qa, qb, jnp.asarray(sa), jnp.asarray(sb)))  # Pallas, interpret mode
    ta, tb = _to_torch_fp8(qa), _to_torch_fp8(qb)
    tsa, tsb = torch.tensor(sa), torch.tensor(sb)
    got = fp8_gemm_plain(ta, tb, tsa, tsb)
    assert got.dtype == torch.float32 and got.shape == (M, N)
    tol = 1e-5 * float(np.abs(ref).max())
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-5, atol=tol)
    # the wrapper takes the plain version for CPU tensors; transposed views
    # (the backward's operands) give the same product
    np.testing.assert_array_equal(fp8_gemm(ta, tb, tsa, tsb).numpy(), got.numpy())
    got_t = fp8_gemm(ta.T.contiguous().T, tb.T.contiguous().T, tsa, tsb)
    np.testing.assert_allclose(got_t.numpy(), ref, rtol=1e-5, atol=tol)


def _dot_gemm_operands(M, K, N):
    """The (a, b) operands of fp8_dot's three GEMMs, as its forward and
    backward hand them to the GEMM: forward, dgrad, wgrad."""
    rng = np.random.default_rng(M + K + N)
    seen = []

    def record(a, b, sa, sb):
        seen.append((a, b))
        return fp8_gemm_plain(a, b, sa, sb)

    x = torch.from_numpy(rng.standard_normal((M, K)).astype(np.float32)).requires_grad_(True)
    w = torch.from_numpy(rng.standard_normal((K, N)).astype(np.float32)).requires_grad_(True)
    out = fp8_dot(x, w, torch.tensor(100.0), torch.tensor(300.0), E4M3, record)
    out.sum().backward()
    return seen


def test_layout_plan_of_fp8_dot_gemms():
    """At olmo-1b's smoke widths (32 tokens, d_model 64, d_ff 128): the
    forward copies b (qw is N-major), dgrad copies nothing (qg and qw.T are
    K-major), wgrad copies both (qx.T and qg are M- and N-major)."""
    cfg = reduce_for_smoke(get_config("olmo-1b"))
    for K, N in ((cfg.d_model, cfg.d_ff), (cfg.d_ff, cfg.d_model)):
        (fa, fb), (da, db), (wa, wb) = _dot_gemm_operands(32, K, N)
        plans = [(gemm.layout_plan(a, 1)[0], gemm.layout_plan(b, 0)[0]) for a, b in ((fa, fb), (da, db), (wa, wb))]
        assert plans == [(False, True), (False, False), (True, True)]
        # what is read as it is keeps its own leading stride
        assert gemm.layout_plan(fa, 1) == (False, K) and gemm.layout_plan(db, 0) == (False, N)


@pytest.mark.parametrize("K,lead", [(70, 80), (1000, 1008), (64, 64), (1, 16)])
def test_layout_plan_pads_k_to_16_bytes(K, lead):
    a = torch.zeros((24, K), dtype=E4M3)  # row-major: K-major, rows K bytes apart
    b = torch.zeros((K, 40), dtype=E5M2)  # row-major: N-major
    assert gemm.layout_plan(a, 1) == (K % 16 != 0, lead)
    assert gemm.layout_plan(b, 0) == (True, lead)
    assert gemm.layout_plan(b.T.contiguous().T, 0) == (K % 16 != 0, lead)
    # a view that starts off a 16-byte boundary is copied
    assert gemm.layout_plan(torch.zeros((24, K + 1), dtype=E4M3)[:, 1:], 1)[0]


@pytest.mark.parametrize("M,K,N", [(32, 64, 128), (40, 70, 36), (17, 1000, 5)])
def test_kmajor_copies_give_the_same_product(M, K, N):
    """fp8_gemm_plain on the K-major copies (past K unset) is bit-equal to it
    on the views, for every operand of fp8_dot's three GEMMs."""
    for a, b in _dot_gemm_operands(M, K, N):
        sa, sb = torch.tensor(3.0), torch.tensor(0.5)
        Ka = a.shape[1]
        ca = gemm.kmajor_copy(a, 1, gemm.layout_plan(a, 1)[1])[:, :Ka]
        cb = gemm.kmajor_copy(b, 0, gemm.layout_plan(b, 0)[1])[:, :Ka].T
        assert ca.stride(1) == 1 and cb.stride(0) == 1
        assert ca.stride(0) % 16 == 0 and cb.stride(1) % 16 == 0
        assert torch.equal(fp8_gemm_plain(ca, cb, sa, sb), fp8_gemm_plain(a, b, sa, sb))


def test_cpu_operands_take_the_plain_version_without_copies():
    a = torch.randn((40, 70)).to(E4M3)
    b = torch.randn((36, 70)).to(E5M2).T  # a view: K-major, rows 70 bytes apart
    sa, sb = torch.tensor(2.0), torch.tensor(4.0)
    gemm.reset_launches()
    out = fp8_gemm(a, b, sa, sb)
    assert gemm.LAUNCHES == {"fp8_gemm": 0, "fp8_layout_copy": 0}
    assert torch.equal(out, fp8_gemm_plain(a, b, sa, sb))
    with pytest.raises(ValueError, match="cuda or cpu"):  # any other device: no plain version
        fp8_gemm(a.to("meta"), b.to("meta"), sa.to("meta"), sb.to("meta"))


@pytest.mark.parametrize("x_dtype", ["float32", "bfloat16"])
def test_fp8_dot_and_gradients_match_jax(x_dtype):
    rng = np.random.default_rng(7)
    M, K, N = 40, 48, 36
    x = rng.standard_normal((M, K)).astype(np.float32)
    w = (rng.standard_normal((K, N)) * 0.2).astype(np.float32)
    gup = rng.standard_normal((M, N)).astype(np.float32)  # the cotangent
    sx, sw = np.float32(448.0 / 3.1), np.float32(448.0 / 0.7)

    jx = jnp.asarray(x, getattr(jnp, x_dtype))

    def jloss(x_, w_):
        out = jax_fp8_dot(x_, w_, jnp.asarray(sx), jnp.asarray(sw), J_E4M3, jax_fp8_gemm)
        return jnp.sum(out * gup), out

    (_, jout), (jdx, jdw) = jax.value_and_grad(jloss, (0, 1), has_aux=True)(jx, jnp.asarray(w))

    tx = torch.from_numpy(x).to(getattr(torch, x_dtype)).requires_grad_(True)
    tw = torch.from_numpy(w).requires_grad_(True)
    out = fp8_dot(tx, tw, torch.tensor(sx), torch.tensor(sw), E4M3, fp8_gemm)
    (out * torch.from_numpy(gup)).sum().backward()
    assert tx.grad.dtype == tx.dtype and tw.grad.dtype == torch.float32

    def close(a, b, rtol):
        a, b = np.asarray(a, np.float32), b.detach().float().numpy()
        np.testing.assert_allclose(b, a, rtol=rtol, atol=rtol * float(np.abs(a).max()))

    close(jout, out, 1e-5)
    close(jdx, tx.grad, 1e-5 if x_dtype == "float32" else 1e-2)
    close(jdw, tw.grad, 1e-5)


@pytest.mark.parametrize("arch", ["olmo-1b", "mistral-nemo-12b", "gemma-7b"])
def test_scale_keys_match_jax(arch):
    assert scale_keys(get_config(arch)) == jax_scale_keys(jax_get_config(arch))
    assert scale_keys(reduce_for_smoke(get_config(arch))) == jax_scale_keys(jax_reduce(jax_get_config(arch)))


def test_fp8_context_observes_each_layer_once_under_remat():
    """With ``remat="full"`` the backward recomputes every block and calls
    the context again; the amaxes must equal those of a forward without
    remat, and each layer's must be its own."""
    cfg = reduce_for_smoke(get_config("olmo-1b"))
    prec = PrecisionConfig(fp8=True)
    params = init_params(cfg, 0, device="cpu")
    # distinct layers: scale the second layer's weights up
    for w in params["blocks"][1]["attn"].values():
        w.mul_(3.0)
    state = make_fp8_state(cfg, prec, device="cpu")
    tokens = torch.from_numpy(np.random.default_rng(0).integers(0, cfg.vocab_size, (2, 16)).astype(np.int32))
    seen = {}
    for remat in ("none", "full"):
        for t in params["blocks"][0]["attn"].values():
            t.requires_grad_(True)
        ctx = make_fp8_ctx(cfg, prec, state)
        logits, _, amaxes = forward(cfg, params, {"tokens": tokens}, remat=remat, compute_dtype=torch.bfloat16, fp8=ctx)
        logits.float().square().mean().backward()  # recomputes the blocks under "full"
        seen[remat] = {k: v.clone() for k, v in amaxes.items()}
        for t in params["blocks"][0]["attn"].values():
            t.requires_grad_(False)
            t.grad = None
    for k in scale_keys(cfg):
        assert seen["full"][k].shape == (cfg.num_layers,)
        torch.testing.assert_close(seen["full"][k], seen["none"][k], rtol=0, atol=0)
        assert bool((seen["full"][k] > 0).all()), k
    for layer, p in enumerate(params["blocks"]):  # each layer's own weight amax
        assert float(seen["full"]["attn_q/w"][layer]) == float(p["attn"]["wq"].abs().max())
