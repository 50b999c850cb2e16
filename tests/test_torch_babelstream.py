"""The port's BabelStream (K6) against the JAX package's, on the CPU.

The plain versions (which the wrappers take for CPU tensors) against the
Pallas kernels in interpret mode, bit for bit for copy, mul, add and triad
in fp32 and bf16.  That pins two roundings: the scalar 0.4 is rounded to
the array's dtype before it multiplies (in bf16 PyTorch's own ``0.4 * c``
differs from JAX on about one element in ten, which the test also shows),
and an fp32 triad is one fused multiply-add, as XLA compiles the JAX
kernel.  dot sums 2^17 fp32 products in another order: within 1e-6 of
sum |a b|.  The entry point ``repro_torch.benchmarks.babelstream.run`` runs
on the CPU at a small size and reports no device rate there.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import babelstream as jax_bs
from repro_torch.benchmarks import babelstream as bench
from repro_torch.kernels import babelstream as K
from repro_torch.kernels import babelstream_ref as ref

torch.set_num_threads(2)

N = 2 * K.DEFAULT_BLOCK
DTYPES = ["float32", "bfloat16"]


def _arrays(dtype, seed=0, n=N):
    rng = np.random.default_rng(seed)
    xs = [rng.standard_normal(n).astype(np.float32) for _ in range(3)]
    return [jnp.asarray(x, getattr(jnp, dtype)) for x in xs], [torch.from_numpy(x).to(getattr(torch, dtype)) for x in xs]


def _same(jx, tx) -> int:
    """Elements where the two results differ (compared in fp32, exact for bf16)."""
    return int((np.asarray(jx.astype(jnp.float32)) != tx.float().numpy()).sum())


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("kernel", ["copy", "mul", "add", "triad"])
def test_stream_plain_bit_equal_to_pallas(kernel, dtype):
    (ja, jb, jc), (ta, tb, tc) = _arrays(dtype)
    jax_out, plain, wrapped = {
        "copy": (lambda: jax_bs.stream_copy(ja), lambda: ref.copy_ref(ta), lambda: K.stream_copy(ta)),
        "mul": (lambda: jax_bs.stream_mul(jc), lambda: ref.mul_ref(tc), lambda: K.stream_mul(tc)),
        "add": (lambda: jax_bs.stream_add(ja, jb), lambda: ref.add_ref(ta, tb), lambda: K.stream_add(ta, tb)),
        "triad": (lambda: jax_bs.stream_triad(jb, jc), lambda: ref.triad_ref(tb, tc), lambda: K.stream_triad(tb, tc)),
    }[kernel]
    j, p, w = jax_out(), plain(), wrapped()
    assert p.dtype == ta.dtype and p.shape == (N,)
    assert _same(j, p) == 0
    assert torch.equal(w, p)


@pytest.mark.parametrize("dtype", DTYPES)
def test_unrounded_scalar_differs_from_jax(dtype):
    """The trap the plain versions avoid: PyTorch's ``0.4 * c`` multiplies
    by the unrounded scalar in bf16; and two ops round an fp32 triad twice."""
    (_, jb, jc), (_, tb, tc) = _arrays(dtype)
    j = jax_bs.stream_triad(jb, jc)
    mism = _same(j, tb + 0.4 * tc)
    if dtype == "bfloat16":
        assert mism > N // 20 and _same(jax_bs.stream_mul(jc), 0.4 * tc) > N // 20
    else:
        assert mism > N // 20 and _same(jax_bs.stream_mul(jc), 0.4 * tc) == 0


@pytest.mark.parametrize("dtype", DTYPES)
def test_stream_dot_matches_pallas(dtype):
    (ja, jb, _), (ta, tb, _) = _arrays(dtype, seed=1)
    j = float(jax_bs.stream_dot(ja, jb))
    scale = float((ta.float() * tb.float()).abs().sum())
    for got in (K.stream_dot(ta, tb), ref.dot_ref(ta, tb), K.dot_partials(ta, tb).sum()):
        assert got.dtype == torch.float32 and got.shape == ()
        assert abs(float(got) - j) <= 1e-6 * scale
    assert K.dot_partials(ta, tb).shape == (N // K.DEFAULT_BLOCK,)


def test_stream_bytes_and_block_rule():
    assert K.stream_bytes("copy", 1000, 4) == 8000 == jax_bs.stream_bytes("copy", 1000, 4)
    assert K.stream_bytes("triad", 1000, 4) == 12000
    for k in K.NAMES:
        assert K.stream_bytes(k, 4096, 2) == jax_bs.stream_bytes(k, 4096, 2)
    x = torch.zeros(1000)
    with pytest.raises(AssertionError):
        K.stream_copy(x, block=512)  # n % block != 0, as JAX asserts
    with pytest.raises(AssertionError):
        K.stream_dot(x, x, block=512)
    assert torch.equal(K.stream_triad(x, x, block=500), x)


def test_stream_wrappers_refuse_other_devices():
    """Off the CPU a wrapper launches its kernel or raises."""
    x = torch.empty((1024,), device="meta")
    for call in (lambda: K.stream_copy(x, block=1024), lambda: K.stream_mul(x, block=1024),
                 lambda: K.stream_add(x, x, block=1024), lambda: K.stream_triad(x, x, block=1024),
                 lambda: K.stream_dot(x, x, block=1024)):
        with pytest.raises(ValueError, match="cuda or cpu"):
            call()


def test_benchmark_runs_on_cpu():
    rows = bench.run(n=K.DEFAULT_BLOCK, iters=1, device="cpu")
    assert [r["name"] for r in rows] == [f"babelstream_{k}" for k in K.NAMES]
    for r in rows:
        kind = r["name"].split("_")[1]
        assert r["bytes"] == K.stream_bytes(kind, K.DEFAULT_BLOCK, 4)
        assert r["us_per_call"] > 0 and r["device"] == "cpu"
        assert r["achieved_gbps"] is None and r["hbm_fraction"] is None  # not the card's
