"""The port's RWKV6 WKV scan (K5) against the JAX package's, on the CPU.

The plain version (``wkv6_chunked_plain``, which the wrappers take for CPU
tensors) and the sequential oracle ``wkv6_ref`` against the Pallas
``wkv6`` in interpret mode and the JAX oracle, at the shapes of
``tests/test_kernels.py``, with that test's tolerance: 1e-4 (fp32, the
chunked and the sequential forms sum in another order), plus the
fast-decay case, which must stay finite.  K5 has no gradient in the JAX
package; the wrappers refuse to differentiate.

The card's K5 computes every chunk at once, factors the pairwise decay per
16-step sub-chunk and takes its products on TF32 terms of the fp32
operands ("3xTF32"): ``wkv6_chunked_split`` emulates that arithmetic, and
with two terms it must stay within the card's limit (``chip_smoke.py``'s
``WKV_RTOL``, 1e-4 of the largest output) of the Pallas kernel and the
oracle at every head size and chunk, while one term misses it.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import wkv6 as jax_wkv6
from repro.kernels.rwkv6_scan import wkv6_chunked as jax_wkv6_chunked
from repro.kernels.rwkv6_scan_ref import wkv6_ref as jax_wkv6_ref
from repro_torch.kernels.rwkv6_scan import wkv6, wkv6_chunked, wkv6_cuda_cores
from repro_torch.kernels.rwkv6_scan_ref import wkv6_chunked_plain, wkv6_chunked_split, wkv6_ref

torch.set_num_threads(2)

SHAPES = [(2, 128, 3, 16), (1, 64, 2, 32), (1, 256, 1, 64)]  # the shapes of tests/test_kernels.py


def _inputs(B, S, H, n, seed=0, logw=None):
    rng = np.random.default_rng(seed)
    r, k, v = (0.5 * rng.standard_normal((B, S, H, n)).astype(np.float32) for _ in range(3))
    if logw is None:
        logw = -np.exp(rng.standard_normal((B, S, H, n)).astype(np.float32) - 1.0)
    else:
        logw = np.full((B, S, H, n), logw, np.float32)
    u = 0.3 * rng.standard_normal((H, n)).astype(np.float32)
    return r, k, v, logw.astype(np.float32), u


def _to_bh(x):
    B, S, H, n = x.shape
    return x.transpose(0, 2, 1, 3).reshape(B * H, S, n)


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("chunk", [16, 32])
def test_wkv6_plain_matches_jax(shape, chunk):
    B, S, H, n = shape
    r, k, v, logw, u = _inputs(*shape)
    jout = np.asarray(jax_wkv6(*(jnp.asarray(x) for x in (r, k, v, logw, u)), chunk=chunk))
    ub = np.broadcast_to(u[None], (B, H, n)).reshape(B * H, n).copy()
    joracle = np.asarray(jax_wkv6_ref(*(jnp.asarray(_to_bh(x)) for x in (r, k, v, logw)), jnp.asarray(ub)))
    got = wkv6(*(torch.from_numpy(x) for x in (r, k, v, logw, u)), chunk=chunk)  # the plain version on the CPU
    assert got.dtype == torch.float32 and got.shape == (B, S, H, n)
    got = got.numpy()
    assert float(np.abs(got - jout).max()) < 1e-4
    assert float(np.abs(_to_bh(got) - joracle).max()) < 1e-4
    oracle = wkv6_ref(*(torch.from_numpy(_to_bh(x)) for x in (r, k, v, logw)), torch.from_numpy(ub))
    assert float(np.abs(oracle.numpy() - joracle).max()) < 1e-5  # the same sequential sums


@pytest.mark.parametrize("chunk", [16, 64])
def test_wkv6_chunked_kernel_layout_matches_jax(chunk):
    B, S, H, n = 2, 128, 2, 16
    r, k, v, logw, u = _inputs(B, S, H, n, seed=1)
    ub = np.broadcast_to(u[None], (B, H, n)).reshape(B * H, n).copy()
    bh = [_to_bh(x) for x in (r, k, v, logw)]
    jout = np.asarray(jax_wkv6_chunked(*(jnp.asarray(x) for x in bh), jnp.asarray(ub), chunk=chunk))
    got = wkv6_chunked(*(torch.from_numpy(x) for x in bh), torch.from_numpy(ub), chunk=chunk)
    assert torch.equal(got, wkv6_chunked_plain(*(torch.from_numpy(x) for x in bh), torch.from_numpy(ub), chunk=chunk))
    assert float(np.abs(got.numpy() - jout).max()) < 1e-4


def test_wkv6_fast_decay_stays_finite():
    """logw = -8: exp(la_prev) underflows to 0 within a chunk; no inf or nan."""
    B, S, H, n = 1, 64, 2, 16
    r, k, v, logw, u = _inputs(B, S, H, n, seed=2, logw=-8.0)
    got = wkv6(*(torch.from_numpy(x) for x in (r, k, v, logw, u)), chunk=16)
    jout = np.asarray(jax_wkv6(*(jnp.asarray(x) for x in (r, k, v, logw, u)), chunk=16))
    assert bool(torch.isfinite(got).all())
    assert float(np.abs(got.numpy() - jout).max()) < 1e-4


def test_wkv6_refuses_gradients_and_ragged_chunks():
    r, k, v, logw, u = (torch.from_numpy(x) for x in _inputs(1, 32, 2, 16))
    r.requires_grad_(True)
    with pytest.raises(RuntimeError, match="forward only"):
        wkv6(r, k, v, logw, u, chunk=16)
    with pytest.raises(RuntimeError, match="forward only"):
        wkv6_chunked(_to_bh_t(r), _to_bh_t(k), _to_bh_t(v), _to_bh_t(logw), u, chunk=16)  # B = 1: (BH, n) = (H, n)
    with torch.no_grad():
        assert bool(torch.isfinite(wkv6(r, k, v, logw, u, chunk=16)).all())
        with pytest.raises(AssertionError):
            wkv6(r, k, v, logw, u, chunk=32 * 3)  # S is not a multiple of the chunk, as JAX asserts


def _to_bh_t(x):
    B, S, H, n = x.shape
    return x.transpose(1, 2).reshape(B * H, S, n)


def test_wkv6_wrappers_refuse_other_devices():
    """Off the CPU a wrapper launches its kernel or raises."""
    x = torch.empty((1, 32, 2, 16), device="meta")
    xb = torch.empty((2, 32, 16), device="meta")
    u = torch.empty((2, 16), device="meta")
    with torch.no_grad():
        with pytest.raises(ValueError, match="cuda or cpu"):
            wkv6(x, x, x, x, u, chunk=16)
        with pytest.raises(ValueError, match="cuda or cpu"):
            wkv6_chunked(xb, xb, xb, xb, u, chunk=16)


def test_wkv6_cuda_cores_yardstick_is_card_only():
    """v1 is the yardstick of the chunk-parallel K5: no plain version behind
    it, so CPU tensors are refused."""
    r, k, v, logw, u = (torch.from_numpy(x) for x in _inputs(1, 32, 2, 16))
    with torch.no_grad(), pytest.raises(ValueError, match="runs on cuda"):
        wkv6_cuda_cores(r, k, v, logw, u, chunk=16)


WKV_RTOL = 1e-4  # chip_smoke.py's limit, relative to the largest |output|


def _split_errors(n, chunk, logw=None, seed=3):
    """(two-term, one-term) errors of the emulated card arithmetic against
    the Pallas kernel and the oracle, relative to the largest |output|."""
    B, S, H = 2, 4 * max(chunk, 32), 2
    r, k, v, lw, u = _inputs(B, S, H, n, seed=seed + n + chunk, logw=logw)
    ub = np.broadcast_to(u[None], (B, H, n)).reshape(B * H, n).copy()
    bh = [_to_bh(x) for x in (r, k, v, lw)]
    pallas = np.asarray(jax_wkv6_chunked(*(jnp.asarray(x) for x in bh), jnp.asarray(ub), chunk=chunk))
    oracle = np.asarray(jax_wkv6_ref(*(jnp.asarray(x) for x in bh), jnp.asarray(ub)))
    scale = float(np.abs(pallas).max())
    errs = {}
    for terms in (2, 1):
        got = wkv6_chunked_split(*(torch.from_numpy(x) for x in bh), torch.from_numpy(ub), chunk=chunk, terms=terms)
        assert bool(torch.isfinite(got).all())
        got = got.numpy()
        errs[terms] = max(float(np.abs(got - pallas).max()), float(np.abs(got - oracle).max())) / scale
    return errs


@pytest.mark.parametrize("n", [16, 32, 64])
@pytest.mark.parametrize("chunk", [16, 32, 64])
def test_split_route_meets_the_card_limits(n, chunk):
    """Sub-chunk factoring and two TF32 terms per operand stay within the
    card's limit; operands rounded to one TF32 term miss it."""
    errs = _split_errors(n, chunk)
    assert errs[2] < WKV_RTOL, errs
    assert errs[1] > WKV_RTOL, errs


def test_split_route_fast_decay_stays_finite():
    """logw = -8: the factors about each sub-chunk's first step underflow
    to 0, never overflow; the outputs stay finite and within the limit."""
    errs = _split_errors(64, 64, logw=-8.0)
    assert errs[2] < WKV_RTOL, errs
