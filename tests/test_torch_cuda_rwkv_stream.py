"""The CUDA kernels of the third slice, K6 (BabelStream) and K5 (the RWKV6
WKV scan), against their plain PyTorch versions on the card.  Needs no
JAX, so it runs where the card is:
``python -m pytest -m gpu tests/test_torch_cuda_rwkv_stream.py``.  It
skips on a host without CUDA.

K6: copy, mul, add and triad are bit-equal to the plain versions in fp32
and bf16; dot sums its fp32 products in another order, within 1e-5 of
sum |a b|.  K5: the chunk-parallel kernel takes its products on the
tensor cores with every fp32 operand split into two TF32 terms (good to
about 2^-21), and v1 (the yardstick, ``wkv6_cuda_cores``) computes in fp32
on the CUDA cores; both differ from the plain version in the order of the
sums and in the exponential's last bits: 1e-4 of the output's largest
magnitude, as the JAX package's tests hold the scan against its oracle.
"""

import pytest
import torch

from repro_torch.kernels import babelstream as K6
from repro_torch.kernels import babelstream_ref as ref6
from repro_torch.kernels import rwkv6_scan as K5
from repro_torch.kernels.rwkv6_scan_ref import wkv6_chunked_plain, wkv6_ref


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False  # the plain version in full fp32


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
# the last case is no whole number of the kernels' 512-chunk tiles, and
# dot's 16-element tiles are shorter than one pass of its threads
@pytest.mark.parametrize("n,block", [(2**20, 65536), (3 * 4096, 4096), (16 * 1003, 16)])
def test_cuda_babelstream_matches_plain(dtype, n, block):
    _card()
    g = torch.Generator().manual_seed(n)
    a, b, c = (torch.randn(n, generator=g).to(dtype).cuda() for _ in range(3))
    cases = [
        (K6.stream_copy(a, block=block), ref6.copy_ref(a)),
        (K6.stream_mul(c, block=block), ref6.mul_ref(c)),
        (K6.stream_add(a, b, block=block), ref6.add_ref(a, b)),
        (K6.stream_triad(b, c, block=block), ref6.triad_ref(b, c)),
        (K6.stream_mul(c, 1.7, block=block), ref6.mul_ref(c, 1.7)),
        (K6.stream_triad(b, c, 3.1, block=block), ref6.triad_ref(b, c, 3.1)),
    ]
    torch.cuda.synchronize()
    for out, plain in cases:
        assert out.dtype == dtype and torch.equal(out, plain)
    before = K6.LAUNCHES["stream_dot"]
    d = K6.stream_dot(a.abs(), b.abs(), block=block)
    partials = K6.dot_partials(a, b, block=block)
    torch.cuda.synchronize()
    assert K6.LAUNCHES["stream_dot"] == before + 2 and partials.shape == (n // block,)
    scale = float((a.float() * b.float()).abs().sum())
    assert abs(float(d) - float(ref6.dot_ref(a.abs(), b.abs()))) <= 1e-5 * scale
    assert float((partials - ref6.dot_partials_ref(a, b, block)).abs().max()) <= 1e-5 * scale


@pytest.mark.gpu
def test_cuda_babelstream_refuses_what_it_does_not_take():
    _card()
    x = torch.zeros(4096, device="cuda")
    with pytest.raises(TypeError):
        K6.stream_copy(x.half(), block=4096)
    with pytest.raises(ValueError, match="16-byte"):
        K6.stream_copy(torch.zeros(4100, device="cuda")[1:4097], block=4096)  # off the 16-byte boundary
    with pytest.raises(AssertionError):
        K6.stream_copy(x, block=1000)


WKV_CASES = [  # B, S, H, n, chunk: every head size and chunk the kernels are built for
    (2, 128, 3, 16, 16),
    (1, 64, 2, 32, 32),
    (1, 256, 1, 64, 64),
    (2, 192, 4, 64, 32),
    (1, 128, 2, 16, 64),
    (1, 96, 2, 16, 32),
    (2, 64, 2, 32, 16),
    (1, 192, 3, 32, 64),
    (1, 80, 2, 64, 16),
]


def _wkv_inputs(B, S, H, n, g, logw=None):
    r, k, v = (0.5 * torch.randn((B, S, H, n), generator=g) for _ in range(3))
    lw = -torch.exp(torch.randn((B, S, H, n), generator=g) - 1.0) if logw is None else torch.full((B, S, H, n), logw)
    u = 0.3 * torch.randn((H, n), generator=g)
    return [t.cuda() for t in (r, k, v, lw, u)]


@pytest.mark.gpu
@pytest.mark.parametrize("B,S,H,n,chunk", WKV_CASES)
def test_cuda_wkv6_matches_plain(B, S, H, n, chunk):
    _card()
    g = torch.Generator().manual_seed(S * 7 + n + chunk)
    r, k, v, lw, u = _wkv_inputs(B, S, H, n, g)
    to_bh = lambda x: x.transpose(1, 2).reshape(B * H, S, n)  # noqa: E731
    ub = u.expand(B, H, n).reshape(B * H, n)
    before = dict(K5.LAUNCHES)
    out = K5.wkv6(r, k, v, lw, u, chunk=chunk)  # the model layout, strided
    out_bh = K5.wkv6_chunked(*(to_bh(x) for x in (r, k, v, lw)), ub, chunk=chunk)
    v1 = K5.wkv6_cuda_cores(r, k, v, lw, u, chunk=chunk)
    plain = wkv6_chunked_plain(*(to_bh(x) for x in (r, k, v, lw)), ub, chunk=chunk)
    oracle = wkv6_ref(*(to_bh(x) for x in (r, k, v, lw)), ub)
    torch.cuda.synchronize()
    assert K5.LAUNCHES["rwkv6_scan"] == before["rwkv6_scan"] + 2
    assert K5.LAUNCHES["rwkv6_scan_cuda_cores"] == before["rwkv6_scan_cuda_cores"] + 1
    tol = 1e-4 * max(1.0, float(plain.abs().max()))
    assert out.dtype == torch.float32 and out.shape == (B, S, H, n)
    assert torch.equal(to_bh(out), out_bh)
    for got in (out_bh, to_bh(v1)):
        assert float((got - plain).abs().max()) < tol
        assert float((got - oracle).abs().max()) < tol


@pytest.mark.gpu
def test_cuda_wkv6_unaligned_operands():
    """Operands off the 16-byte boundary and with odd strides take the
    kernels' 4-byte copies: the same outputs as aligned copies of them."""
    _card()
    B, S, H, n, chunk = 1, 128, 2, 32, 64
    g = torch.Generator().manual_seed(5)
    r, k, v, lw, u = _wkv_inputs(B, S, H, n, g)
    wide = [torch.zeros((B, S, H, n + 3), device="cuda") for _ in range(4)]
    for w_, x in zip(wide, (r, k, v, lw)):
        w_[..., 1 : 1 + n] = x
    odd = [w_[..., 1 : 1 + n] for w_ in wide]  # 4 bytes past the boundary, row stride n + 3
    got = K5.wkv6(*odd, u, chunk=chunk)
    ref = K5.wkv6(r, k, v, lw, u, chunk=chunk)
    torch.cuda.synchronize()
    assert float((got - ref).abs().max()) < 1e-4 * max(1.0, float(ref.abs().max()))


@pytest.mark.gpu
def test_cuda_wkv6_fast_decay_and_refusals():
    _card()
    g = torch.Generator().manual_seed(1)
    r, k, v, lw, u = _wkv_inputs(1, 64, 2, 16, g, logw=-8.0)
    out = K5.wkv6(r, k, v, lw, u, chunk=16)
    plain = K5.wkv6(*(t.cpu() for t in (r, k, v, lw, u)), chunk=16)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(out).all())
    assert float((out.cpu() - plain).abs().max()) < 1e-4 * max(1.0, float(plain.abs().max()))
    r64, k64, v64, lw64, u64 = _wkv_inputs(1, 256, 2, 64, g, logw=-8.0)
    out64 = K5.wkv6(r64, k64, v64, lw64, u64, chunk=64)  # every sub-chunk factor underflows but the nearest
    plain64 = K5.wkv6(*(t.cpu() for t in (r64, k64, v64, lw64, u64)), chunk=64)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(out64).all())
    assert float((out64.cpu() - plain64).abs().max()) < 1e-4 * max(1.0, float(plain64.abs().max()))
    with pytest.raises(ValueError, match="built for"):
        K5.wkv6(*(torch.zeros((1, 48, 2, 24), device="cuda") for _ in range(4)), torch.zeros((2, 24), device="cuda"), chunk=16)
    with pytest.raises(TypeError):
        K5.wkv6(r.double(), k.double(), v.double(), lw.double(), u.double(), chunk=16)
    r.requires_grad_(True)
    with pytest.raises(RuntimeError, match="forward only"):
        K5.wkv6(r, k, v, lw, u, chunk=16)
