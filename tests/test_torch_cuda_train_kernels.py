"""The CUDA kernels of the training path, K4 (FP8 GEMM) and K3 (flash
attention forward), against their plain PyTorch versions on the card.
Needs no JAX, so it runs where the card is:
``python -m pytest -m gpu tests/test_torch_cuda_train_kernels.py``.  It
skips on a host without CUDA.

K4: its products are exact and its sums fp32, so only the order of the
fp32 sums differs: 1e-5 of the output's largest magnitude.  K3 with fp32
inputs (the CUDA-core kernel): both compute in fp32 (1e-4, as K1/K2).  K3
with bf16 inputs (the tensor-core kernel, P split into two bf16 terms):
``chip_smoke.py``'s limits, at most one bf16 spacing of the row's largest
|output| and a mean error of 2e-5 of the mean |output|; the plain version
with P rounded to bf16 before P.V, a control, must fail them.
"""

import pytest
import torch

from repro_torch.fp8 import E4M3, E5M2, compute_scale, quantize, tensor_amax
from repro_torch.fp8 import gemm as K4
from repro_torch.fp8.gemm_ref import fp8_gemm_plain
from repro_torch.kernels import flash_attention as K3
from repro_torch.kernels.flash_attention_ref import flash_attention_plain, flash_attention_split_p, flash_errors


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False  # the plain version in full fp32


def _fp8(shape, dtype, g):
    x = torch.randn(shape, generator=g).cuda()
    s = compute_scale(tensor_amax(x), dtype)
    return quantize(x, s, dtype), s


# shapes off the 128 x 128 x 128 tile (ragged M, N and K; K not a multiple of
# 16, which the wrapper pads) and one of the training path, (1024, 2048, 8192)
@pytest.mark.gpu
@pytest.mark.parametrize(
    "M,K,N", [(256, 128, 384), (100, 70, 36), (1000, 1000, 1000), (8, 4096, 8), (192, 4160, 320), (1024, 2048, 8192)]
)
@pytest.mark.parametrize("fa,fb", [(E4M3, E4M3), (E5M2, E4M3), (E4M3, E5M2), (E5M2, E5M2)])
def test_cuda_fp8_gemm_matches_plain(M, K, N, fa, fb):
    _card()
    g = torch.Generator().manual_seed(M * 7 + K * 3 + N)
    a, sa = _fp8((M, K), fa, g)
    b, sb = _fp8((K, N), fb, g)
    at, bt = a.T.contiguous().T, b.T.contiguous().T  # column-major views: the backward's layouts
    for x, y in ((a, b), (at, b), (a, bt), (at, bt)):
        # the kernel reads K-major rows 16 bytes apart: a row-major a and a
        # column-major b are read as they are when K is a multiple of 16
        copies = int(x is at or K % 16 != 0) + int(y is b or K % 16 != 0)
        before, copies_before = K4.LAUNCHES["fp8_gemm"], K4.LAUNCHES["fp8_layout_copy"]
        out = K4.fp8_gemm(x, y, sa, sb)
        ref = fp8_gemm_plain(x, y, sa, sb)
        torch.cuda.synchronize()
        assert K4.LAUNCHES["fp8_gemm"] == before + 1
        assert K4.LAUNCHES["fp8_layout_copy"] == copies_before + copies
        assert out.dtype == torch.float32 and out.shape == (M, N)
        assert float((out - ref).abs().max()) <= 1e-5 * float(ref.abs().max())


FLASH_GPU_CASES = [
    # B, H, KV, Sq, Skv, hd, causal, window, softcap, dtype
    (2, 4, 2, 256, 256, 64, True, 0, 0.0, torch.float32),
    (1, 4, 4, 200, 200, 128, True, 0, 0.0, torch.bfloat16),
    (2, 8, 2, 300, 300, 64, True, 64, 0.0, torch.float32),
    (1, 2, 2, 256, 256, 256, True, 0, 30.0, torch.float32),
    (1, 4, 2, 130, 170, 16, False, 0, 0.0, torch.bfloat16),
    (1, 2, 1, 384, 384, 32, True, 0, 0.0, torch.float32),
    # the tensor-core kernel: hd 64, 80, 128, 160 and 256 (TMA pads hd to a
    # multiple of 64), GQA, window, softcap, ragged, Sq != Skv, short
    (2, 4, 4, 256, 256, 64, True, 0, 0.0, torch.bfloat16),
    (1, 4, 2, 300, 300, 80, False, 0, 0.0, torch.bfloat16),
    (2, 8, 2, 384, 384, 128, True, 64, 0.0, torch.bfloat16),
    (1, 4, 2, 257, 257, 160, True, 0, 0.0, torch.bfloat16),
    (1, 2, 2, 256, 256, 256, True, 0, 30.0, torch.bfloat16),
    (1, 4, 4, 300, 300, 256, True, 100, 0.0, torch.bfloat16),
    (1, 4, 2, 192, 320, 128, False, 0, 0.0, torch.bfloat16),
    (1, 4, 2, 320, 192, 64, True, 32, 0.0, torch.bfloat16),  # rows >= 223 see no key
    (1, 2, 2, 96, 96, 32, True, 0, 0.0, torch.bfloat16),
]
FLASH_BF16_LIMITS = {"max_spacings": 1.0, "mean_rel": 2e-5}  # chip_smoke.py's


def _flash_passes(r) -> bool:
    return r["max_spacings"] <= FLASH_BF16_LIMITS["max_spacings"] and r["mean_rel"] <= FLASH_BF16_LIMITS["mean_rel"]


@pytest.mark.gpu
@pytest.mark.parametrize("B,H,KV,Sq,Skv,hd,causal,window,softcap,dtype", FLASH_GPU_CASES)
def test_cuda_flash_attention_matches_plain(B, H, KV, Sq, Skv, hd, causal, window, softcap, dtype):
    _card()
    g = torch.Generator().manual_seed(Sq + hd)
    # with a softcap, scores of standard deviation 8 reach the cap
    q = ((8.0 if softcap else 1.0) * torch.randn((B, H, Sq, hd), generator=g)).to(dtype).cuda()
    k = torch.randn((B, KV, Skv, hd), generator=g).to(dtype).cuda()
    v = torch.randn((B, KV, Skv, hd), generator=g).to(dtype).cuda()
    kw = dict(causal=causal, window=window, softcap=softcap)
    before = K3.LAUNCHES["flash_attention"]
    out = K3.flash_attention_bhsd(q, k, v, **kw)
    ref = flash_attention_plain(q, k, v, **kw)
    # the model layout: transposed views, no copy
    out_m = K3.flash_attention(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2), **kw)
    torch.cuda.synchronize()
    assert K3.LAUNCHES["flash_attention"] == before + 2
    assert out.dtype == dtype and torch.equal(out_m.transpose(1, 2), out)
    if dtype == torch.float32:
        assert float((out - ref).abs().max()) < 1e-4
    else:
        errs = flash_errors(out, ref)
        assert _flash_passes(errs), errs
        control = flash_errors(flash_attention_split_p(q, k, v, terms=1, **kw), ref)
        assert not _flash_passes(control), control


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_cuda_flash_attention_no_key_rows(dtype):
    # Sq > Skv with a window: rows >= Skv + window - 1 see no key, where the
    # Pallas kernel and the plain version give the mean of V over all keys
    _card()
    B, H, KV, Sq, Skv, hd, window = 1, 4, 2, 512, 256, 128, 64
    g = torch.Generator().manual_seed(7)
    q, k, v = (torch.randn(s, generator=g).to(dtype).cuda() for s in ((B, H, Sq, hd), (B, KV, Skv, hd), (B, KV, Skv, hd)))
    out = K3.flash_attention_bhsd(q, k, v, causal=True, window=window)
    ref = flash_attention_plain(q, k, v, causal=True, window=window)
    mean_v = v.float().mean(2).repeat_interleave(H // KV, 1)[:, :, None].expand(B, H, Sq - Skv - window + 1, hd)
    torch.testing.assert_close(ref[:, :, Skv + window - 1 :].float(), mean_v, rtol=0, atol=1e-2 if dtype == torch.bfloat16 else 1e-6)
    errs = flash_errors(out, ref)
    assert errs["max_spacings"] <= (1.0 if dtype == torch.bfloat16 else 512.0) and errs["mean_rel"] <= 2e-5, errs


@pytest.mark.gpu
def test_cuda_flash_attention_refuses_gradients():
    _card()
    q = torch.randn((1, 2, 64, 64), device="cuda", requires_grad=True)
    with pytest.raises(RuntimeError, match="forward only"):
        K3.flash_attention_bhsd(q, q.detach(), q.detach())
