"""The CUDA kernels K1 (paged decode) and K2 (chunked prefill) against their
plain PyTorch versions, on the card.  Needs no JAX, so it runs where the
card is: ``python -m pytest -m gpu tests/test_torch_cuda_kernels.py``.  It
skips on a host without CUDA.

Both versions read the same bf16 pools and compute in fp32: with fp32
queries only the summation order differs (1e-4); with bf16 queries both
round the output to bf16 (2e-2).
"""

import pytest
import torch

from repro_torch.kernels import paged_attention as K
from repro_torch.kernels.paged_attention_ref import paged_attention_plain, paged_prefill_attention_plain

GPU_CASES = [
    # H, KV, hd, window, softcap, q dtype
    (16, 16, 128, 0, 0.0, torch.float32),
    (32, 8, 128, 32, 0.0, torch.bfloat16),
    (16, 16, 256, 0, 30.0, torch.float32),
    (4, 2, 16, 0, 0.0, torch.float32),
]


def _gpu_inputs(H, KV_, hd, q_shape, last_pos, q_dtype, bs=32, nb=6):
    g = torch.Generator().manual_seed(H * 1000 + hd)
    Bq = q_shape[0]
    N = 1 + Bq * nb + 2
    q = torch.randn(q_shape, generator=g).to(q_dtype).cuda()
    kp = torch.randn((N, bs, KV_, hd), generator=g).bfloat16().cuda()
    vp = torch.randn((N, bs, KV_, hd), generator=g).bfloat16().cuda()
    tbl = (torch.randperm(N - 1, generator=g)[: Bq * nb] + 1).reshape(Bq, nb).int()
    for b in range(Bq):
        tbl[b, int(last_pos[b]) // bs + 1 :] = 0
    return q, kp, vp, tbl.cuda()


@pytest.mark.gpu
@pytest.mark.parametrize("H,KV_,hd,window,softcap,q_dtype", GPU_CASES)
def test_cuda_decode_matches_plain(H, KV_, hd, window, softcap, q_dtype):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    lens = torch.tensor([1, 37, 150, 192], dtype=torch.int32)
    q, kp, vp, tbl = _gpu_inputs(H, KV_, hd, (4, H, hd), lens - 1, q_dtype)
    lens = lens.cuda()
    out = K.paged_attention(q, kp, vp, tbl, lens, softcap=softcap, window=window)
    ref = paged_attention_plain(q, kp, vp, tbl, lens, softcap=softcap, window=window)
    torch.cuda.synchronize()
    tol = 2e-2 if q_dtype == torch.bfloat16 else 1e-4
    assert float((out.float() - ref.float()).abs().max()) < tol


@pytest.mark.gpu
@pytest.mark.parametrize("H,KV_,hd,window,softcap,q_dtype", GPU_CASES)
def test_cuda_prefill_matches_plain(H, KV_, hd, window, softcap, q_dtype):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    C = 24
    start = torch.tensor([0, 40, 100], dtype=torch.int32)
    q, kp, vp, tbl = _gpu_inputs(H, KV_, hd, (3, C, H, hd), start + C - 1, q_dtype)
    start = start.cuda()
    out = K.paged_prefill_attention(q, kp, vp, tbl, start, softcap=softcap, window=window)
    ref = paged_prefill_attention_plain(q, kp, vp, tbl, start, softcap=softcap, window=window)
    torch.cuda.synchronize()
    tol = 2e-2 if q_dtype == torch.bfloat16 else 1e-4
    assert float((out.float() - ref.float()).abs().max()) < tol
