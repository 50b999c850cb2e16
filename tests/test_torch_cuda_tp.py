"""Tensor-parallel serving on the card: two gloo ranks on one card, each
with its slice of the smoke olmo-1b (2 of 4 query heads, 1 of 2 kv heads).
Needs no JAX: ``python -m pytest -m gpu tests/test_torch_cuda_tp.py``.  It
skips on a host without CUDA.

* K1 and K2 on each rank's local head slice (fp32 queries, bf16 pools)
  against their plain versions, within ``chip_smoke.py``'s fp32 limit
  (1e-4), each launched once.
* The TP=2 engine (fp32 pools, prefill budget 8, K1/K2 on each rank) gives
  TP=1's greedy tokens, the same on both ranks, and each rank launched K1
  and K2.
* ``fused=True`` on the gloo group raises: a CUDA graph cannot capture
  gloo's collectives, which stage CUDA tensors through host memory.
"""

import pytest
import torch

from repro_torch.launch.mesh import run_ranks

import torch_tp_ranks

pytestmark = pytest.mark.gpu

TOL = 1e-4


@pytest.fixture(scope="module")
def ranks():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return run_ranks(torch_tp_ranks.cuda_checks, 2, backend="gloo", device="cuda", timeout_s=600)


def test_cuda_tp_kernels_on_local_slices(ranks):
    for r in ranks:
        assert r["local_heads"] == (2, 1)
        assert r["kernel_errs"]["paged_decode"] < TOL and r["kernel_errs"]["paged_prefill"] < TOL, r["kernel_errs"]
        assert r["kernel_launches"]["paged_decode"] == 1 and r["kernel_launches"]["paged_prefill"] == 1


def test_cuda_tp_tokens_equal_tp1(ranks):
    r0, r1 = ranks
    assert r0["tp2"] == r0["tp1"] and r1["tp2"] == r0["tp2"]
    for r in ranks:
        assert r["launches"]["paged_decode"] > 0 and r["launches"]["paged_prefill"] > 0, r["launches"]


def test_cuda_tp_fused_on_gloo_raises(ranks):
    for r in ranks:
        assert r["fused_refusal"] is not None and "NCCL" in r["fused_refusal"]
