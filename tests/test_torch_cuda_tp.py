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
* Two replicas of TP=2 engines behind the router on four gloo ranks
  (``serving.remote``), replica 0 crashed: the placements and tokens of the
  same fleet of TP=1 engines, and K1/K2 on every rank.
* CloverLeaf's halo exchange over two gloo ranks: the one-device step bit
  for bit, and its control fails.
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


@pytest.fixture(scope="module")
def fleet():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return run_ranks(torch_tp_ranks.cuda_fleet_checks, (2, 2), backend="gloo", device="cuda", timeout_s=600)


def test_cuda_replicas_of_tp2_engines_fail_over(fleet):
    """Two replicas of TP=2 engines on four gloo ranks of the card, replica
    0 crashed at its 4th step: the TP=1 fleet's placements and tokens,
    every request done, and each rank launched K1 and K2 on its slice."""
    tp1, tp2 = fleet[0]["tp1"], fleet[0]["tp2"]
    assert tp2["placed"] == tp1["placed"] and set(tp2["placed"]) == {0, 1}
    assert tp2["tokens"] == tp1["tokens"]
    assert tp2["failovers"] == tp1["failovers"] >= 1 and tp2["requests_done"] == len(tp1["tokens"])
    assert tp2["states"] == {0: "dead", 1: "healthy"}
    for r in fleet:
        assert not r["jax_loaded"]
        got = r["tp2"]["launches"]
        assert got["paged_decode"] > 0 and got["paged_prefill"] > 0, got


def test_cuda_cloverleaf_over_two_ranks():
    """CloverLeaf's step over two gloo ranks on the card (the halo rows
    through host memory) equals the one-device step bit for bit, and the
    control (each rank wrapping its own rows) differs."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from repro_torch.benchmarks import cloverleaf

    rows = cloverleaf.run(sizes=(256,), iters=2, device="cuda", ranks=2)
    r = rows[0]
    assert r["name"] == "cloverleaf_256x256_2ranks" and r["bit_exact"] and not any(r["control_bit_exact"])
    assert r["halo_bytes_per_step"] == 2 * 256 * 4 * 2 and r["achieved_gbps"] > 0
