"""Sharded training on the card: two gloo ranks on one card, each with its
slice of the smoke olmo-1b (TP=2: 2 of 4 query heads, 64 of 128 FFN
columns).  Needs no JAX: ``python -m pytest -m gpu
tests/test_torch_cuda_sharded_train.py``.  It skips on a host without CUDA.

* K4 on each rank's local slices, the forward of ``w_up``'s column slice and
  the input gradient through ``w_down``'s transposed row slice, against the
  plain GEMM within ``chip_smoke.py``'s ``GEMM_RTOL`` (1e-5 of the output's
  largest magnitude), each launched once.
* The TP=2 step (fp8 through K4, remat full) over 3 steps against TP=1
  from one state within the fp8 limits of ``test_torch_sharded_train.py``
  (losses 2e-3 relative, gradient norms 5e-2, every parameter within 2 lr a
  step, their mean within lr / 5); every rank launches K4 4 times a site a
  layer a step.
* One short case a family (``torch_sharded_ranks.cuda_family_checks``):
  the smoke qwen3-moe at ``(1, 2)`` (2 of 4 experts a rank; capacity factor
  E / k, so bf16's near-tie flips move one token's output), hymba at
  ``(1, 2)`` (the attention and SSM heads whole, the FFN split) and hubert
  at ``(2, 1)`` (FSDP), 3 fp8 steps each against the one-rank steps within
  the same fp8 limits (the aux loss with the loss), and K4 4 times a site a
  layer a step on every rank; the smoke rwkv6-7b at ``(1, 2)`` (the time
  mix whole, the channel mix split) and at ``(2, 1)`` (FSDP), and
  llama-3.2-vision at ``(1, 2)``
  (self and cross heads split, gates opened to 1.0) in bf16 without fp8
  (no K4 launch), within the same limits, the ssm family's gradient norm
  within 1e-1 (``torch_sharded_parity.LOOSE_GRAD_NORM``), and one sharded
  eval forward launching K5 once a layer or K3 once a self layer on every
  rank.
* One sequence-parallel case a family (``CUDA_SP_CASES``: smoke olmo-1b,
  qwen3-moe, hymba, hubert, rwkv6-7b and llama-3.2-vision at ``(1, 2)``,
  the residual stream split over the two ranks): the same steps and limits
  against the one-rank steps, K4 4 times a site a layer a step on every
  rank where the family takes fp8, and a sharded eval in fp32 with
  sequence parallelism through K3 (once a self layer: at the local heads,
  or whole in hymba) or K5 (once a layer) against the same eval through
  the plain attention and scan, within ``SP_EVAL_REL``.
"""

import numpy as np
import pytest
import torch

from repro_torch.launch.mesh import run_ranks

import torch_sharded_ranks

pytestmark = pytest.mark.gpu

GEMM_RTOL = 1e-5
LR, STEPS, LAYERS, SITES = 1e-3, 3, 2, 7
SP_EVAL_REL = 1e-5  # fp32: K3's CUDA-core route, K5's 3xTF32 products


@pytest.fixture(scope="module")
def ranks():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return run_ranks(torch_sharded_ranks.cuda_checks, 2, backend="gloo", device="cuda", timeout_s=600)


def test_cuda_k4_on_local_slices(ranks):
    for r in ranks:
        assert r["local_mlp"] == ((64, 64), (64, 64))
        assert max(r["k4_errs"].values()) < GEMM_RTOL, r["k4_errs"]
        assert r["kernel_launches"] == 2


def test_cuda_tp2_step_equals_tp1(ranks):
    tp1 = ranks[0]["tp1"]
    for r in ranks:
        assert r["tp2"]["metrics"] == ranks[0]["tp2"]["metrics"]
        assert r["step_launches"] == 4 * LAYERS * SITES * STEPS
        assert not r["jax_loaded"]
    got = ranks[0]["tp2"]
    for a, b in zip(got["metrics"], tp1["metrics"]):
        assert abs(a["loss"] - b["loss"]) <= 2e-3 * abs(b["loss"])
        assert abs(a["grad_norm"] - b["grad_norm"]) <= 5e-2 * abs(b["grad_norm"])
    diff = np.concatenate([np.abs(a - b).ravel() for a, b in zip(got["params"], tp1["params"])])
    assert float(diff.max()) <= 2 * LR * STEPS and float(diff.mean()) < LR / 5


@pytest.fixture(scope="module")
def family_ranks():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return run_ranks(torch_sharded_ranks.cuda_family_checks, 2, backend="gloo", device="cuda", timeout_s=600)


@pytest.mark.parametrize("arch,shape", torch_sharded_ranks.CUDA_FAMILY_CASES,
                         ids=[torch_sharded_ranks.cuda_case_id(*c) for c in torch_sharded_ranks.CUDA_FAMILY_CASES])
def test_cuda_family_sharded_step_equals_one_rank(family_ranks, arch, shape):
    _check_family_case(family_ranks, arch, shape, sp=False)


@pytest.mark.parametrize("arch,shape", torch_sharded_ranks.CUDA_SP_CASES,
                         ids=[torch_sharded_ranks.cuda_case_id(*c, sp=True) for c in torch_sharded_ranks.CUDA_SP_CASES])
def test_cuda_sequence_parallel_step_equals_one_rank(family_ranks, arch, shape):
    _check_family_case(family_ranks, arch, shape, sp=True)
    for r in family_ranks:
        kernel, plain = r[torch_sharded_ranks.cuda_case_id(arch, shape, True)]["eval_losses"]
        assert abs(kernel - plain) <= SP_EVAL_REL * abs(plain), (kernel, plain)


def _check_family_case(family_ranks, arch, shape, sp):
    from repro_torch.config import reduce_for_smoke
    from repro_torch.configs import get_config
    from repro_torch.fp8 import fp8_sites, fp8_supported

    cfg = reduce_for_smoke(get_config(arch))
    case = torch_sharded_ranks.cuda_case_id(arch, shape, sp)
    got, one = family_ranks[0][case]["sharded"], family_ranks[0][case]["one_rank"]
    k4 = 4 * cfg.num_layers * len(fp8_sites(cfg)) * STEPS if fp8_supported(cfg) else 0
    kernel = None  # the eval's K5 or K3 launches a rank
    if cfg.family == "ssm":
        kernel = cfg.num_layers  # the time mix whole on every rank
    elif cfg.family == "vlm":
        kernel = cfg.num_layers - cfg.num_layers // cfg.vision.cross_attn_every  # the self layers
    elif sp:
        kernel = cfg.num_layers  # every layer's self attention
    for r in family_ranks:
        assert r[case]["sharded"]["metrics"] == got["metrics"]
        assert r[case]["launches"] == k4
        assert r[case]["eval_launches"] == kernel
        assert not r["jax_loaded"]
    norm_rel = 1e-1 if cfg.family == "ssm" else 5e-2
    for a, b in zip(got["metrics"], one["metrics"]):
        for k in ("loss", "aux_loss"):
            assert abs(a[k] - b[k]) <= 2e-3 * abs(b[k]), (k, a[k], b[k])
        assert abs(a["grad_norm"] - b["grad_norm"]) <= norm_rel * abs(b["grad_norm"])
    diff = np.concatenate([np.abs(a - b).ravel() for a, b in zip(got["params"], one["params"])])
    assert float(diff.max()) <= 2 * LR * STEPS and float(diff.mean()) < LR / 5
