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
# 16, which the wrapper pads), one of the training path, (1024, 2048, 8192),
# and the projections of hymba-1.5b (attn_k/v 1600 -> 320, ffn_down 5504 ->
# 1600, the weight gradient of attn_k/v) and hubert-xlarge (attn 1280 ->
# 1280, ffn_down 5120 -> 1280)
@pytest.mark.gpu
@pytest.mark.parametrize(
    "M,K,N", [(256, 128, 384), (100, 70, 36), (1000, 1000, 1000), (8, 4096, 8), (192, 4160, 320), (1024, 2048, 8192),
              (1024, 1600, 320), (1024, 5504, 1600), (1600, 1024, 320), (1024, 1280, 1280), (1024, 5120, 1280)]
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
    # llama-3.2-vision-90b's 8 query heads per kv head, on both routes
    (1, 16, 2, 320, 320, 128, True, 0, 0.0, torch.bfloat16),
    (2, 16, 2, 256, 256, 128, True, 0, 0.0, torch.float32),
    # the eval forwards of the moe, hybrid and audio families: qwen3-moe's
    # 64 query heads over 4, hymba-1.5b's 25 over 5 at hd 64 with its window
    # of 1024 past the window, hubert-xlarge's 16 bidirectional heads of 80
    (1, 64, 4, 512, 512, 128, True, 0, 0.0, torch.bfloat16),
    (1, 25, 5, 1536, 1536, 64, True, 1024, 0.0, torch.bfloat16),
    (1, 16, 16, 640, 640, 80, False, 0, 0.0, torch.bfloat16),
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


@pytest.mark.gpu
def test_cuda_failure_replay_is_bit_exact(tmp_path):
    """The fault-tolerant runner on the card: a smoke-size fp8 run (K4 in
    every projection) with node 1 failing at step 4 replays from step 3's
    checkpoint to the clean run's losses and state, bit for bit."""
    _card()
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.config import PrecisionConfig, RunConfig, TrainConfig, reduce_for_smoke
    from repro_torch.configs import get_config
    from repro_torch.core import Cluster, ClusterSpec, FaultTolerantRunner
    from repro_torch.data import make_batch_fn
    from repro_torch.train import init_train_state, make_train_step
    from repro_torch.utils.tree import flatten_with_paths

    cfg = reduce_for_smoke(get_config("olmo-1b"))
    run = RunConfig(arch="olmo-1b", train=TrainConfig(global_batch=4, seq_len=64, warmup_steps=1),
                    precision=PrecisionConfig(fp8=True))

    def runner(tag):
        cluster = Cluster(ClusterSpec("t", nodes_per_pod=2, num_pods=1))
        cluster.allocate([0, 1], "train-job")
        for n in cluster.nodes.values():
            cluster.heartbeat(n.node_id, 0.0)
        return FaultTolerantRunner(
            step_fn=make_train_step(cfg, run), init_state=init_train_state(cfg, run, 0, "cuda"),
            batch_fn=make_batch_fn(cfg, global_batch=4, seq_len=64, seed=0, device="cuda"), cluster=cluster,
            ckpt=CheckpointManager(tmp_path / tag, keep=2, async_save=False), checkpoint_every=3)

    clean, faulty = runner("clean"), runner("faulty")
    before = K4.LAUNCHES["fp8_gemm"]
    r1 = clean.run(6)
    assert K4.LAUNCHES["fp8_gemm"] > before  # the steps ran K4
    r2 = faulty.run(6, failure_schedule={4: 1})
    assert (r2.failures, r2.restores, r2.rollback_steps) == (1, 1, 1)
    assert r1.losses == r2.losses
    for (p, a), (_, b) in zip(flatten_with_paths(clean.state), flatten_with_paths(faulty.state)):
        assert a.device.type == "cuda" and torch.equal(a, b), p
