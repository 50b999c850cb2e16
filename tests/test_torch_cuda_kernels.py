"""The CUDA kernels K1 (paged decode) and K2 (chunked prefill) against their
plain PyTorch versions, on the card.  Needs no JAX, so it runs where the
card is: ``python -m pytest -m gpu tests/test_torch_cuda_kernels.py``.  It
skips on a host without CUDA.

Both versions read the same bf16 pools and compute in fp32: with fp32
queries only the summation order differs (1e-4); with bf16 queries both
round the output to bf16 (2e-2).  K1 splits each walk over a cluster of
up to 8 blocks: every forced cluster size holds, and v1 stays checked as
its yardstick (``paged_attention_cuda_cores``).  K2 on bf16 pools runs on the tensor
cores, with fp32 queries split into two bf16 terms: each of its cases also
computes a control that must miss the limit (q in one bf16 term; for bf16
queries, the causal mask off by one).  v1, the CUDA-core K2, stays checked
on fp32 pools and through ``paged_prefill_attention_cuda_cores``.

The fused serving step's CUDA graphs (``serving/graphs.py``) replay the
decode and the mixed (R, W) step on the smoke olmo-1b: the same logits and
tokens as the eager step on the same inputs, bit for bit, with K1 or K2
among the calls each capture recorded, and again after the host staged new
inputs.
"""

import numpy as np
import pytest
import torch

from repro_torch.config import reduce_for_smoke
from repro_torch.configs import get_config
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


TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
# K2's serving chunks on olmo-1b's heads and GQA 32/8: H, KV, hd, C, start, window, q dtype
ROUTE_CASES = [
    (16, 16, 128, 1, 200, 0, torch.float32),
    (16, 16, 128, 16, 200, 0, torch.float32),
    (16, 16, 128, 40, 200, 0, torch.float32),
    (32, 8, 128, 128, 192, 0, torch.float32),
    (32, 8, 128, 128, 192, 32, torch.bfloat16),
]


def _err(a, b) -> float:
    return float((a.float() - b.float()).abs().max())


@pytest.mark.gpu
@pytest.mark.parametrize("H,KV_,hd,C,start,window,q_dtype", ROUTE_CASES)
def test_cuda_prefill_tensor_core_route(H, KV_, hd, C, start, window, q_dtype):
    """bf16 pools: the tensor-core K2 against the plain version within the
    limit, every cluster split alike; the control misses it."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    st = torch.tensor([start], dtype=torch.int32)
    q, kp, vp, tbl = _gpu_inputs(H, KV_, hd, (1, C, H, hd), st + C - 1, q_dtype, nb=16)
    st = st.cuda()
    assert K.prefill_route(q.dtype, kp.dtype) == "tensor_cores_bf16"
    ref = paged_prefill_attention_plain(q, kp, vp, tbl, st, window=window)
    before = dict(K.LAUNCHES)
    outs = [K.paged_prefill_attention(q, kp, vp, tbl, st, window=window)]
    outs += [K._prefill_launch(q, kp, vp, tbl, st, window=window, split=split) for split in (1, 2, 3, 4)]
    torch.cuda.synchronize()
    assert K.LAUNCHES["paged_prefill"] == before["paged_prefill"] + 5
    assert K.LAUNCHES["paged_prefill_cuda_cores"] == before["paged_prefill_cuda_cores"]
    for out in outs:
        assert out.dtype == q_dtype and bool(torch.isfinite(out).all())
        assert _err(out, ref) < TOL[q_dtype]
    if q_dtype == torch.float32:
        control = paged_prefill_attention_plain(q.bfloat16().float(), kp, vp, tbl, st, window=window)
    else:
        control = paged_prefill_attention_plain(q, kp, vp, tbl, st + 1, window=window)
    assert _err(control, ref) > TOL[q_dtype]


@pytest.mark.gpu
@pytest.mark.parametrize("q_dtype", [torch.float32, torch.bfloat16])
def test_cuda_prefill_cuda_cores_yardstick(q_dtype):
    """v1 stays checked: the route of fp32 pools, and the yardstick entry
    point on bf16 pools, which counts its own launches."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    C = 24
    st = torch.tensor([0, 40, 100], dtype=torch.int32)
    q, kp, vp, tbl = _gpu_inputs(16, 16, 128, (3, C, 16, 128), st + C - 1, q_dtype)
    st = st.cuda()
    ref = paged_prefill_attention_plain(q, kp, vp, tbl, st)
    before = dict(K.LAUNCHES)
    yard = K.paged_prefill_attention_cuda_cores(q, kp, vp, tbl, st)
    kp32, vp32 = kp.float(), vp.float()
    assert K.prefill_route(q.dtype, kp32.dtype) == "cuda_cores_fp32"
    fp32_pools = K.paged_prefill_attention(q, kp32, vp32, tbl, st)
    torch.cuda.synchronize()
    assert K.LAUNCHES["paged_prefill_cuda_cores"] == before["paged_prefill_cuda_cores"] + 1
    assert K.LAUNCHES["paged_prefill"] == before["paged_prefill"] + 1
    assert _err(yard, ref) < TOL[q_dtype]
    assert _err(fp32_pools, ref) < TOL[q_dtype]


@pytest.mark.gpu
def test_cuda_prefill_table_entries_out_of_range_read_block_0():
    """A table entry outside [0, N) reads the null block 0 on both routes."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    C = 32
    st = torch.tensor([64, 69], dtype=torch.int32)
    q, kp, vp, tbl = _gpu_inputs(16, 16, 128, (2, C, 16, 128), st + C - 1, torch.float32, nb=8)
    N = kp.shape[0]
    bad = tbl.clone()
    bad[0, 1], bad[1, 2] = N + 7, -3
    good = bad.clone()
    good[0, 1], good[1, 2] = 0, 0
    st = st.cuda()
    ref = paged_prefill_attention_plain(q, kp, vp, good, st)
    routed = K.paged_prefill_attention(q, kp, vp, bad, st)
    yard = K.paged_prefill_attention_cuda_cores(q, kp, vp, bad, st)
    torch.cuda.synchronize()
    assert _err(routed, ref) < TOL[torch.float32]
    assert _err(yard, ref) < TOL[torch.float32]


@pytest.mark.gpu
@pytest.mark.parametrize("q_dtype", [torch.float32, torch.bfloat16])
def test_cuda_prefill_chunk_past_the_table_sees_only_its_blocks(q_dtype):
    """A chunk that runs past the table's last block (start + C > nb * bs)
    sees the table's positions only, on both routes and every cluster
    split: the tensor-core walk's last tile pads with block 0, which the
    kernel must mask, as v1 stops at the table's end."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    C, nb = 40, 3  # positions 80 .. 119 against a table of 96
    st = torch.tensor([80], dtype=torch.int32)
    q, kp, vp, tbl = _gpu_inputs(16, 16, 128, (1, C, 16, 128), st + C - 1, q_dtype, nb=nb)
    st = st.cuda()
    assert int(st[0]) + C > nb * kp.shape[1]
    ref = paged_prefill_attention_plain(q, kp, vp, tbl, st)
    outs = [K.paged_prefill_attention(q, kp, vp, tbl, st), K.paged_prefill_attention_cuda_cores(q, kp, vp, tbl, st)]
    outs += [K._prefill_launch(q, kp, vp, tbl, st, split=split) for split in (2, 3, 4)]
    torch.cuda.synchronize()
    for out in outs:
        assert out.dtype == q_dtype and bool(torch.isfinite(out).all())
        assert _err(out, ref) < TOL[q_dtype]


# K1 over a 16-entry table of 32-position blocks: lengths 1, 32, 33, 352 and
# the table's end; H, KV, hd, window, softcap, q dtype, pool dtype
SPLIT_CASES = [
    (16, 16, 128, 0, 0.0, torch.float32, torch.bfloat16),
    (32, 8, 128, 20, 0.0, torch.float32, torch.bfloat16),  # a window shorter than a share
    (16, 16, 256, 0, 30.0, torch.float32, torch.bfloat16),
    (32, 8, 128, 0, 0.0, torch.bfloat16, torch.bfloat16),
    (16, 4, 64, 0, 0.0, torch.float32, torch.float32),
    (8, 1, 32, 7, 0.0, torch.bfloat16, torch.float32),
]


@pytest.mark.gpu
@pytest.mark.parametrize("H,KV_,hd,window,softcap,q_dtype,pool_dtype", SPLIT_CASES)
def test_cuda_decode_every_cluster_size(H, KV_, hd, window, softcap, q_dtype, pool_dtype):
    """K1 with every forced cluster size 1 to 8 and the one it picks, and
    v1, against the plain version; only the split kernel counts as
    ``paged_decode``."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    lens = torch.tensor([1, 32, 33, 352, 512], dtype=torch.int32)
    q, kp, vp, tbl = _gpu_inputs(H, KV_, hd, (5, H, hd), lens - 1, q_dtype, nb=16)
    kp, vp, lens = kp.to(pool_dtype), vp.to(pool_dtype), lens.cuda()
    kw = dict(softcap=softcap, window=window)
    ref = paged_attention_plain(q, kp, vp, tbl, lens, **kw)
    before = dict(K.LAUNCHES)
    outs = [K.paged_attention(q, kp, vp, tbl, lens, **kw)]
    outs += [K._decode_launch(q, kp, vp, tbl, lens, split=split, **kw) for split in range(1, 9)]
    yard = K.paged_attention_cuda_cores(q, kp, vp, tbl, lens, **kw)
    torch.cuda.synchronize()
    assert 1 <= K._decode_split(q, kp, tbl, window=window) <= 8
    assert K.LAUNCHES["paged_decode"] == before["paged_decode"] + 9
    assert K.LAUNCHES["paged_decode_cuda_cores"] == before["paged_decode_cuda_cores"] + 1
    for out in (*outs, yard):
        assert out.dtype == q_dtype and bool(torch.isfinite(out).all())
        assert _err(out, ref) < TOL[q_dtype]
    with pytest.raises(ValueError, match="split 9"):
        K._decode_launch(q, kp, vp, tbl, lens, split=9, **kw)


@pytest.mark.gpu
def test_cuda_decode_table_entries_out_of_range_read_block_0():
    """A table entry outside [0, N) reads the null block 0 in K1 and v1."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    lens = torch.tensor([70, 90], dtype=torch.int32)
    q, kp, vp, tbl = _gpu_inputs(16, 16, 128, (2, 16, 128), lens - 1, torch.float32, nb=4)
    bad = tbl.clone()
    bad[0, 1], bad[1, 2] = kp.shape[0] + 7, -3
    good = bad.clone()
    good[0, 1], good[1, 2] = 0, 0
    lens = lens.cuda()
    ref = paged_attention_plain(q, kp, vp, good, lens)
    outs = [K.paged_attention(q, kp, vp, bad, lens), K.paged_attention_cuda_cores(q, kp, vp, bad, lens)]
    outs += [K._decode_launch(q, kp, vp, bad, lens, split=split) for split in (2, 8)]
    torch.cuda.synchronize()
    for out in outs:
        assert _err(out, ref) < TOL[torch.float32]


def _graph_engine():
    from repro_torch.models import init_params
    from repro_torch.serving import InferenceEngine

    cfg = reduce_for_smoke(get_config("olmo-1b"))
    eng = InferenceEngine(cfg, init_params(cfg, 0, device="cuda"), max_batch=4, max_seq=128, block_size=16,
                          fused=True, eos_token=1 << 30)
    g = torch.Generator(device="cuda").manual_seed(1)
    for name in ("k", "v"):  # a history in every block
        eng.cache[name].copy_(torch.randn(eng.cache[name].shape, generator=g, device="cuda"))
    eng.tbl[:] = np.arange(1, 1 + eng.tbl.size).reshape(eng.tbl.shape)
    eng._tbl_dirty = True
    eng._sync_tables()
    return eng


def _graph_inputs(eng, kind, seed):
    rng = np.random.default_rng(seed)
    V, B, nb = eng.cfg.vocab_size, eng.max_batch, eng.max_blocks_per_seq
    if kind == "decode":
        return dict(
            tokens=rng.integers(0, V, (B, 1)).astype(np.int32), pos=rng.integers(0, 100, B).astype(np.int32),
            temps=np.zeros(B, np.float32), top_ks=np.zeros(B, np.int32), room=np.full(B, 5, np.int32),
        )
    # a decode row, two chunk rows of one request, a width-0 pad row
    R, W = 4, 8
    s0 = int(rng.integers(0, 90))
    tbl = np.zeros((R, nb), np.int32)
    tbl[0], tbl[1], tbl[2] = eng.tbl[0], eng.tbl[1], eng.tbl[1]
    return dict(
        tokens=rng.integers(0, V, (R, W)).astype(np.int32), start=np.array([s0 + 7, s0, s0 + 8, 0], np.int32),
        widths=np.array([1, 8, 5, 0], np.int32), tbl=tbl, temps=np.zeros(R, np.float32),
        top_ks=np.zeros(R, np.int32), sample_lane=np.array([0, 7, 4, 0], np.int32), room=np.full(R, 9, np.int32),
    )


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["decode", "mixed"])
def test_cuda_step_graphs_replay_the_eager_step(kind):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from repro_torch.models import decode_step, unified_step

    eng = _graph_engine()
    cfg, params, cache = eng.cfg, eng.params, eng.cache

    def logits_fn(**a):
        if kind == "decode":
            return decode_step(cfg, params, cache, a["tokens"], a["pos"])[0]
        return unified_step(cfg, params, cache, a["tokens"], a["start"], a["widths"], a["tbl"])[0]

    tokens_fn = eng._fused_decode_fn if kind == "decode" else eng._fused_mixed_fn
    kernel = "paged_decode" if kind == "decode" else "paged_prefill"
    graphs = eng._graphs
    for seed in (0, 1):  # the second replays the graphs on newly staged inputs
        inputs = _graph_inputs(eng, kind, seed)
        on_card = {n: torch.from_numpy(a).cuda() for n, a in inputs.items()}
        eager = [logits_fn(**on_card).clone(), tokens_fn(**on_card).clone()]
        replayed = [graphs.run(("logits", kind), logits_fn, inputs).clone(),
                    graphs.run(("tokens", kind), tokens_fn, inputs).clone()]
        torch.cuda.synchronize()
        assert graphs.captures == 2 and graphs.replays == 2 * (seed + 1)
        assert torch.equal(replayed[0], eager[0]) and torch.isfinite(eager[0]).all()
        assert torch.equal(replayed[1], eager[1])
    assert all(g.launches[kernel] == cfg.num_layers for g in graphs._graphs.values())
    assert graphs.launches[kernel] == 4 * cfg.num_layers
    # greedy rows: the tokens are the argmax of the sampled lane's logits
    lanes = eager[0] if kind == "decode" else eager[0][torch.arange(4), torch.tensor([0, 7, 4, 0])]
    assert eager[1][0, :3].tolist() == lanes.argmax(-1)[:3].tolist()
    eng.cache["k"] = eng.cache["k"].clone()  # the graphs hold the old pool's address
    with pytest.raises(RuntimeError, match="reallocated"):
        graphs.run(("tokens", kind), tokens_fn, inputs)
