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
decode, the mixed (R, W) step and its spec variant (verify rows, accept
and rollback in the graph) on the smoke olmo-1b: the same logits and
tokens as the eager step on the same inputs, bit for bit, with K1 or K2
among the calls each capture recorded, and again after the host staged new
inputs.

Speculative decoding: K2 at the verify window's C = spec_k + 1 against the
plain version; verify rows beside a chunk row in one ``unified_step``
through K2 and through the plain attention; ``truncate_block_rows``
captured in a graph and replayed, rejected rows zero and the rest
unchanged.

KV-cache tiers: the plain dequantizing read of int8 / e4m3 pools (they
have no kernel) against K1/K2 over fp32 pools that hold the same
dequantized rows, within 1e-4, with scales shifted by one token row as the
control that must miss it; a block gathered off a bf16 pool, spilled to
host memory (``SpillPool``, staging depth 0), popped and restored into
another block bit for bit, K2 over the restored block bit-equal to K2 over
the original, and a restore into the neighbouring block as the control.

The moe family on the card: smoke qwen3-moe and arctic at capacity factor
8 (no pair can be dropped) served through the legacy and the fused walk
over fp32 pools, tokens equal to the same engine on CPU tensors (the plain
attention and the same routing), with K1 and K2 launched.

The recurrent-state families: K1 at hymba-1.5b's heads (5 query heads per
kv head, an odd row count for its rows of 8; head dim 16 at smoke size and
64 at full width) with lengths past the sliding window, at the cluster
size it picks and at every forced one; the smoke hymba engine (paged
fp32 pools, K1 for its attention, and dense) and the smoke rwkv6-7b
engine on the card, tokens equal to the same engine on CPU tensors.

The vlm family: the smoke llama-3.2-vision-90b engine (two layer groups,
cross gates open, K/V biases so that the engine's zero image tokens
project to nonzero image K/V) on the card, tokens equal to the same engine
on CPU tensors, no kernel launched.
"""

import dataclasses

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


SPEC_K = 4  # the verify window: spec_k + 1 lanes


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
    R, W = 4, 8
    if kind == "spec":
        # the mixed step's spec variant, whose accept and rollback run in
        # the same call: two verify rows (random drafts, rejected and rolled
        # back; no draft), a chunk row, a width-0 pad row
        s0 = int(rng.integers(0, 80))
        tbl = np.zeros((R, nb), np.int32)
        tbl[0], tbl[1], tbl[2] = eng.tbl[0], eng.tbl[2], eng.tbl[1]
        drafts = np.zeros((R, W - 1), np.int32)
        drafts[0, :SPEC_K] = rng.integers(0, V, SPEC_K)
        valid = np.zeros((R, W - 1), np.int32)
        valid[0, :SPEC_K] = 1
        tokens = rng.integers(0, V, (R, W)).astype(np.int32)
        tokens[0, 1 : 1 + SPEC_K] = drafts[0, :SPEC_K]
        start = np.array([s0 + 3, s0 + 11, s0, 0], np.int32)
        return dict(
            tokens=tokens, start=start, widths=np.array([SPEC_K + 1, SPEC_K + 1, 8, 0], np.int32), tbl=tbl,
            temps=np.zeros(R, np.float32), top_ks=np.zeros(R, np.int32), sample_lane=np.array([0, 0, 7, 0], np.int32),
            room=np.full(R, 9, np.int32), drafts=drafts, valid=valid,
            roll_end=np.array([s0 + 3 + SPEC_K + 1, s0 + 11 + SPEC_K + 1, 0, 0], np.int32),
        )
    # a decode row, two chunk rows of one request, a width-0 pad row
    s0 = int(rng.integers(0, 90))
    tbl = np.zeros((R, nb), np.int32)
    tbl[0], tbl[1], tbl[2] = eng.tbl[0], eng.tbl[1], eng.tbl[1]
    return dict(
        tokens=rng.integers(0, V, (R, W)).astype(np.int32), start=np.array([s0 + 7, s0, s0 + 8, 0], np.int32),
        widths=np.array([1, 8, 5, 0], np.int32), tbl=tbl, temps=np.zeros(R, np.float32),
        top_ks=np.zeros(R, np.int32), sample_lane=np.array([0, 7, 4, 0], np.int32), room=np.full(R, 9, np.int32),
    )


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["decode", "mixed", "spec"])
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
        assert torch.isfinite(eager[0]).all()
        if kind == "spec":
            # the spec step's rollback zeroes rows of the null block, which
            # pad rows and lanes past a row's width read, between the calls:
            # the lanes the engine reads must agree bit for bit
            widths = inputs["widths"]
            for r, w in enumerate(widths):
                assert torch.equal(replayed[0][r, :w], eager[0][r, :w]), (seed, r)
            live = torch.from_numpy(widths > 0).cuda()
            assert torch.equal(replayed[1][:, live], eager[1][:, live])
        else:
            assert torch.equal(replayed[0], eager[0])
            assert torch.equal(replayed[1], eager[1])
    assert all(g.launches[kernel] == cfg.num_layers for g in graphs._graphs.values())
    assert graphs.launches[kernel] == 4 * cfg.num_layers
    # greedy rows: the tokens are the argmax of the sampled lane's logits,
    # lane n_acc + sample_lane (n_acc is 0 without a draft window)
    if kind == "decode":
        lanes = eager[0]
    else:
        sampled = eager[1][1].long().cpu() + torch.from_numpy(inputs["sample_lane"]).long()
        lanes = eager[0][torch.arange(4), sampled.cuda()]
    assert eager[1][0, :3].tolist() == lanes.argmax(-1)[:3].tolist()
    eng.cache["k"] = eng.cache["k"].clone()  # the graphs hold the old pool's address
    with pytest.raises(RuntimeError, match="reallocated"):
        graphs.run(("tokens", kind), tokens_fn, inputs)


# ---------------------------------------------------------------------------
# speculative decoding: K2 at the verify window, the rollback in a graph
# ---------------------------------------------------------------------------


@pytest.mark.gpu
@pytest.mark.parametrize("q_dtype", [torch.float32, torch.bfloat16])
def test_cuda_verify_window_matches_plain(q_dtype):
    """K2 at C = spec_k + 1 (not a power of two): verify rows at several
    starts (a block's first position, mid-block, across a block edge) and a
    pad row with an all-null table, against the plain version; the control
    misses the limit."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    C = SPEC_K + 1
    st = torch.tensor([0, 27, 96, 253, 0], dtype=torch.int32)
    q, kp, vp, tbl = _gpu_inputs(16, 16, 128, (5, C, 16, 128), st + C - 1, q_dtype, nb=16)
    tbl[4] = 0  # a pad row
    st = st.cuda()
    ref = paged_prefill_attention_plain(q, kp, vp, tbl, st)
    out = K.paged_prefill_attention(q, kp, vp, tbl, st)
    torch.cuda.synchronize()
    assert out.dtype == q_dtype and bool(torch.isfinite(out).all())
    assert _err(out, ref) < TOL[q_dtype]
    if q_dtype == torch.float32:
        control = paged_prefill_attention_plain(q.bfloat16().float(), kp, vp, tbl, st)
    else:
        control = paged_prefill_attention_plain(q, kp, vp, tbl, st + 1)
    assert _err(control, ref) > TOL[q_dtype]


@pytest.mark.gpu
def test_cuda_mixed_spec_rows_kernel_matches_plain_path():
    """One ``unified_step`` over verify rows (width spec_k + 1), a 64-lane
    chunk row and a width-0 pad row, W = 64, with K2 and with the plain
    attention on copies of one bf16 cache: the valid lanes' logits agree
    within the full-width path's limit (each layer's K/V rounds to bf16
    from activations that differ in the last fp32 bits), and both paths
    write the same K/V into the live blocks, nothing past a row's width."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from repro_torch.models import init_paged_cache, init_params, unified_step

    cfg = reduce_for_smoke(get_config("olmo-1b"))
    params = init_params(cfg, 0, device="cuda")
    R, W, nb, bs = 4, 64, 8, 16
    cache = init_paged_cache(cfg, 1 + 3 * nb, bs, 4, nb, torch.bfloat16, device="cuda")
    g = torch.Generator(device="cuda").manual_seed(3)
    for name in ("k", "v"):
        cache[name].copy_(torch.randn(cache[name].shape, generator=g, device="cuda"))
    rng = np.random.default_rng(0)
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab_size, (R, W)).astype(np.int32)).cuda()
    start = torch.tensor([37, 64, 20, 0], dtype=torch.int32, device="cuda")
    widths = torch.tensor([SPEC_K + 1, SPEC_K + 1, 64, 0], dtype=torch.int32, device="cuda")
    tbl = torch.zeros((R, nb), dtype=torch.int32, device="cuda")
    for r in range(3):
        tbl[r] = torch.arange(1 + r * nb, 1 + (r + 1) * nb, device="cuda")
    caches = {impl: {n: t.clone() for n, t in cache.items()} for impl in ("kernel", "plain")}
    before = dict(K.LAUNCHES)
    logits = {impl: unified_step(cfg, params, caches[impl], tokens, start, widths, tbl, attn_impl=impl)[0]
              for impl in caches}
    torch.cuda.synchronize()
    assert K.LAUNCHES["paged_prefill"] == before["paged_prefill"] + cfg.num_layers
    for r, w in enumerate(widths.tolist()[:3]):
        assert _err(logits["kernel"][r, :w], logits["plain"][r, :w]) < 2e-2
    live = slice(1, 1 + 3 * nb)
    for name in ("k", "v"):
        assert _err(caches["kernel"][name][:, live], caches["plain"][name][:, live]) < 5e-2
        # lanes past each row's width wrote only the null block
        for r, w in enumerate(widths.tolist()[:3]):
            s0 = int(start[r]) + w
            blk, off = int(tbl[r, s0 // bs]), s0 % bs
            assert torch.equal(caches["kernel"][name][:, blk, off], cache[name][:, blk, off])


@pytest.mark.gpu
def test_cuda_truncate_block_rows_in_a_graph():
    """The rollback captured in a CUDA graph and replayed on newly staged
    ranges: the rows of [start, end) read zero, every other row of a live
    block is unchanged, and the rows of an ``end <= start`` row too."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from repro_torch.serving.kvcache import truncate_block_rows

    L, N, bs, KV, hd, B, nb, span = 3, 1 + 4 * 6, 16, 2, 128, 4, 6, SPEC_K + 1
    g = torch.Generator(device="cuda").manual_seed(5)
    cache = {n: torch.randn((L, N, bs, KV, hd), generator=g, device="cuda").bfloat16() for n in ("k", "v")}
    tbl = torch.arange(1, N, dtype=torch.int32, device="cuda").reshape(B, nb)
    start = torch.zeros(B, dtype=torch.int32, device="cuda")
    end = torch.zeros(B, dtype=torch.int32, device="cuda")

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        truncate_block_rows(cache, tbl, start, end, span=span)  # warm-up: a no-op range
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        truncate_block_rows(cache, tbl, start, end, span=span)

    for ranges in ([(10, 15), (30, 33), (7, 7), (90, 95)], [(15, 20), (0, 5), (50, 48), (93, 96)]):
        for n in cache:
            cache[n].copy_(torch.randn(cache[n].shape, generator=g, device="cuda"))
        before = {n: t.clone() for n, t in cache.items()}
        start.copy_(torch.tensor([a for a, _ in ranges], dtype=torch.int32))
        end.copy_(torch.tensor([b for _, b in ranges], dtype=torch.int32))
        graph.replay()
        torch.cuda.synchronize()
        rows = tbl.cpu()
        for n in cache:
            expected = before[n].cpu()
            for b, (a, e) in enumerate(ranges):
                for pos in range(a, e):
                    expected[:, rows[b, pos // bs], pos % bs] = 0
            # block 0, the null block, takes the dead lanes' writes
            assert torch.equal(cache[n].cpu()[:, 1:], expected[:, 1:]), (n, ranges)


def _quantized_case(mode, kind, seed=3, H=16, KV_=16, hd=128, bs=32, nb=16):
    """int8 / e4m3 pools filled by ``quantize`` from random K/V, the fp32
    pools holding the same dequantized rows, a table and the queries."""
    from repro_torch.serving.kvquant import quantize

    g = torch.Generator(device="cuda").manual_seed(seed)
    B = 4 if kind == "decode" else 1
    N = 1 + B * nb
    pools = {}
    for name in ("k", "v"):
        codes, scale = quantize(torch.randn((N, bs, KV_, hd), generator=g, device="cuda"), mode)
        pools[name], pools[f"{name}_scale"], pools[f"{name}_fp32"] = codes, scale, codes.float() * scale
    tbl = torch.arange(1, N, dtype=torch.int32, device="cuda").reshape(B, nb)
    if kind == "decode":
        q = torch.randn((B, H, hd), generator=g, device="cuda")
        lens = torch.tensor([77, 160, 291, 352], dtype=torch.int32, device="cuda")
    else:
        q = torch.randn((B, 128, H, hd), generator=g, device="cuda")
        lens = torch.tensor([192], dtype=torch.int32, device="cuda")
    return q, pools, tbl, lens


@pytest.mark.gpu
@pytest.mark.parametrize("mode", ["int8", "fp8"])
@pytest.mark.parametrize("kind", ["decode", "prefill"])
def test_cuda_kv_quant_read_matches_kernels(mode, kind):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    q, p, tbl, lens = _quantized_case(mode, kind)
    if kind == "decode":
        plain, kernel = K.paged_attention_quantized, K.paged_attention
    else:
        plain, kernel = K.paged_prefill_attention_quantized, K.paged_prefill_attention
    got = plain(q, p["k"], p["v"], p["k_scale"], p["v_scale"], tbl, lens)
    ref = kernel(q, p["k_fp32"], p["v_fp32"], tbl, lens)
    shifted = plain(q, p["k"], p["v"], torch.roll(p["k_scale"], 1, dims=1), p["v_scale"], tbl, lens)
    torch.cuda.synchronize()
    assert _err(got, ref) < TOL[torch.float32]
    assert _err(shifted, ref) > TOL[torch.float32], "the control (scales one row off) passes"
    with pytest.raises(ValueError, match="quantized pools need scales"):
        kernel(q, p["k"], p["v"], tbl, lens)


@pytest.mark.gpu
def test_cuda_spill_restore_round_trip():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from repro_torch.serving import SpillPool, gather_block_rows, restore_block_rows

    L, N, bs, KV_, hd, nb = 2, 12, 32, 16, 128, 8
    g = torch.Generator(device="cuda").manual_seed(9)
    cache = {n: torch.randn((L, N, bs, KV_, hd), generator=g, device="cuda").bfloat16() for n in ("k", "v")}
    src, dst = 3, 10
    pool = SpillPool(1 << 30, mode="cache", staging_depth=0)
    h = pool.put(gather_block_rows(cache, src))
    assert pool.stats()["staged"] == 0 and pool._payload[h]["k"].device.type == "cpu"
    rows = pool.pop(h)
    restore_block_rows(cache, torch.tensor([dst], dtype=torch.int32), {n: t[:, None] for n, t in rows.items()})
    for n in cache:
        assert torch.equal(cache[n][:, dst], cache[n][:, src]), n
    q = torch.randn((1, 40, 16, hd), generator=g, device="cuda")
    start = torch.tensor([200], dtype=torch.int32, device="cuda")
    base = torch.arange(1, 1 + nb, dtype=torch.int32, device="cuda")[None]  # block src at index 2
    moved = base.clone()
    moved[0, src - 1] = dst
    near = base.clone()
    near[0, src - 1] = dst + 1  # the neighbouring block: the control
    out = {name: K.paged_prefill_attention(q, cache["k"][0], cache["v"][0], t, start)
           for name, t in (("base", base), ("moved", moved), ("near", near))}
    torch.cuda.synchronize()
    assert torch.equal(out["moved"], out["base"])
    assert not torch.equal(out["near"], out["base"])


@pytest.mark.gpu
def test_cuda_async_engine_streams_the_drained_tokens():
    """``AsyncEngine`` over a fused smoke engine on the card: every step on
    its one stepping thread (which captures and replays the graphs), the
    streamed tokens equal a closed-loop drain's, and the replays ran K1
    and K2."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    import asyncio

    from repro_torch.models import init_params
    from repro_torch.serving import AsyncEngine, InferenceEngine

    cfg = reduce_for_smoke(get_config("olmo-1b"))
    params = init_params(cfg, 0, device="cuda")
    kw = dict(max_batch=4, max_seq=128, block_size=16, prefill_budget=16, fused=True, eos_token=1 << 30)
    prompts = [[5 + i, 9, 12, 7, 3, 11, 2, 8, 40 + i] + list(range(60, 60 + 3 * i)) for i in range(6)]
    ref = InferenceEngine(cfg, params, **kw)
    reqs = [ref.submit(p, max_new_tokens=12) for p in prompts]
    ref.run_until_drained()
    eng = InferenceEngine(cfg, params, **kw)

    async def go():
        async with AsyncEngine(eng) as aeng:
            outs = await asyncio.gather(*(aeng.generate(p, max_new_tokens=12) for p in prompts))
            return outs, set(aeng.step_threads)

    outs, threads = asyncio.run(go())
    assert [toks for _, toks in outs] == [r.generated for r in reqs]
    assert all(final.reason == "length" for final, _ in outs)
    assert len(threads) == 1 and "MainThread" not in threads
    s = eng.stats()
    assert s["graph_launches"]["paged_decode"] > 0 and s["graph_launches"]["paged_prefill"] > 0
    assert s["alloc_blocks_in_use"] == 0


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["qwen3-moe-235b-a22b", "arctic-480b"])
def test_cuda_moe_engine_matches_the_cpu(arch):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from repro_torch.models import init_params
    from repro_torch.serving import InferenceEngine
    from repro_torch.utils.tree import tree_map

    cfg = reduce_for_smoke(get_config(arch))
    cfg = cfg.replace(moe=dataclasses.replace(cfg.moe, capacity_factor=8.0))
    params = init_params(cfg, 0, device="cuda")
    kw = dict(max_batch=4, max_seq=128, block_size=16, prefill_budget=16, eos_token=1 << 30,
              cache_dtype=torch.float32)
    prompts = [[5 + i, 9, 12, 7, 3, 11, 2, 8, 40 + i] + list(range(60, 60 + 3 * i)) for i in range(6)]
    ref = InferenceEngine(cfg, tree_map(lambda t: t.cpu(), params), device="cpu", **kw)
    ref_reqs = [ref.submit(p, max_new_tokens=10) for p in prompts]
    ref.run_until_drained()
    want = [r.generated for r in ref_reqs]
    for fused in (False, True):
        K.reset_launches()
        eng = InferenceEngine(cfg, params, fused=fused, **kw)
        reqs = [eng.submit(p, max_new_tokens=10) for p in prompts]
        eng.run_until_drained()
        assert [r.generated for r in reqs] == want, f"fused={fused}"
        s = eng.stats()
        ran = s["graph_launches"] if fused else K.LAUNCHES
        assert ran["paged_decode"] > 0 and ran["paged_prefill"] > 0, (fused, ran)
        assert s["alloc_blocks_in_use"] == 0


# K1 at hymba-1.5b's heads: (H, KV, hd, window, lengths, table width)
HYMBA_K1_CASES = {
    "smoke": (5, 1, 16, 32, [5, 40, 70, 100], 6),
    "full": (25, 5, 64, 1024, [77, 300, 1100, 1400], 48),
}


@pytest.mark.gpu
@pytest.mark.parametrize("q_dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("case", list(HYMBA_K1_CASES))
def test_cuda_decode_hymba_heads_past_the_window(case, q_dtype):
    """K1 on bf16 pools at hymba's heads, two or three slots past the
    window (whole blocks skipped), against the plain version: the split it
    picks and every forced cluster size, within the K1 limits."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    H, KV_, hd, window, lens, nb = HYMBA_K1_CASES[case]
    lens = torch.tensor(lens, dtype=torch.int32)
    q, kp, vp, tbl = _gpu_inputs(H, KV_, hd, (len(lens), H, hd), lens - 1, q_dtype, nb=nb)
    lens = lens.cuda()
    ref = paged_attention_plain(q, kp, vp, tbl, lens, window=window)
    before = K.LAUNCHES["paged_decode"]
    outs = [K.paged_attention(q, kp, vp, tbl, lens, window=window)]
    outs += [K._decode_launch(q, kp, vp, tbl, lens, split=split, window=window) for split in range(1, 9)]
    torch.cuda.synchronize()
    assert K.LAUNCHES["paged_decode"] == before + 9
    for out in outs:
        assert out.dtype == q_dtype and bool(torch.isfinite(out).all())
        assert _err(out, ref) < TOL[q_dtype]
    # the window binds: without it the rows differ
    assert _err(paged_attention_plain(q, kp, vp, tbl, lens), ref) > TOL[q_dtype]


@pytest.mark.gpu
@pytest.mark.parametrize("arch,kind", [("hymba-1.5b", "paged"), ("hymba-1.5b", "dense"), ("rwkv6-7b", "dense")])
def test_cuda_recurrent_engine_matches_the_cpu(arch, kind):
    """Smoke hymba (window 32, prompts past it) and rwkv6-7b served on the
    card and on CPU tensors over fp32 caches: equal greedy tokens, every
    request by length, no block left; the paged hymba engine runs K1 once a
    layer a decode step."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from repro_torch.models import init_params
    from repro_torch.serving import InferenceEngine
    from repro_torch.utils.tree import tree_map

    cfg = reduce_for_smoke(get_config(arch))
    params = init_params(cfg, 0, device="cuda")
    kw = dict(max_batch=3, max_seq=96, block_size=16, cache_kind=kind, eos_token=1 << 30, cache_dtype=torch.float32)
    prompts = [[5 + i, 9, 12, 7, 3, 11, 2, 8, 40 + i] + list(range(60, 60 + 7 * i)) for i in range(6)]
    ref = InferenceEngine(cfg, tree_map(lambda t: t.cpu(), params), device="cpu", **kw)
    ref_reqs = [ref.submit(p, max_new_tokens=10) for p in prompts]
    ref.run_until_drained()
    K.reset_launches()
    eng = InferenceEngine(cfg, params, **kw)
    reqs = [eng.submit(p, max_new_tokens=10) for p in prompts]
    eng.run_until_drained()
    assert [r.generated for r in reqs] == [r.generated for r in ref_reqs]
    assert all(r.finish_reason == "length" for r in reqs)
    s = eng.stats()
    assert s["cache_kind"] == kind
    if kind == "paged":
        assert s["alloc_blocks_in_use"] == 0
        assert K.LAUNCHES["paged_decode"] == cfg.num_layers * s["decode_steps"] > 0
    else:
        assert K.LAUNCHES["paged_decode"] == 0


@pytest.mark.gpu
def test_cuda_vlm_engine_matches_the_cpu():
    """Smoke llama-3.2-vision-90b with two layer groups, its cross gates
    open (1.0) and random K/V biases, so that the engine's zero image tokens
    project to nonzero image K/V: served on the card and on CPU tensors over
    fp32 caches, equal greedy tokens, every request by length, no kernel
    launched (the dense ring attends in PyTorch ops), the image K/V of every
    slot zero after the drain."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from repro_torch.models import init_params
    from repro_torch.serving import InferenceEngine
    from repro_torch.utils.tree import tree_map

    cfg = reduce_for_smoke(get_config("llama-3.2-vision-90b")).replace(num_layers=10, use_bias=True)
    params = init_params(cfg, 0, device="cuda")
    g = torch.Generator(device="cuda").manual_seed(1)
    for group in params["blocks"]:
        group["cross"]["attn"]["gate"].fill_(1.0)
        group["cross"]["gate_mlp"].fill_(1.0)
        for name in ("bk", "bv"):
            group["cross"]["attn"][name].normal_(0.0, 0.5, generator=g)
    kw = dict(max_batch=3, max_seq=96, eos_token=1 << 30, cache_dtype=torch.float32)
    prompts = [[5 + i, 9, 12, 7, 3, 11, 2, 8, 40 + i] + list(range(60, 60 + 7 * i)) for i in range(6)]
    ref = InferenceEngine(cfg, tree_map(lambda t: t.cpu(), params), device="cpu", **kw)
    ref_reqs = [ref.submit(p, max_new_tokens=10) for p in prompts]
    ref.run_until_drained()
    K.reset_launches()
    eng = InferenceEngine(cfg, params, **kw)
    reqs = [eng.submit(p, max_new_tokens=10) for p in prompts]
    eng.run_until_drained()
    assert [r.generated for r in reqs] == [r.generated for r in ref_reqs]
    assert all(r.finish_reason == "length" for r in reqs)
    assert eng.stats()["cache_kind"] == "dense" and not any(K.LAUNCHES.values())
    assert not bool(eng.cache["cross"]["ck"].any()) and not bool(eng.cache["cross"]["cv"].any())
