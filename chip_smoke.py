#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one NVIDIA card and check what comes out.

Run from the repository root with no arguments: ``python3 chip_smoke.py``.
It needs one CUDA card and exits non-zero, printing no result, without one
or when any check fails.  Phases:

1. Card and build: the card's name and power limit, its board power
   before any work (ten ``nvidia-smi`` readings), the torch and CUDA
   versions, then ``nvcc`` builds the five sources of
   ``src/repro_torch/kernels/csrc`` for ``sm_90a``, all started together,
   with the seconds each took; then the count of HGMMA (``wgmma``)
   instructions in each kernel of K4, K3 and K2 and of HMMA (``mma.sync``)
   in K5's (``cuobjdump -sass``): each of K4's four kernels, K3's four bf16
   kernels, K2's eight tensor-core kernels and K5's nine chunk kernels (one
   per head size and chunk) must hold some.
2. Kernels: K1 (paged decode) and K2 (chunked prefill) against their plain
   PyTorch versions on the card, bf16 pools, fp32 and bf16 queries, at the
   head shapes of olmo-1b, mistral-nemo-12b and gemma-7b, block size 32,
   random block tables with null padding and ragged lengths, plus one
   sliding-window and one softcap case, and for K2 the short and ragged
   chunks serving runs (C = 1 and 16 at 192, C = 40 at 200) and the
   speculative verify window (C = spec_k + 1 = 5 at 192, 203 and 221).  Each case
   names the kernel it runs (``route``: K2's bf16 pools run on the tensor
   cores; K1 splits each walk over a cluster of up to 8 blocks, ``split``
   the size it picked), reads the max error against ``TOL``, the mean error and
   (reported only) the signed bias, and a control that must fail ``TOL``
   (fp32 queries: q rounded to one bf16 term; bf16 queries: the causal
   mask off by one); K1 and K2 cases also time v1 (the CUDA-core
   yardstick) and the kernel without its cluster split (the cluster size
   the kernel picked beside it), and read the host time of one call for
   both.  Then K3 (flash attention forward)
   at olmo-1b's training shape and GQA, window, softcap, fp32, ragged, head
   dim 80 and 160 and no-key (Sq > Skv with a window) cases, each naming
   the kernel its dtype runs (``route``), with SDPA's errors and the
   CUDA-core kernel's time on the bf16 inputs beside the tensor-core
   kernel's, and K4 (FP8 GEMM) at the forward and backward shapes of
   olmo-1b's training step and a ragged case, each with a control (the
   plain GEMM without its last 32 k-elements), ``torch._scaled_mm``'s error
   and the wrapper's layout copies.  One JSON line per case with the error, the kernel's,
   the plain version's and the library's time, and the case's bound.  K3
   is also run on the model's strided layout, and each K3 case computes a
   control (the plain version with one fault) that its checks must reject.
   Kernel times are device times: the timed calls are queued behind a
   device sleep, so the host's enqueue does not set them.  Each kernel's
   row also reads ``kernel_enqueue_ms``, the calls timed back to back with
   nothing queued ahead, where a wrapper slower on the host than its
   kernel on the device sets the time, as on the serving path (the
   ``kernels`` line's ``enqueue_ms``).  K2's bound on the tensor cores
   counts its bf16 products at the bf16 rate, two terms of fp32 q and of P.
3. Serving: the engine serves 8 greedy requests on the full-width olmo-1b
   (random weights from a seed) with bf16 pools, block size 32, 4 slots,
   a 128-token prefill budget and the prefix cache.  The launch counters
   are set to 0 just before the run and read just after.
4. Kernel path against plain path at full width: two prefill chunks and a
   decode step on olmo-1b with ``attn_impl="kernel"`` and ``"plain"``.
5. Profile: one 4-slot decode step of olmo-1b, its wall time, its device
   time by kernel under ``torch.profiler`` and the device's idle share.
5b. Fused serving: the serving phase's engine, prompts and settings with
   ``fused=True``: each tick one CUDA-graph replay (``serving/graphs.py``)
   and one host sync.  The same engine first serves prompts from another
   seed, untimed, which captures the (rows, width) buckets the traffic
   uses; then the timed run reads TTFT, TPOT, tokens/s, dispatches and
   host syncs per step, the graphs captured in each run and their capture
   time, the graph pool's bytes and peak memory, and the K1/K2 launches
   the replays ran (their counts set to 0 just before the timed run).  It
   fails unless every request finishes by length, the replays ran K1 and
   K2, and a step takes at most 1.5 dispatches.  Each request's tokens are
   held against the serving phase's: at the first position where they
   differ, the legacy tokens' top-2 logit gap there (recomputed through
   ``prefill_step``) must be below ``PATH_TOL``, a near-tie, since mixed
   ticks run decode rows through K2 rather than K1.
5c. Fused profile: one fused pure-decode tick (staging, replay, one host
   sync) at the profile phase's lengths, its wall time and, under
   ``torch.profiler``, its device time, idle share and the launches the
   profiler sees, beside the eager ``decode_step`` and the eager tick
   (``decode_step``, argmax, host sync) in the same run.
5d. Speculative serving (``spec_k = 4``), the serving phase's engine,
   prompts and settings in four runs: (a) the legacy walk with the n-gram
   drafter; (b) the same with ``fused=True`` after an untimed run of
   prompts from another seed; (c) the legacy walk with the target as its
   own drafter on the first two prompts; (d) its control, a half-depth
   draft of random weights from another seed, on the same two.  Each reads
   TTFT, TPOT, output tokens/s, steps, dispatches and host syncs a step,
   acceptance rate, tokens per verify, drafted and accepted tokens and the
   K1/K2 launches (counts set to 0 just before each timed run), (b) also
   its graphs and their pool.  It fails unless every request finishes by
   length, K2 ran in every run (in (b) inside replays) and K1 in neither
   (a) nor (b), (b) takes at most 1.5 dispatches a step and captures no
   graph while timed, the tokens of (a)-(c) differ from the serving
   phase's only at near-ties, and (c) accepts at least 0.8 of its drafts
   while (d) accepts fewer.
5e. Speculative rollback: one verify step of 4 slots at the profile
   phase's lengths whose drafts cannot match (each slot's least likely
   token),
   eagerly and as one replay of the fused spec graph: the rejected rows
   must read zero, the history must be unchanged and the committed row
   within one bf16 spacing (of its largest element) of what a plain
   decode step writes; the pools with no rollback and with the rollback
   one lane early are the controls that must fail.
5f. KV-cache tiers: ``kv_quant_read`` holds the plain dequantizing read
   of int8 and e4m3 pools (quantized pools have no kernel, as in the JAX
   package) against K1 and K2 over fp32 pools that hold the same
   dequantized rows, at the kernel phase's olmo-1b shapes, within
   ``TOL[fp32]``, with scales one token row off as the control, and times
   both; ``serving_quantized`` serves the serving phase's prompts with
   ``quantize_kv="int8"`` and ``"fp8"`` in both walks (no K1/K2 launch;
   the fused tokens within near-ties of the legacy run's; pool bytes,
   TTFT, TPOT, decode ticks and agreement with the bf16 run read) and
   profiles an eager quantized decode step; ``serving_tiered`` serves two
   rounds of 8 prompts that share 256-token prefixes round to round over
   48 usable blocks, with the host spill tier (also with a restore budget
   of 32 blocks a pass), with dropped evictions and without a prefix cache
   (legacy walk; tokens must be equal), and with
   and without the tier in the fused walk (within near-ties), gated on
   spills, restores and spill-tier hits; ``spill_restore`` sends one block
   of a full-width bf16 pool through host memory and back into another
   block (rows and K2 over it bit-equal; a restore into the neighbouring
   block is the control) and times the copies.
5g. Fig. 9 (``fig9``): ``repro_torch.benchmarks.llm_inference``'s
   closed-loop arms at full width: the dense slot cache (4 slots,
   max_seq 512) against the paged pool at the same cache bytes (block 32,
   64 blocks, 16 slots) on 16 requests of 64-320 prompt tokens and 32 new
   tokens; the shared-system-prompt A/B (a 96-token system prompt, 8-token
   tails, prefix cache off / on); speculative decoding off / n-gram /
   self-draft on the repetitive-suffix prompts; a profiled run of each
   cache kind (``profile=True``) and the fused arm (legacy and fused).
   Each arm prints TTFT and TPOT p50/p99, output tokens/s, decode steps
   and tick, ``peak_active``, cache bytes, peak blocks, prefill tokens,
   hit rate, acceptance, tokens per verify, joules per token (the H100
   power model of ``core.telemetry``) and the profiled phases' seconds;
   then one 4-slot decode step over the dense ring and over the paged
   pools under ``torch.profiler``, as the profile phase.
   It fails unless the dense cache has ``models.cache_bytes`` and the
   paged one no more, dense and paged (and fused and legacy) tokens agree
   up to near-ties (``FIG9_TIE_TOL``; a dense engine whose admitted rings
   sit one slot off is the control that must differ away from one), the
   prefix cache at least halves prefill tokens, the
   self-draft emits more than one token per slot-step, no block stays in
   use, K1 and K2 ran, profiling leaves the tokens as they were and the
   requests' joules sum to the engine's.
5h. Front-ends (``frontend``, ``router``), each on fresh fused engines with
   the serving_fused phase's settings.  ``frontend``: ``serve_http`` on a
   loopback port over an ``AsyncEngine`` (its steps on one stepping
   thread) serves the serving phase's 8 prompts to 8 concurrent SSE
   clients (32 new tokens), one ``"stream": false`` request and one
   client that drops its socket after its first token, while ``/stats``,
   ``/metrics`` and ``/healthz`` are polled as the engine captures its
   graphs; then a graceful drain with requests in flight.  It reads the
   clients' TTFT and TPOT (from the frames' arrival), the engine's,
   dispatches a step, mixed and decode ticks, graphs, K1/K2 launches in
   replays and the stepping thread, and fails unless every stream is contiguous and ends by
   length, the tokens equal the serving phase's up to near-ties, the
   dropped request is cancelled, polls answer 200, ``/healthz`` and a new
   request get 503 while draining, no block stays in use and one thread
   ran every step.  ``router``: the Fig. 9 harness's ``run_router`` (1
   replica; 2 with affinity; 2 random; 2 with replica 0 crashed mid-run)
   on tenant prompts with 96-token system prompts, with the reference's
   gates and tokens up to near-ties; a router that resumes a failed-over
   request one position off is the control the token gate must reject;
   then a 2-replica router behind ``serve_http`` serves 4 SSE requests.
   Each arm reads modelled and wall tokens/s, hit rate, failovers,
   retries, replica states and peak memory.
6. Train: FP8 training of olmo-1b at full width and depth (fp32 master
   weights, bf16 compute, K4 for every projection GEMM, remat per block),
   4 steps of 4 x 2048 tokens from random weights (seed 0), with the loss,
   time, tokens/s and K4 launches of every step, peak memory and model
   FLOP/s.  The counters are set to 0 just before the steps.
7. Train path: one more step from the same state with K4 in which every
   K4 call is held against the plain GEMM, with a control (the plain GEMM
   without its last 32 k-elements), on its own operands; and whole steps
   with the plain GEMM, a control (the plain GEMM with its inverse scale
   rounded to bf16) and an order probe (the plain GEMM's sums in another
   order), compared with the kernel step by loss, gradient norm and two
   updated tensors, against limits that the control must fail.
8. Eval: ``loss_fn`` with ``attn_impl="flash"`` (K3) against ``"torch"``
   under ``torch.no_grad()`` on the train batch, each timed once cold and
   once warm, and a control (attention that also sees the next key) that
   the limits must reject.
9. Train profile: one train step without and one under ``torch.profiler``:
   wall time, device time by kernel and the device's idle share.
10. Kernels K6 (BabelStream) and K5 (RWKV6 WKV scan), run after phase 2:
   copy, mul, add and triad at n = 2^27 in fp32 and bf16, bit-equal to
   their plain versions, and dot on non-negative inputs, each beside its
   PyTorch call; K5 at rwkv6-7b's eval shape, at a small shape and with
   fast decay, against its plain version and the sequential oracle (max
   and mean error), with v1 (the yardstick) timed and checked beside it.
   Each check computes a control (triad with the scalar left unrounded,
   dot without its last tile, the scan with the decay one step late) that
   it must reject.
11. BabelStream: ``repro_torch.benchmarks.babelstream.run()``, the entry
   point of the paper's Fig. 10, on the card in fp32 (the counters set to 0
   just before, read just after) and in bf16.
12. RWKV eval, once the olmo-1b state is freed: rwkv6-7b at full width and
   depth (random fp32 weights from seed 0, bf16 compute), ``loss_fn`` on
   4 x 2048 synthetic tokens under ``torch.no_grad()`` with
   ``wkv_impl="kernel"`` (K5, one launch per layer) and ``"chunked"``,
   with a chaos probe (1e-6 noise on the plain scan's outputs); then every
   layer, in bf16 and in fp32 compute, on the chunked forward's own input
   with K5, the chunked scan and a control (the late-decay scan) that the
   limits must reject.

It then prints one ``{"kernels": [...]}`` line and, last,
``{"ok": true, "device": {...}}``.  Every time is measured on the card in
this run; every bound is computed from this run's inputs against the
H100 SXM's published peaks.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time
import warnings
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch
import torch.nn.functional as F

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

HBM_BYTES_PER_S = 3.35e12  # H100 SXM memory rate
FP32_FLOPS_PER_S = 67e12  # H100 SXM fp32 on the CUDA cores (the kernels' math)
# H100 SXM special-function units: 16 exponentials per SM per clock, 132 SMs
# at the 1.98 GHz boost clock
EXP_PER_S = 16 * 132 * 1.98e9
BF16_FLOPS_PER_S = 989e12  # H100 SXM dense bf16 tensor cores
FP8_FLOPS_PER_S = 1979e12  # H100 SXM dense fp8 tensor cores
BLOCK_SIZE = 32
SEED = 0

# error tolerances against the plain version.  Both read the same bf16 K/V
# and compute in fp32, so with fp32 queries only the summation order
# differs; with bf16 queries both round the output to bf16, 2^-7 relative.
TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
# logits of the full-width model, kernel path against plain path: each
# layer's K/V is rounded to bf16 from activations that differ in the last
# fp32 bits, so a few elements per layer move by one bf16 ulp, and this
# compounds over 16 layers; logits have a standard deviation near 1
PATH_TOL = 2e-2

# (model, H, KV, hd) head shapes of the three dense configurations
HEAD_SHAPES = [("olmo-1b", 16, 16, 128), ("mistral-nemo-12b", 32, 8, 128), ("gemma-7b", 16, 16, 256)]
DECODE_LENS = [77, 160, 291, 352]  # four slots, as the serving phase decodes
PREFILL_START, PREFILL_C = 192, 128  # one 128-token chunk after 192 tokens of history
NB = 16  # table width: max_seq 512 / block size 32


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def bound(nbytes: float, flops: float, rate: float) -> tuple[float, str]:
    """(least time in ms, what bounds it) for ``nbytes`` moved and ``flops``
    done at ``rate``."""
    t_b, t_f = nbytes / HBM_BYTES_PER_S, flops / rate
    return 1e3 * max(t_b, t_f), "bytes" if t_b >= t_f else "operations"


CLOCK_HZ = 1.98e9  # H100 SXM boost clock: a device sleep of n cycles lasts at least n / CLOCK_HZ s


def timed_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean device time of ``fn(i)`` over ``iters`` calls, by CUDA events.
    The calls are queued behind a device sleep longer than their host time,
    so the events time the device's work back to back, not the host's
    enqueue (``enqueue_ms`` and ``host_us`` read that)."""
    for i in range(warmup):
        fn(i)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn(0)
    host_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    torch.cuda._sleep(int(CLOCK_HZ * min(1.5 * iters * host_s + 1e-3, 0.5)))
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(iters):
        fn(i)
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def enqueue_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean time of ``fn(i)`` over ``iters`` calls issued back to back by the
    host, by CUDA events with nothing queued ahead: the device time where
    the device is the slower side, else the host's rate of issue, which is
    what a caller such as the serving loop pays per call."""
    for i in range(warmup):
        fn(i)
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(iters):
        fn(i)
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def kernel_times(fn, iters: int = 20, warmup: int = 3) -> dict:
    """A kernel's two readings: device time (``kernel_ms``) and the time per
    call at the host's rate of issue (``kernel_enqueue_ms``)."""
    return {"kernel_ms": timed_ms(fn, iters, warmup), "kernel_enqueue_ms": enqueue_ms(fn, iters, warmup)}


def host_us(fn, iters: int = 30) -> float:
    """Median host time of one ``fn(i)`` call with the device idle: the
    wrapper's checks, allocation, argument packing and launch."""
    walls = []
    for i in range(iters):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn(i)
        walls.append(time.perf_counter() - t0)
    torch.cuda.synchronize()
    return 1e6 * float(np.median(walls))


# ---------------------------------------------------------------------------
# phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------


def kernel_case(kind, H, KV, hd, q_dtype, window, softcap, device, layers=16, seed=0, C=PREFILL_C, start=PREFILL_START):
    """Inputs of one case.  ``layers`` pools are made so that timing loops
    can read a different layer's pool each call, as the model does; their
    total exceeds the 50 MB L2 cache.  Prefill: one C-token chunk at
    ``start``."""
    g = torch.Generator().manual_seed(seed)
    B = len(DECODE_LENS) if kind == "decode" else 1
    N = 1 + B * NB + 2
    last = [n - 1 for n in DECODE_LENS] if kind == "decode" else [start + C - 1]
    tbl = (torch.randperm(N - 1, generator=g)[: B * NB] + 1).reshape(B, NB).to(torch.int32)
    for b in range(B):
        tbl[b, last[b] // BLOCK_SIZE + 1 :] = 0  # null padding past the live blocks
    pools = [torch.randn((layers, N, BLOCK_SIZE, KV, hd), generator=g).to(torch.bfloat16) for _ in range(2)]
    if kind == "decode":
        q = torch.randn((B, H, hd), generator=g)
        lens = torch.tensor(DECODE_LENS, dtype=torch.int32)
    else:
        q = torch.randn((B, C, H, hd), generator=g)
        lens = torch.tensor([start], dtype=torch.int32)
    to = lambda t: t.to(device)  # noqa: E731
    return dict(
        kind=kind, H=H, KV=KV, hd=hd, window=window, softcap=softcap, q=to(q.to(q_dtype)), C=C, start=start,
        k=to(pools[0]), v=to(pools[1]), tbl=to(tbl), lens=to(lens), layers=layers,
    )


def case_work(c) -> tuple[int, int]:
    """(bytes, multiply-adds of one product) the case needs: each input read
    once, each output written once, K/V only at the positions some query
    can see; Q K^T and P V each take the multiply-adds returned."""
    H, KV, hd, w = c["H"], c["KV"], c["hd"], c["window"]
    q_bytes = c["q"].numel() * c["q"].element_size()
    kv_row = KV * hd * c["k"].element_size() * 2  # K and V of one position
    meta = c["tbl"].numel() * 4 + c["lens"].numel() * 4
    if c["kind"] == "decode":
        vis = [min(n, w) if w else n for n in DECODE_LENS]
        kv_rows, pairs = sum(vis), sum(vis)
    else:
        start, C = c["start"], c["C"]
        lo = max(0, start - w + 1) if w else 0
        kv_rows = start + C - lo
        pairs = sum(min(start + i + 1, w) if w else start + i + 1 for i in range(C))
    return 2 * q_bytes + kv_rows * kv_row + meta, pairs * H * hd


def library_call(c, attend):
    """``F.scaled_dot_product_attention`` on the gathered, head-expanded view
    of every layer (built here, outside the timing), or None when SDPA
    cannot compute the function (softcap).  Used only as a yardstick."""
    if c["softcap"]:
        return None
    from repro_torch.kernels.paged_attention_ref import gather_blocks

    q, qpk = c["q"], c["H"] // c["KV"]
    S = NB * BLOCK_SIZE
    kv_pos = torch.arange(S, device=q.device)
    if c["kind"] == "decode":
        qq = q[:, :, None]  # (B, H, 1, hd)
        q_pos = (c["lens"].long() - 1)[:, None]  # (B, 1)
    else:
        qq = q.transpose(1, 2)  # (B, H, C, hd)
        q_pos = c["lens"].long()[:, None] + torch.arange(c["C"], device=q.device)[None]  # (B, C)
    ok = kv_pos[None, None] <= q_pos[..., None]
    if c["window"]:
        ok &= (q_pos[..., None] - kv_pos[None, None]) < c["window"]
    mask = ok[:, None]  # (B, 1, Sq, S)
    views = [
        [gather_blocks(pool[layer], c["tbl"]).to(q.dtype).repeat_interleave(qpk, dim=2).transpose(1, 2) for pool in (c["k"], c["v"])]
        for layer in range(c["layers"])
    ]
    ref = attend(0)

    def call(i):
        k, v = views[i % c["layers"]]
        return F.scaled_dot_product_attention(qq, k, v, attn_mask=mask)

    out = call(0)
    out = out[:, :, 0] if c["kind"] == "decode" else out.transpose(1, 2)
    return call, float((out.float() - ref.float()).abs().max())


# K1 / K2 cases: model, (H, KV, hd), q dtype, window, softcap, and for K2
# the chunk (C, start): the three head shapes in both q dtypes, a sliding
# window and a softcap case at the serving chunk, then the short and
# ragged chunks serving runs (C = 1 and 16 at 192; C = 40 at 200, rows not
# a multiple of 64 and a start inside a block)
KERNEL_CASES = [(m, (H, KV, hd), dt, 0, 0.0) for (m, H, KV, hd) in HEAD_SHAPES for dt in (torch.float32, torch.bfloat16)]
KERNEL_CASES += [("mistral-nemo-12b", (32, 8, 128), torch.float32, 32, 0.0), ("gemma-7b", (16, 16, 256), torch.float32, 0, 30.0)]
PREFILL_CASES = [(*case, (PREFILL_C, PREFILL_START)) for case in KERNEL_CASES]
PREFILL_CASES += [("olmo-1b", (16, 16, 128), torch.float32, 0, 0.0, chunk) for chunk in ((1, 192), (16, 192), (40, 200))]
# the speculative verify window, C = spec_k + 1 = 5: at a block's first
# position, mid-block, and across a block edge
PREFILL_CASES += [("olmo-1b", (16, 16, 128), torch.float32, 0, 0.0, (5, start)) for start in (192, 203, 221)]


def case_bound(c, route: str) -> tuple[float, str]:
    """The case's bound on its route.  The CUDA-core kernels do the two
    products in fp32 at the fp32 rate; the tensor-core route does them as
    bf16 products at the bf16 rate, Q K^T once per bf16 term of q (two for
    fp32 queries) and P V once per term of P (two)."""
    nbytes, macs = case_work(c)
    if route == "tensor_cores_bf16":
        q_terms = 2 if c["q"].dtype == torch.float32 else 1
        return bound(nbytes, 2 * macs * (q_terms + 2), BF16_FLOPS_PER_S)
    return bound(nbytes, 2 * macs * 2, FP32_FLOPS_PER_S)


def kernel_control(c, plain, kw):
    """The plain version with one fault, which the limit must reject: for
    fp32 queries q rounded to one bf16 term (what the tensor-core route
    would read without its split), for bf16 queries the causal mask off by
    one (each row also sees q_pos + 1)."""
    if c["q"].dtype == torch.float32:
        return "q_bf16", plain(c["q"].bfloat16().float(), c["k"][0], c["v"][0], c["tbl"], c["lens"], **kw)
    return "mask_plus_one", plain(c["q"], c["k"][0], c["v"][0], c["tbl"], c["lens"] + 1, **kw)


def kernel_phase(device) -> dict:
    from repro_torch.kernels import paged_attention as K
    from repro_torch.kernels.flash_attention_ref import flash_errors
    from repro_torch.kernels.paged_attention_ref import paged_attention_plain, paged_prefill_attention_plain

    fns = {"decode": (K.paged_attention, paged_attention_plain), "prefill": (K.paged_prefill_attention, paged_prefill_attention_plain)}
    main = {}  # per kernel: the serving path's case (olmo-1b, fp32 queries, the 128-token chunk)
    for kind in ("decode", "prefill"):
        kernel, plain = fns[kind]
        cases = KERNEL_CASES if kind == "decode" else PREFILL_CASES
        for seed, (model, (H, KV, hd), dt, window, cap, *chunk) in enumerate(cases):
            C, start = chunk[0] if chunk else (PREFILL_C, PREFILL_START)
            c = kernel_case(kind, H, KV, hd, dt, window, cap, device, seed=seed, C=C, start=start)
            kw = dict(softcap=cap, window=window)

            def run(fn, i, c=c, kw=kw, **extra):
                layer = i % c["layers"]
                return fn(c["q"], c["k"][layer], c["v"][layer], c["tbl"], c["lens"], **kw, **extra)

            out, ref = run(kernel, 0), run(plain, 0)
            torch.cuda.synchronize()
            errs = flash_errors(out, ref)
            control_name, control_out = kernel_control(c, plain, kw)
            control = flash_errors(control_out, ref)
            del out, control_out
            tol = TOL[dt]
            lib = library_call(c, lambda i: run(plain, i))
            route = K.DECODE_ROUTE if kind == "decode" else K.prefill_route(dt, c["k"].dtype)
            bound_ms, bound_by = case_bound(c, route)
            row = {
                "phase": "kernel", "kernel": f"paged_{kind}", "model": model, "q_dtype": str(dt).replace("torch.", ""),
                "route": route,
                "window": window, "softcap": cap, "max_abs_err": errs["max_abs"], "tol": tol,
                "mean_rel": errs["mean_rel"], "mean_bias": errs["mean_bias"],  # the bias is reported only
                "control": control_name, "control_max_abs_err": control["max_abs"],
                **kernel_times(lambda i: run(kernel, i)),
                "plain_ms": timed_ms(lambda i: run(plain, i)),
                "library_ms": timed_ms(lib[0]) if lib else None,
                "library_max_abs_err": lib[1] if lib else None,
                "bound_ms": bound_ms, "bound_by": bound_by,
            }
            if kind == "prefill":
                cuda_cores, launch = K.paged_prefill_attention_cuda_cores, K._prefill_launch
                split = K._prefill_split(c["q"], c["k"][0], c["tbl"], softcap=cap, window=window)
                row.update(C=C, start=start)
            else:
                cuda_cores, launch = K.paged_attention_cuda_cores, K._decode_launch
                split = K._decode_split(c["q"], c["k"][0], c["tbl"], window=window)
            v1_err = float((run(cuda_cores, 0).float() - ref.float()).abs().max())
            row.update(
                split=split,
                # the kernel without the cluster split, and v1 (the yardstick) on the same inputs
                split1_ms=timed_ms(lambda i: run(launch, i, split=1)),
                cuda_cores_ms=timed_ms(lambda i: run(cuda_cores, i)), cuda_cores_max_abs_err=v1_err,
                host_us=host_us(lambda i: run(kernel, i)), cuda_cores_host_us=host_us(lambda i: run(cuda_cores, i)),
            )
            emit(row)
            del ref
            if not errs["max_abs"] < tol:
                fail(f"{row['kernel']} {model} {row['q_dtype']} window={window} softcap={cap}: err {errs['max_abs']} >= {tol}")
            if not control["max_abs"] > tol:
                fail(f"{row['kernel']} {model} {row['q_dtype']}: the control {control_name} passes "
                     f"({control['max_abs']} <= {tol}), which then proves nothing")
            if not row["cuda_cores_max_abs_err"] < tol:
                fail(f"paged_{kind}_cuda_cores {model} {row['q_dtype']}: err {row['cuda_cores_max_abs_err']} >= {tol}")
            if model == "olmo-1b" and dt == torch.float32 and f"paged_{kind}" not in main:
                main[f"paged_{kind}"] = row
            del c
    return main


# ---------------------------------------------------------------------------
# phase 3: serving at full width
# ---------------------------------------------------------------------------


def serving_prompts(cfg, seed) -> list[list[int]]:
    """8 prompts of 64-320 tokens that share a 64-token prefix."""
    rng = np.random.default_rng(seed)
    prefix = [int(t) for t in rng.integers(0, cfg.vocab_size, 64)]
    lengths = [64, 96, 128, 160, 192, 224, 288, 320]
    return [prefix + [int(t) for t in rng.integers(0, cfg.vocab_size, n - 64)] for n in lengths]


def serving_phase(cfg, params, device, max_new_tokens=32) -> dict:
    from repro_torch.kernels import paged_attention as K
    from repro_torch.utils.tree import tree_leaves
    from repro_torch.serving import InferenceEngine

    kw = dict(
        max_batch=4, max_seq=512, block_size=BLOCK_SIZE, prefill_budget=128, cache_dtype=torch.bfloat16,
        eos_token=cfg.padded_vocab, device=device,  # outside the vocab: every request runs to length
    )
    prompts = serving_prompts(cfg, SEED)
    # warm-up on a separate engine (library handles, allocator), not counted
    warm = InferenceEngine(cfg, params, **kw)
    warm.submit(prompts[0][:48], max_new_tokens=2)
    warm.run_until_drained()
    del warm

    eng = InferenceEngine(cfg, params, **kw)
    reqs = [eng.submit(p, max_new_tokens=max_new_tokens) for p in prompts]
    K.reset_launches()  # the main path's run starts here
    t0 = time.perf_counter()
    eng.run_until_drained()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(K.LAUNCHES)

    s = eng.stats()
    L = cfg.num_layers
    first_tokens = sum(1 for e in eng.tracer.events if e.name == "first_token")
    if not all(r.finish_reason == "length" and len(r.generated) == max_new_tokens for r in reqs):
        fail(f"requests did not all finish by length: {[(r.finish_reason, len(r.generated)) for r in reqs]}")
    if not (launches["paged_decode"] > 0 and launches["paged_prefill"] > 0):
        fail(f"a kernel was not launched on the main path: {launches}")
    if launches["paged_prefill"] != s["prefill_chunks"] * L or launches["paged_decode"] != s["decode_steps"] * L:
        fail(f"launches {launches} != {s['prefill_chunks']} chunks / {s['decode_steps']} decode steps x {L} layers")
    if first_tokens != len(reqs):
        fail(f"{first_tokens} first tokens from the prefill path for {len(reqs)} requests")
    if s["alloc_blocks_in_use"] != 0 or s["prefix_hit_tokens"] <= 0:
        fail(f"blocks in use {s['alloc_blocks_in_use']}, prefix hit tokens {s['prefix_hit_tokens']}")
    decode_tokens = s["tokens_out"] - len(reqs)  # the first tokens come from prefill
    h_decode = eng.metrics.histogram("engine_decode_seconds")
    tick_tokens, tick_s = decode_ticks(eng)
    out = {
        "phase": "serving", "model": cfg.name, "params": sum(t.numel() for t in tree_leaves(params)),
        "requests": len(reqs), "tokens_out": s["tokens_out"], "decode_steps": s["decode_steps"],
        "prefill_chunks": s["prefill_chunks"], "prefill_tokens": s["prefill_tokens"],
        "prefix_hit_tokens": s["prefix_hit_tokens"], "alloc_blocks_in_use": s["alloc_blocks_in_use"],
        "launches": launches, "wall_s": wall,
        "ttft_p50_s": float(np.median([r.ttft for r in reqs])),
        "tpot_p50_s": float(np.median([r.tpot for r in reqs])),
        "decode_step_p50_s": h_decode.percentile(50),
        "decode_tok_s": decode_tokens / h_decode.sum,
        "decode_tick_tok_s": tick_tokens / tick_s,
        "output_tok_s": s["tokens_out"] / wall,
        "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
        "dispatches_per_step": s["dispatches_per_step"], "host_syncs_per_step": s["host_syncs_per_step"],
        "cache_bytes": s["cache_bytes"], "pool_bytes": pool_bytes(eng),
    }
    emit(out)
    return out, [list(r.generated) for r in reqs]


def decode_ticks(eng, since: float = float("-inf")) -> tuple[int, float]:
    """(decode tokens, seconds) of the engine steps that decoded, started
    at ``since`` or later on the engine's clock, from the tracer's step
    spans (a first token is not a decode token)."""
    if eng.tracer.dropped:
        fail(f"the tracer dropped {eng.tracer.dropped} events")
    steps = [e for e in eng.tracer.events if e.name == "step" and e.ts >= since and e.args.get("produced", 0) > 0]
    return sum(e.args["produced"] for e in steps), sum(e.dur for e in steps)


def tick_kinds(eng, since: float) -> dict:
    """Count, summed and median wall of the fused engine's ticks since
    ``since``: mixed ticks (a prefill chunk rode in them) and pure-decode
    ticks, from the tracer's step spans and chunk instants."""
    events = [e for e in eng.tracer.events if e.ts >= since]
    chunks = [e.ts for e in events if e.name == "prefill_chunk"]
    out = {"mixed": [], "decode": []}
    for e in events:
        if e.name == "step":
            out["mixed" if any(e.ts <= t <= e.ts + e.dur for t in chunks) else "decode"].append(e.dur)
    return {k: {"ticks": len(v), "wall_s": sum(v), "wall_ms_p50": float(np.median(v)) * 1e3 if v else None}
            for k, v in out.items()}


def top2_gap(cfg, params, device, context, quantize_kv=False) -> float:
    """The top-2 logit gap after ``context``, through one ``prefill_step``
    (bf16 pools, or quantized ones)."""
    from repro_torch.models import init_paged_cache, prefill_step

    nb = -(-len(context) // BLOCK_SIZE)
    cache = init_paged_cache(cfg, 1 + nb, BLOCK_SIZE, 1, nb, torch.bfloat16, quantized=quantize_kv, device=device)
    row = torch.arange(1, 1 + nb, dtype=torch.int32, device=device)[None]
    tok = torch.tensor([context], dtype=torch.int32, device=device)
    lg, _ = prefill_step(cfg, params, cache, tok, torch.zeros(1, dtype=torch.int32, device=device), row)
    top = torch.topk(lg[0], 2).values
    return float(top[0] - top[1])


def differences(cfg, params, device, reqs, legacy_tokens, quantize_kv=False, tol=PATH_TOL) -> list[dict]:
    """Each request whose tokens differ from the legacy run's: the first
    position where they do and the legacy tokens' top-2 logit gap there
    (through pools of the run's kind), a near-tie when it is below
    ``tol``."""
    differ = []
    for i, (r, ref) in enumerate(zip(reqs, legacy_tokens)):
        j = next((j for j, (a, b) in enumerate(zip(r.generated, ref)) if a != b), None)
        if j is not None:
            gap = top2_gap(cfg, params, device, r.prompt + ref[:j], quantize_kv)
            differ.append({"request": i, "position": j, "legacy_top2_gap": gap, "near_tie": gap < tol})
    return differ


def serving_fused_phase(cfg, params, device, legacy_tokens, max_new_tokens=32) -> dict:
    """The serving phase's run with ``fused=True``: one graph replay and one
    host sync a tick on the card."""
    from repro_torch.kernels import paged_attention as K
    from repro_torch.serving import InferenceEngine

    kw = dict(
        max_batch=4, max_seq=512, block_size=BLOCK_SIZE, prefill_budget=128, cache_dtype=torch.bfloat16,
        eos_token=cfg.padded_vocab, device=device, fused=True,
    )
    torch.cuda.reset_peak_memory_stats()
    eng = InferenceEngine(cfg, params, **kw)
    # untimed: prompts of the same lengths from another seed capture the
    # buckets the timed traffic uses; their prefix shares no block with it
    for p in serving_prompts(cfg, SEED + 1):
        eng.submit(p, max_new_tokens=max_new_tokens)
    eng.run_until_drained()
    graphs = eng._graphs
    s0 = eng.stats()
    captured_warm, capture_s_warm = graphs.captures, graphs.capture_s
    replay_launches = dict(graphs.launches)
    since = eng.tracer.now()

    reqs = [eng.submit(p, max_new_tokens=max_new_tokens) for p in serving_prompts(cfg, SEED)]
    K.reset_launches()  # the main path's run starts here
    t0 = time.perf_counter()
    eng.run_until_drained()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(K.LAUNCHES)  # eager calls: the warm-up runs of keys captured in this run
    replayed = {k: v - replay_launches[k] for k, v in graphs.launches.items()}
    s = eng.stats()
    steps = s["decode_steps"] - s0["decode_steps"]
    dispatches = s["dispatches_total"] - s0["dispatches_total"]
    syncs = s["host_syncs_total"] - s0["host_syncs_total"]
    tick_tokens, tick_s = decode_ticks(eng, since)
    differ = differences(cfg, params, device, reqs, legacy_tokens)
    out = {
        "phase": "serving_fused", "model": cfg.name, "requests": len(reqs),
        "tokens_out": s["tokens_out"] - s0["tokens_out"], "decode_steps": steps, "wall_s": wall,
        "ttft_p50_s": float(np.median([r.ttft for r in reqs])),
        "tpot_p50_s": float(np.median([r.tpot for r in reqs])),
        "decode_tick_p50_s": eng.metrics.histogram("engine_decode_seconds").percentile(50),
        "decode_tok_s": tick_tokens / tick_s,
        "output_tok_s": (s["tokens_out"] - s0["tokens_out"]) / wall,
        "dispatches_per_step": dispatches / steps, "host_syncs_per_step": syncs / steps,
        "ticks": tick_kinds(eng, since),
        "graphs_captured": {"warm": captured_warm, "timed": graphs.captures - captured_warm},
        "graph_pool_bytes_by_key": {str(k): g.pool_bytes for k, g in graphs._graphs.items()},  # in capture order
        "capture_s": {"warm": capture_s_warm, "timed": graphs.capture_s - capture_s_warm},
        "graph_pool_bytes": graphs.pool_bytes(), "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
        "replay_launches": replayed, "eager_launches": launches,
        "requests_differing": len(differ), "differences": differ,
    }
    emit(out)
    if not all(r.finish_reason == "length" and len(r.generated) == max_new_tokens for r in reqs):
        fail(f"fused requests did not all finish by length: {[(r.finish_reason, len(r.generated)) for r in reqs]}")
    if not (replayed["paged_decode"] > 0 and replayed["paged_prefill"] > 0):
        fail(f"the fused run's graph replays ran no K1 or no K2: {replayed}")
    if out["dispatches_per_step"] > 1.5:
        fail(f"fused run: {out['dispatches_per_step']} dispatches a step (at most 1.5)")
    if not all(d["near_tie"] for d in differ):
        fail(f"fused tokens differ from the legacy run's away from a near-tie: {differ}")
    return out


def profile_fused_phase(cfg, params, device, ticks=5) -> dict:
    """One fused pure-decode tick at the profile phase's lengths, as the
    engine runs it (stage the inputs, replay the decode graph, one host
    sync), beside the eager ``decode_step`` and the eager tick
    (``decode_step``, argmax, one host sync), in the same run: wall per
    call with no profiler, then device time, idle share and the launches
    the profiler sees."""
    from repro_torch.models import decode_step
    from repro_torch.serving import InferenceEngine

    B = len(DECODE_LENS)
    eng = InferenceEngine(cfg, params, max_batch=B, max_seq=NB * BLOCK_SIZE, block_size=BLOCK_SIZE,
                          cache_dtype=torch.bfloat16, eos_token=cfg.padded_vocab, device=device, fused=True)
    eng.tbl[:] = np.arange(1, 1 + B * NB).reshape(B, NB)
    eng._tbl_dirty = True
    eng._sync_tables()
    pos = np.array([n - 1 for n in DECODE_LENS], np.int32)
    inputs = dict(tokens=np.zeros((B, 1), np.int32), pos=pos, temps=np.zeros(B, np.float32),
                  top_ks=np.zeros(B, np.int32), room=np.full(B, 2, np.int32))
    tok = torch.zeros((B, 1), dtype=torch.int32, device=device)
    pos_d = torch.from_numpy(pos).to(device)

    def fused_tick():
        eng._host_fetch(eng._graphs.run(("decode", B), eng._fused_decode_fn, inputs))

    def eager_step():
        decode_step(cfg, params, eng.cache, tok, pos_d)

    def eager_tick():
        logits, _ = decode_step(cfg, params, eng.cache, tok, pos_d)
        eng._host_fetch(torch.argmax(logits, dim=-1))

    out = {"phase": "profile_fused", "model": cfg.name, "what": "4 slots, bf16 pools, fp32 weights"}
    for name, fn in (("fused_tick", fused_tick), ("eager_step", eager_step), ("eager_tick", eager_tick)):
        for _ in range(3):
            fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(ticks):
            fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / ticks
        by_name, launches, _, _ = profiled(fn, ticks)
        busy = sum(by_name.values())
        out[name] = {
            "wall_ms": wall_ms, "device_busy_ms": busy if by_name else None,
            "idle_share": 1.0 - busy / wall_ms if by_name else None, "device_launches": launches,
            "paged_decode_ms": sum(v for k, v in by_name.items() if "paged_decode_kernel" in k),
        }
    out["graphs_captured"] = eng._graphs.captures
    out["graph_kernels_seen_one_by_one"] = out["fused_tick"]["device_launches"] >= out["eager_step"]["device_launches"]
    emit(out)
    return out


# ---------------------------------------------------------------------------
# phase 5d: speculative decoding
# ---------------------------------------------------------------------------

SPEC_K = 4
SPEC_ACCEPTANCE = 0.8  # the self-draft must reach it; a draft of unrelated weights must not


def serving_spec_phase(cfg, params, device, legacy_tokens, max_new_tokens=32) -> dict:
    """The serving phase's engine, prompts and settings with
    ``spec_decode`` and ``spec_k = 4``, four runs: (a) the legacy walk with
    the n-gram drafter; (b) the same with ``fused=True``, after an untimed
    run of prompts from another seed that captures the buckets; (c) the
    legacy walk with the target as its own drafter on the first two
    prompts; (d) its control, a ``make_draft_config`` draft of random
    weights from another seed, on the same two.  Each run first serves an
    untimed warm-up on its own engine; its readings are the timed run's."""
    from repro_torch.kernels import paged_attention as K
    from repro_torch.models import init_params
    from repro_torch.serving import InferenceEngine
    from repro_torch.serving.spec_decode import make_draft_config

    kw = dict(
        max_batch=4, max_seq=512, block_size=BLOCK_SIZE, prefill_budget=128, cache_dtype=torch.bfloat16,
        eos_token=cfg.padded_vocab, device=device, spec_k=SPEC_K,
    )
    prompts = serving_prompts(cfg, SEED)
    dcfg = make_draft_config(cfg)
    runs = {
        "a_legacy_ngram": (dict(spec_decode="ngram"), prompts),
        "b_fused_ngram": (dict(spec_decode="ngram", fused=True), prompts),
        "c_legacy_self_draft": (dict(spec_decode="draft", draft_cfg=cfg, draft_params=params), prompts[:2]),
        "d_control_draft": (
            dict(spec_decode="draft", draft_cfg=dcfg, draft_params=init_params(dcfg, SEED + 7, device=device)),
            prompts[:2],
        ),
    }
    out = {"phase": "serving_spec", "model": cfg.name, "spec_k": SPEC_K, "draft_model": dcfg.name}
    for name, (extra, ps) in runs.items():
        eng = InferenceEngine(cfg, params, **kw, **extra)
        warm = serving_prompts(cfg, SEED + 1)
        for p in warm if eng.fused else [warm[0][:48]]:
            eng.submit(p, max_new_tokens=max_new_tokens if eng.fused else 8)
        eng.run_until_drained()
        graphs = eng._graphs
        captured_warm = graphs.captures if graphs is not None else 0
        replay_before = dict(graphs.launches) if graphs is not None else {}
        s0 = eng.stats()
        counts0 = (eng.spec_emitted, eng.spec_slot_steps)
        since = eng.tracer.now()
        reqs = [eng.submit(p, max_new_tokens=max_new_tokens) for p in ps]
        K.reset_launches()  # this run's main path starts here
        t0 = time.perf_counter()
        eng.run_until_drained()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        eager = dict(K.LAUNCHES)
        s = eng.stats()
        d = {k: s[k] - s0[k] for k in ("decode_steps", "dispatches_total", "host_syncs_total", "tokens_out",
                                        "drafted_tokens", "accepted_tokens", "verify_tokens", "spec_steps")}
        emitted, slot_steps = eng.spec_emitted - counts0[0], eng.spec_slot_steps - counts0[1]
        replayed = {k: v - replay_before[k] for k, v in graphs.launches.items()} if graphs is not None else {}
        row = {
            "requests": len(reqs), "wall_s": wall,
            "ttft_p50_s": float(np.median([r.ttft for r in reqs])),
            "tpot_p50_s": float(np.median([r.tpot for r in reqs])),
            "output_tok_s": d["tokens_out"] / wall, "steps": d["decode_steps"],
            "step_s": wall / d["decode_steps"],
            "ticks": tick_kinds(eng, since),  # "decode": steps with no prefill chunk
            "dispatches_per_step": d["dispatches_total"] / d["decode_steps"],
            "host_syncs_per_step": d["host_syncs_total"] / d["decode_steps"],
            "acceptance_rate": d["accepted_tokens"] / d["drafted_tokens"] if d["drafted_tokens"] else 0.0,
            "tokens_per_verify": emitted / slot_steps if slot_steps else 0.0,
            "drafted_tokens": d["drafted_tokens"], "accepted_tokens": d["accepted_tokens"],
            "verify_passes": slot_steps, "verify_tokens": d["verify_tokens"], "spec_steps": d["spec_steps"],
            "eager_launches": eager, "replay_launches": replayed or None,
            "k2_launches": eager["paged_prefill"] + replayed.get("paged_prefill", 0),
            "k1_launches": eager["paged_decode"] + replayed.get("paged_decode", 0),
            "differences": differences(cfg, params, device, reqs, legacy_tokens[: len(reqs)]),
        }
        if graphs is not None:
            row.update(
                graphs_captured={"warm": captured_warm, "timed": graphs.captures - captured_warm},
                graph_keys=[str(k) for k in graphs._graphs],
                graph_pool_bytes_by_key={str(k): g.pool_bytes for k, g in graphs._graphs.items()},
                graph_pool_bytes=graphs.pool_bytes(),
            )
        out[name] = row
        emit({"phase": "serving_spec", "run": name, **row})
        if not all(r.finish_reason == "length" and len(r.generated) == max_new_tokens for r in reqs):
            fail(f"spec run {name}: requests did not all finish by length: "
                 f"{[(r.finish_reason, len(r.generated)) for r in reqs]}")
        if row["k2_launches"] <= 0 or (graphs is not None and replayed["paged_prefill"] <= 0):
            fail(f"spec run {name}: K2 did not run on the verify path: eager {eager}, replays {replayed}")
        if name[0] in "ab" and row["k1_launches"]:
            fail(f"spec run {name}: K1 ran ({row['k1_launches']} launches) though every step verifies")
        if graphs is not None:
            if row["dispatches_per_step"] > 1.5:
                fail(f"spec run {name}: {row['dispatches_per_step']} dispatches a step (at most 1.5)")
            if row["graphs_captured"]["timed"]:
                fail(f"spec run {name}: {row['graphs_captured']['timed']} graphs captured in the timed run")
        if name[0] in "abc" and not all(x["near_tie"] for x in row["differences"]):
            fail(f"spec run {name}: tokens differ from the legacy run's away from a near-tie: {row['differences']}")
        del eng, graphs
        torch.cuda.empty_cache()
    out["k2_launches"] = {name: out[name]["k2_launches"] for name in runs}
    if not out["c_legacy_self_draft"]["acceptance_rate"] >= SPEC_ACCEPTANCE:
        fail(f"self-draft acceptance {out['c_legacy_self_draft']['acceptance_rate']} < {SPEC_ACCEPTANCE}")
    if not out["d_control_draft"]["acceptance_rate"] < SPEC_ACCEPTANCE:
        fail(f"the control draft's acceptance {out['d_control_draft']['acceptance_rate']} reaches "
             f"{SPEC_ACCEPTANCE}, which then proves nothing")
    return out


# a committed row against the plain path's: each layer's K/V row is rounded
# to bf16 from activations that differ in the last fp32 bits, so a few
# elements may move by one bf16 spacing; the limit is one spacing of the
# row's largest element (2^-7 of it)
COMMITTED_REL = 2.0**-7


def rollback_readings(pools, history, reference, starts, cut, tbl) -> dict:
    """Per verify window of one step: the rejected rows [start + cut,
    start + spec_k + 1) must read zero, the history [0, start) must be
    bit-equal to the pools before the step, and the committed rows [start,
    start + cut) must agree with what the plain path wrote (``reference``):
    max |a - b| over each (layer, position) row, divided by the row's
    largest |b|, at most ``COMMITTED_REL``."""
    rejected, history_diff, committed = 0.0, 0.0, 0.0
    for b, (st, c) in enumerate(zip(starts, cut)):
        pos = torch.arange(st + c, st + SPEC_K + 1, device=tbl.device)
        for name in ("k", "v"):
            pool = pools[name]
            rows = pool[:, tbl[b, pos // BLOCK_SIZE].long(), pos % BLOCK_SIZE]
            rejected = max(rejected, float(rows.float().abs().max()))
            old = torch.arange(st, device=tbl.device)
            idx = (tbl[b, old // BLOCK_SIZE].long(), old % BLOCK_SIZE)
            history_diff = max(history_diff, float((pool[:, idx[0], idx[1]].float()
                                                    - history[name][:, idx[0], idx[1]].float()).abs().max()))
            new = torch.arange(st, st + c, device=tbl.device)
            idx = (tbl[b, new // BLOCK_SIZE].long(), new % BLOCK_SIZE)
            a, ref = pool[:, idx[0], idx[1]].float(), reference[name][:, idx[0], idx[1]].float()  # (L, c, KV, hd)
            row_err = (a - ref).abs().amax(dim=(2, 3)) / ref.abs().amax(dim=(2, 3))
            committed = max(committed, float(row_err.max()))
    return {"rejected_max_abs": rejected, "history_max_diff": history_diff, "committed_max_rel": committed}


def rollback_passes(r: dict) -> bool:
    return r["rejected_max_abs"] == 0.0 and r["history_max_diff"] == 0.0 and r["committed_max_rel"] <= COMMITTED_REL


def spec_rollback_phase(cfg, params, device) -> dict:
    """One verify step of 4 slots whose drafts cannot match (each slot's
    least likely token after its last committed one, by the plain path's
    logits), at the profile phase's lengths on full-width olmo-1b: so every
    window accepts nothing and rolls back its last ``spec_k`` lanes.  Run eagerly as the
    legacy walk calls it (``verify_step``, ``spec_accept``,
    ``truncate_block_rows``) and as the fused walk's spec graph (captured
    on a first call, then replayed on the restored pools and read).  Two
    controls must fail the readings: the pools after the verify pass with
    no rollback, and with the rollback one lane early (from ``start``,
    which also zeroes the committed row)."""
    from repro_torch.models import decode_step, prefill_step, verify_step
    from repro_torch.serving import InferenceEngine
    from repro_torch.serving.kvcache import truncate_block_rows
    from repro_torch.serving.sampler import spec_accept

    B, W = len(DECODE_LENS), SPEC_K + 1
    eng = InferenceEngine(cfg, params, max_batch=B, max_seq=NB * BLOCK_SIZE, block_size=BLOCK_SIZE,
                          cache_dtype=torch.bfloat16, eos_token=cfg.padded_vocab, device=device, fused=True,
                          spec_decode="ngram", spec_k=SPEC_K)
    eng.tbl[:] = np.arange(1, 1 + B * NB).reshape(B, NB)
    eng._tbl_dirty = True
    eng._sync_tables()
    tbl = eng.cache["tbl"]
    rng = np.random.default_rng(SEED + 3)
    starts = [n - 1 for n in DECODE_LENS]  # the windows cross block edges at 159 and 351
    zero = torch.zeros(1, dtype=torch.int32, device=device)
    for b, n in enumerate(starts):  # the history, through the prefill path
        hist = torch.tensor(rng.integers(0, cfg.vocab_size, n)[None], dtype=torch.int32, device=device)
        prefill_step(cfg, params, eng.cache, hist, zero, tbl[b : b + 1])
    history = {n: eng.cache[n].clone() for n in ("k", "v")}
    last = rng.integers(0, cfg.vocab_size, B).astype(np.int32)
    start = np.array(starts, np.int32)
    dev = lambda a: torch.from_numpy(a).to(device)  # noqa: E731

    # the plain path's rows: one decode step of the last token, plain
    # attention; its least likely token is each slot's draft
    reference = {n: history[n].clone() for n in ("k", "v")}
    ref_logits, _ = decode_step(cfg, params, {**reference, "tbl": tbl}, dev(last[:, None]), dev(start), attn_impl="plain")
    tokens = np.repeat(ref_logits[:, : cfg.vocab_size].argmin(-1).int().cpu().numpy()[:, None], W, axis=1)
    tokens[:, 0] = last

    # eager, as the legacy walk's _spec_step
    for n in ("k", "v"):
        eng.cache[n].copy_(history[n])
    logits, _ = verify_step(cfg, params, eng.cache, dev(tokens), dev(start), tbl)
    no_rollback = {n: eng.cache[n].clone() for n in ("k", "v")}
    early = truncate_block_rows({n: t.clone() for n, t in no_rollback.items()}, tbl, dev(start), dev(start + W), span=W)
    valid = torch.ones((B, SPEC_K), dtype=torch.bool, device=device)
    temps, top_ks = torch.zeros(B, device=device), torch.zeros(B, dtype=torch.int32, device=device)
    n_acc, _ = spec_accept(logits, dev(tokens[:, 1:]), None, valid, temps, top_ks, eng._gen)
    cut_eager = (n_acc + 1).cpu().tolist()
    truncate_block_rows(eng.cache, tbl, dev(start) + n_acc + 1, dev(start + W), span=W)
    torch.cuda.synchronize()
    eager = rollback_readings(eng.cache, history, reference, starts, cut_eager, tbl)

    # the fused walk's spec graph: the capture's call, then a replay
    inputs = dict(
        tokens=tokens, start=start, widths=np.full(B, W, np.int32), tbl=eng.tbl.astype(np.int32),
        temps=np.zeros(B, np.float32), top_ks=np.zeros(B, np.int32), sample_lane=np.zeros(B, np.int32),
        room=np.full(B, W + 1, np.int32), drafts=tokens[:, 1:].copy(), valid=np.ones((B, SPEC_K), np.int32),
        roll_end=start + W,
    )
    key = ("mixed", B, W, "spec")
    for _ in range(2):
        for n in ("k", "v"):
            eng.cache[n].copy_(history[n])
        packed = eng._graphs.run(key, eng._fused_mixed_fn, inputs)
        torch.cuda.synchronize()
    cut_graph = packed[2].cpu().tolist()
    graph = rollback_readings(eng.cache, history, reference, starts, cut_graph, tbl)
    controls = {name: rollback_readings(pools, history, reference, starts, cut_eager, tbl)
                for name, pools in (("no_rollback", no_rollback), ("one_lane_early", early))}
    out = {
        "phase": "spec_rollback", "model": cfg.name, "starts": starts, "spec_k": SPEC_K,
        "cut_eager": cut_eager, "cut_graph": cut_graph, "eager": eager, "graph": graph,
        "graph_replays": eng._graphs.replays, "graph_launches": dict(eng._graphs.launches),
        "limit_committed_rel": COMMITTED_REL, "controls": controls,
    }
    emit(out)
    if out["graph_launches"]["paged_prefill"] != 2 * cfg.num_layers:
        fail(f"spec rollback: the two replays ran {out['graph_launches']} K2 launches, not 2 x {cfg.num_layers}")
    if cut_eager != [1] * B or cut_graph != [1] * B:
        fail(f"spec rollback: a draft that cannot match was accepted: cut {cut_eager} / {cut_graph}")
    if not rollback_passes(eager) or not rollback_passes(graph):
        fail(f"spec rollback: eager {eager}, graph {graph}")
    for name, r in controls.items():
        if rollback_passes(r):
            fail(f"spec rollback: the control {name} passes {r}, which then proves nothing")
    return out


# ---------------------------------------------------------------------------
# phase 5f-5i: the KV-cache tiers (quantized pools, host spill tier)
# ---------------------------------------------------------------------------


def quantized_case(c, mode) -> dict:
    """A kernel case's K/V, drawn again in fp32 and quantized by the port's
    ``quantize`` (``mode``: int8 or fp8): the codes and scales of each
    layer, and fp32 pools that hold the same dequantized rows."""
    from repro_torch.serving.kvquant import quantize

    g = torch.Generator(device=c["q"].device).manual_seed(11)
    out = {}
    for name in ("k", "v"):
        codes, scale = quantize(torch.randn(c[name].shape, generator=g, device=c["q"].device), mode)
        out[name], out[f"{name}_scale"], out[f"{name}_fp32"] = codes, scale, codes.float() * scale
    return out


def kv_quant_read_phase(device) -> dict:
    """The read path of quantized pools, which have no kernel (as in the
    JAX package): the plain dequantizing read of int8 and e4m3 pools against
    K1 and K2 over fp32 pools holding the same dequantized rows, at the
    kernel phase's olmo-1b shapes (4 slots at ``DECODE_LENS``; one 128-token
    chunk after 192 tokens), fp32 queries.  The arithmetic differs only in
    summation order, so ``TOL[fp32]`` holds; scales shifted by one token row
    are the control that must exceed it.  Times are device times."""
    from repro_torch.kernels import paged_attention as K

    (_, H, KV, hd) = HEAD_SHAPES[0]
    out = {"phase": "kv_quant_read", "model": "olmo-1b", "tol": TOL[torch.float32]}
    for kind, plain, kernel in (("decode", K.paged_attention_quantized, K.paged_attention),
                                ("prefill", K.paged_prefill_attention_quantized, K.paged_prefill_attention)):
        c = kernel_case(kind, H, KV, hd, torch.float32, 0, 0.0, device, layers=4)
        for mode in ("int8", "fp8"):
            p = quantized_case(c, mode)

            def run_plain(i, p=p, c=c, shift=0):
                layer = i % c["layers"]
                ks = torch.roll(p["k_scale"][layer], shift, dims=1) if shift else p["k_scale"][layer]
                return plain(c["q"], p["k"][layer], p["v"][layer], ks, p["v_scale"][layer], c["tbl"], c["lens"])

            def run_kernel(i, p=p, c=c):
                layer = i % c["layers"]
                return kernel(c["q"], p["k_fp32"][layer], p["v_fp32"][layer], c["tbl"], c["lens"])

            ref = run_kernel(0)
            err = float((run_plain(0).float() - ref.float()).abs().max())
            control = float((run_plain(0, shift=1).float() - ref.float()).abs().max())
            row = {
                "kind": kind, "mode": mode, "max_abs_err": err, "control": "scales_one_row_off",
                "control_max_abs_err": control, "plain_ms": timed_ms(run_plain),
                "kernel_fp32_pools_ms": timed_ms(run_kernel),
            }
            out[f"{kind}_{mode}"] = row
            emit({"phase": "kv_quant_read", **row})
            if not err < TOL[torch.float32]:
                fail(f"kv_quant_read {kind} {mode}: the plain read is {err} from K1/K2 (>= {TOL[torch.float32]})")
            if not control > TOL[torch.float32]:
                fail(f"kv_quant_read {kind} {mode}: the control passes ({control}), which then proves nothing")
            del p
        del c
    return out


def pool_bytes(eng) -> int:
    """Device bytes of the engine's pools and scale leaves (no table)."""
    return sum(t.numel() * t.element_size() for n, t in eng.cache.items() if n != "tbl")


def serving_quantized_phase(cfg, params, device, legacy_tokens, bf16_pool_bytes, max_new_tokens=32) -> dict:
    """The serving phase's prompts and settings with ``quantize_kv="int8"``
    and ``"fp8"``, in the legacy and the fused walk (the fused engine first
    serves prompts from another seed, untimed, to capture its buckets).
    Quantized pools read through the plain path, so K1 and K2 must not run;
    the fused run's tokens must equal the legacy run's up to near-ties.
    Agreement with the bf16 legacy run is reported, not gated: random
    weights make near-ties, and int8 / e4m3 rows move logits more than a
    bf16 rounding does."""
    from repro_torch.kernels import paged_attention as K
    from repro_torch.serving import InferenceEngine

    kw = dict(
        max_batch=4, max_seq=512, block_size=BLOCK_SIZE, prefill_budget=128, cache_dtype=torch.bfloat16,
        eos_token=cfg.padded_vocab, device=device,  # attn_impl="kernel": quantized pools must not reach K1/K2
    )
    prompts = serving_prompts(cfg, SEED)
    head = cfg.head_dim
    out = {"phase": "serving_quantized", "model": cfg.name, "bf16_pool_bytes": bf16_pool_bytes,
           "predicted_pool_ratio": (head + 4) / (2 * head)}
    for mode in ("int8", "fp8"):
        runs = {}
        for fused in (False, True):
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                eng = InferenceEngine(cfg, params, quantize_kv=mode, fused=fused, **kw)
            if not any("no kernel" in str(w.message) for w in caught):
                fail(f"serving_quantized {mode}: no warning that quantized pools read plain under attn_impl='kernel'")
            warm = serving_prompts(cfg, SEED + 1)
            for p in warm if fused else [warm[0][:48]]:
                eng.submit(p, max_new_tokens=max_new_tokens if fused else 2)
            eng.run_until_drained()
            graphs = eng._graphs
            s0 = eng.stats()
            replay_before = dict(graphs.launches) if graphs is not None else {}
            captured_warm = graphs.captures if graphs is not None else 0
            since = eng.tracer.now()
            reqs = [eng.submit(p, max_new_tokens=max_new_tokens) for p in prompts]
            K.reset_launches()  # this run's main path starts here
            t0 = time.perf_counter()
            eng.run_until_drained()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            eager = dict(K.LAUNCHES)
            replayed = {k: v - replay_before[k] for k, v in graphs.launches.items()} if graphs is not None else {}
            s = eng.stats()
            steps = s["decode_steps"] - s0["decode_steps"]
            tick_tokens, tick_s = decode_ticks(eng, since)
            runs[fused] = reqs
            differ = differences(cfg, params, device, reqs, legacy_tokens)
            row = {
                "mode": mode, "fused": fused, "requests": len(reqs), "wall_s": wall,
                "ttft_p50_s": float(np.median([r.ttft for r in reqs])),
                "tpot_p50_s": float(np.median([r.tpot for r in reqs])),
                "decode_tick_p50_s": float(np.median([e.dur for e in eng.tracer.events
                                                      if e.name == "step" and e.ts >= since
                                                      and e.args.get("produced", 0) > 0])),
                "decode_tok_s": tick_tokens / tick_s, "output_tok_s": (s["tokens_out"] - s0["tokens_out"]) / wall,
                "dispatches_per_step": (s["dispatches_total"] - s0["dispatches_total"]) / steps,
                "cache_bytes": s["cache_bytes"], "pool_bytes": pool_bytes(eng),
                "pool_ratio_to_bf16": pool_bytes(eng) / bf16_pool_bytes,
                "alloc_blocks_in_use": s["alloc_blocks_in_use"],
                "eager_launches": eager, "replay_launches": replayed or None,
                "graphs_captured_timed": graphs.captures - captured_warm if graphs is not None else None,
                "requests_equal_to_bf16": len(reqs) - len(differ),
                "tokens_before_first_difference": [d["position"] for d in differ],
                "differences_from_bf16": differ,  # each with the bf16 run's top2_gap there
            }
            out[f"{mode}_{'fused' if fused else 'legacy'}"] = row
            emit({"phase": "serving_quantized", **row})
            if not all(r.finish_reason == "length" and len(r.generated) == max_new_tokens for r in reqs):
                fail(f"serving_quantized {mode} fused={fused}: requests did not all finish by length: "
                     f"{[(r.finish_reason, len(r.generated)) for r in reqs]}")
            if s["alloc_blocks_in_use"] != 0:
                fail(f"serving_quantized {mode} fused={fused}: {s['alloc_blocks_in_use']} blocks still in use")
            k1k2 = eager["paged_decode"] + eager["paged_prefill"] + sum(replayed.values())
            if k1k2:
                fail(f"serving_quantized {mode} fused={fused}: K1/K2 ran on quantized pools: {eager} {replayed}")
            del eng, graphs
            torch.cuda.empty_cache()
        # mixed ticks run decode rows through other shapes than the legacy
        # walk: held to the legacy run's tokens up to near-ties, as serving_fused
        differ = differences(cfg, params, device, runs[True], [list(r.generated) for r in runs[False]], mode)
        out[f"{mode}_fused_vs_legacy"] = differ
        if not all(x["near_tie"] for x in differ):
            fail(f"serving_quantized {mode}: the fused run's tokens differ from the legacy run's away from a near-tie: "
                 f"{differ}")
    for mode in ("int8", "fp8"):  # where an eager quantized decode step's time goes
        out[f"{mode}_decode_step_profile"] = profile_phase(cfg, params, device, quantize_kv=mode)
    if out["int8_legacy"]["pool_bytes"] != out["fp8_legacy"]["pool_bytes"]:
        fail(f"serving_quantized: int8 pools {out['int8_legacy']['pool_bytes']} B, fp8 {out['fp8_legacy']['pool_bytes']}")
    emit({"phase": "serving_quantized", "summary": {k: v for k, v in out.items() if not isinstance(v, dict)}})
    return out


TIER_GROUPS, TIER_PREFIX, TIER_TAIL = 8, 256, 32  # 8 prefixes of 8 full blocks, a 32-token tail each
TIER_NUM_BLOCKS = 49  # 48 usable blocks of 4 MiB: round 1's chains must leave the card
TIER_SPILL_BYTES = 512 << 20


def since_counts(h, counts0):
    """The observations of histogram ``h`` made after its bucket counts read
    ``counts0``, as a histogram of its own (min and max stay ``h``'s)."""
    from repro_torch.serving.metrics import Histogram

    d = Histogram(h.name, buckets=h.bounds)
    d.counts = [a - b for a, b in zip(h.counts, counts0)]
    d.count, d.min, d.max = sum(d.counts), h.min, h.max
    return d


def time_calls(eng) -> dict:
    """Time, on the host clock, each call of the engine's spill-tier steps
    (the gather at evict time, the spill pool's put and pop, the restore
    pass), by wrapping them on this engine instance; returns the dict the
    seconds add up in.  The calls run as before."""
    acc: dict[str, float] = {}

    def timed(name, fn):
        def call(*args, **kw):
            t0 = time.perf_counter()
            try:
                return fn(*args, **kw)
            finally:
                acc[name] = acc.get(name, 0.0) + time.perf_counter() - t0
        return call

    eng.run_restores = timed("restore_pass", eng.run_restores)
    if eng.spill is not None:
        eng.prefix._fetch = timed("gather", eng.prefix._fetch)
        eng.spill.put = timed("spill_put", eng.spill.put)
        eng.spill.pop = timed("spill_pop", eng.spill.pop)
    eng.scheduler._admit = timed("admit", eng.scheduler._admit)
    return acc


def tier_rounds(cfg, seed) -> list[list[list[int]]]:
    """Two rounds of 8 prompts: round 2 resubmits round 1's 8 prefixes with
    new tails."""
    rng = np.random.default_rng(seed)
    prefixes = [[int(t) for t in rng.integers(0, cfg.vocab_size, TIER_PREFIX)] for _ in range(TIER_GROUPS)]
    return [[p + [int(t) for t in rng.integers(0, cfg.vocab_size, TIER_TAIL)] for p in prefixes] for _ in range(2)]


def serving_tiered_phase(cfg, params, device, max_new_tokens=32) -> dict:
    """Tiered traffic on full-width olmo-1b: two rounds of 8 prompts that
    share, round to round, a 256-token prefix, against 48 usable blocks, so
    round 1's chains leave the card.  Arms: ``spill`` (512 MiB host tier,
    pool-native bytes), ``drop`` (evictions drop) and ``uncached`` (no
    prefix cache), and ``spill_budget_32`` (the tier with a restore budget
    of 32 blocks a pass in place of 4), in the legacy walk, and ``spill``
    and ``drop`` in the fused walk, each after an untimed pass of the same
    traffic from another seed.  A prefill budget of 0 puts every prompt through the same chunks
    (256, then 32) in every arm, so the legacy arms compute every K/V row
    alike and their tokens must be equal.  The fused arms' mixed ticks
    batch rows differently, so their tokens are held to the legacy spill
    arm's up to near-ties, as the serving_fused phase holds its own.
    Round 2's readings also split its time: each request's TTFT, the
    scheduler steps, the restore passes' seconds, and the spills and
    evictions its admissions caused."""
    from repro_torch.kernels import paged_attention as K
    from repro_torch.serving import InferenceEngine

    kw = dict(
        max_batch=4, max_seq=512, block_size=BLOCK_SIZE, prefill_budget=0, cache_dtype=torch.bfloat16,
        eos_token=cfg.padded_vocab, device=device, num_blocks=TIER_NUM_BLOCKS,
    )
    arms = {
        "spill": dict(spill_bytes=TIER_SPILL_BYTES),
        "drop": {},
        "uncached": dict(prefix_cache=False),
        # every swap-in of the 4 slots' admissions in one restore pass,
        # where the default budget (4 blocks) takes 2 passes a request
        "spill_budget_32": dict(spill_bytes=TIER_SPILL_BYTES, restore_budget=32),
        "spill_fused": dict(spill_bytes=TIER_SPILL_BYTES, fused=True),
        "drop_fused": dict(fused=True),
    }
    rounds = tier_rounds(cfg, SEED)
    out = {"phase": "serving_tiered", "model": cfg.name, "num_blocks": TIER_NUM_BLOCKS,
           "spill_bytes": TIER_SPILL_BYTES, "prefix_tokens": TIER_PREFIX, "tail_tokens": TIER_TAIL}
    tokens = {}
    for arm, extra in arms.items():
        eng = InferenceEngine(cfg, params, **kw, **extra)
        if eng.fused:  # untimed: the same traffic from another seed captures the buckets
            for prompts in tier_rounds(cfg, SEED + 1):
                for p in prompts:
                    eng.submit(p, max_new_tokens=max_new_tokens)
                eng.run_until_drained()
        graphs = eng._graphs
        s0 = eng.stats()
        replay_before = dict(graphs.launches) if graphs is not None else {}
        captured_warm = graphs.captures if graphs is not None else 0
        restore_wait = eng.metrics.histogram("engine_restore_wait_seconds")
        wait0 = list(restore_wait.counts)
        host_s = time_calls(eng)
        K.reset_launches()  # this arm's main path starts here
        reqs, walls, starts = [], [], []
        for r_i, prompts in enumerate(rounds):
            starts.append(eng.tracer.now())
            host_s.clear()  # each round's own
            t0 = time.perf_counter()
            reqs.append([eng.submit(p, max_new_tokens=max_new_tokens) for p in prompts])
            eng.run_until_drained()
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
            if r_i == 0:
                s_mid = eng.stats()
        eager = dict(K.LAUNCHES)
        replayed = {k: v - replay_before[k] for k, v in graphs.launches.items()} if graphs is not None else {}
        s = eng.stats()
        d = lambda key, a=s, b=s0: a.get(key, 0) - b.get(key, 0)  # noqa: E731
        r2_hit, r2_prefill = d("prefix_hit_tokens", s, s_mid), d("prefill_tokens", s, s_mid)
        tokens[arm] = [list(r.generated) for rr in reqs for r in rr]
        waits = since_counts(restore_wait, wait0)
        r2_events = [e for e in eng.tracer.events if e.ts >= starts[1]]
        row = {
            "arm": arm, "fused": eng.fused, "wall_s": walls,
            "round2_ttft_p50_s": float(np.median([r.ttft for r in reqs[1]])),
            "round1_ttft_p50_s": float(np.median([r.ttft for r in reqs[0]])),
            "round2_ttft_s": [r.ttft for r in reqs[1]],  # in submission order
            "round2_steps": sum(e.name == "step" for e in r2_events),
            "round2_restore_s": sum(e.dur for e in r2_events if e.name == "restore"),
            "round2_spills": sum(e.name == "spill" for e in r2_events),
            "round2_evictions": sum(e.name == "evict" for e in r2_events),
            "round2_first_step_s": next((e.dur for e in r2_events if e.name == "step"), None),
            "round2_host_s": dict(host_s),  # wall of the tier's calls: gather, spill put, pop, restore pass
            "tpot_p50_s": float(np.median([r.tpot for rr in reqs for r in rr])),
            "prefill_tokens": d("prefill_tokens"), "round2_prefill_tokens": r2_prefill,
            "prefix_hit_tokens": d("prefix_hit_tokens"),
            "round2_prefix_hit_rate": r2_hit / (r2_hit + r2_prefill) if r2_hit + r2_prefill else 0.0,
            "prefix_hit_rate": s.get("prefix_hit_rate"),
            "evictions_spilled": d("alloc_evictions_spilled"), "evictions_dropped": d("alloc_evictions_dropped"),
            "restores": d("restores"), "restores_pending": s.get("restores_pending"),
            "spill_hit_tokens": d("spill_hit_tokens"), "spill_bytes_used": s.get("spill_bytes_used"),
            "spill_blocks": s.get("spill_blocks"), "spill_staged": s.get("spill_staged"),
            "spill_drops": s.get("spill_drops"),
            "restore_wait_p50_s": waits.percentile(50), "restore_waits": waits.count,
            "alloc_blocks_in_use": s["alloc_blocks_in_use"],
            "eager_launches": eager, "replay_launches": replayed or None,
            "k1_launches": eager["paged_decode"] + replayed.get("paged_decode", 0),
            "k2_launches": eager["paged_prefill"] + replayed.get("paged_prefill", 0),
            "graphs_captured_timed": graphs.captures - captured_warm if graphs is not None else None,
        }
        out[arm] = row
        emit({"phase": "serving_tiered", **row})
        if not all(r.finish_reason == "length" and len(r.generated) == max_new_tokens for rr in reqs for r in rr):
            fail(f"serving_tiered {arm}: requests did not all finish by length")
        if s["alloc_blocks_in_use"] != 0:
            fail(f"serving_tiered {arm}: {s['alloc_blocks_in_use']} blocks still in use")
        if row["k2_launches"] <= 0 or row["k1_launches"] <= 0:
            fail(f"serving_tiered {arm}: K1/K2 did not both run: eager {eager}, replays {replayed}")
        if arm.startswith("spill"):
            if not (row["evictions_spilled"] > 0 and row["restores"] > 0 and row["spill_hit_tokens"] > 0):
                fail(f"serving_tiered {arm}: the tier did not work: {row}")
            if row["restores_pending"] != 0:
                fail(f"serving_tiered {arm}: {row['restores_pending']} restores still pending")
        if arm.startswith("drop") and row["evictions_dropped"] <= 0:
            fail(f"serving_tiered drop: no eviction, so round 1's chains never left the card: {row}")
        if eng.fused:
            flat = [r for rr in reqs for r in rr]
            differ = differences(cfg, params, device, flat, tokens["spill"])
            row["differences_from_legacy_spill"] = differ
            if not all(x["near_tie"] for x in differ):
                fail(f"serving_tiered: fused spill tokens differ from the legacy spill arm's away from a near-tie: "
                     f"{differ}")
        del eng, graphs
        torch.cuda.empty_cache()
    for arm in ("drop", "uncached", "spill_budget_32"):
        differ = [i for i, (a, b) in enumerate(zip(tokens["spill"], tokens[arm])) if a != b]
        out[f"requests_differing_spill_vs_{arm}"] = differ
        if differ:
            fail(f"serving_tiered: the spill arm's tokens differ from the {arm} arm's in requests {differ}")
    out["fused_requests_differing"] = {arm: len(out[arm]["differences_from_legacy_spill"])
                                       for arm in ("spill_fused", "drop_fused")}
    emit({"phase": "serving_tiered", "summary": {k: v for k, v in out.items() if k not in arms}})
    return out


def spill_restore_phase(cfg, device, iters=10) -> dict:
    """One block of a full-width olmo-1b bf16 pool through the host tier:
    gathered, put with ``staging_depth=0`` (so it reaches host memory),
    popped and restored into another block: the rows must be bit-equal
    (``"cache"`` mode), and K2 over a table that points at the restored
    block must give the output of K2 over the original, bit for bit.  The
    control restores into the neighbouring block, which the same checks
    must reject.  Times (host clock, the card synchronized): the gather and
    device-to-host copy of one block, and a 4-block restore from host
    memory, as the engine's restore pass runs it (the copies to the card,
    the stack, one in-place scatter)."""
    from repro_torch.kernels import paged_attention as K
    from repro_torch.models import init_paged_cache
    from repro_torch.serving import SpillPool, gather_block_rows, restore_block_rows

    N = 1 + NB + 8
    cache = init_paged_cache(cfg, N, BLOCK_SIZE, 1, NB, torch.bfloat16, device=device)
    g = torch.Generator(device=device).manual_seed(SEED)
    for name in ("k", "v"):
        cache[name].copy_(torch.randn(cache[name].shape, generator=g, device=device))
    src, dst = 3, NB + 2  # dst lies outside the table's blocks 1..NB
    control = {n: t.clone() for n, t in cache.items()}
    pool = SpillPool(1 << 30, mode="cache", staging_depth=0)
    h = pool.put(gather_block_rows(cache, src))
    on_host = all(t.device.type == "cpu" for t in pool._payload[h].values())
    rows = pool.pop(h)

    def restore(c, block):
        restore_block_rows(c, torch.tensor([block], dtype=torch.int32, device=device),
                           {n: t.to(device)[:, None] for n, t in rows.items()})

    restore(cache, dst)
    restore(control, dst + 1)  # the control: into the neighbouring block
    torch.cuda.synchronize()

    def readings(c) -> dict:
        H, hd = cfg.num_heads, cfg.head_dim
        q = torch.randn((1, PREFILL_C, H, hd), generator=torch.Generator(device=device).manual_seed(5), device=device)
        start = torch.tensor([PREFILL_START], dtype=torch.int32, device=device)
        base = torch.arange(1, 1 + NB, dtype=torch.int32, device=device)[None]
        moved = base.clone()
        moved[0, src - 1] = dst
        before = dict(K.LAUNCHES)
        outs = [K.paged_prefill_attention(q, c["k"][l], c["v"][l], t, start) for l in (0, cfg.num_layers - 1)
                for t in (base, moved)]
        K.LAUNCHES.update(before)  # check launches, not the main path's
        return {
            "rows_equal": all(torch.equal(c[n][:, dst], c[n][:, src]) for n in ("k", "v")),
            "k2_equal": all(torch.equal(outs[i], outs[i + 1]) for i in (0, 2)),
        }

    sound, ctrl = readings(cache), readings(control)

    def wall(fn) -> float:
        ts = []
        for _ in range(iters):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            ts.append(time.perf_counter() - t0)
        return float(np.median(ts)) * 1e3

    payload_bytes = sum(t.numel() * t.element_size() for t in rows.values())
    host = [{n: t.clone() for n, t in rows.items()} for _ in range(4)]
    blocks4 = torch.tensor([NB + 1, NB + 2, NB + 3, NB + 4], dtype=torch.int32, device=device)
    d2h_ms = wall(lambda: pool._compress(gather_block_rows(cache, src)))
    restore4_ms = wall(lambda: restore_block_rows(
        cache, blocks4, {n: torch.stack([p[n].to(device) for p in host], dim=1) for n in rows}))
    staged4_ms = wall(lambda: restore_block_rows(
        cache, blocks4, {n: torch.stack([cache[n][:, src]] * 4, dim=1) for n in rows}))
    out = {
        "phase": "spill_restore", "model": cfg.name, "block_bytes": payload_bytes, "on_host": on_host,
        "sound": sound, "control": ctrl,
        "gather_d2h_one_block_ms": d2h_ms, "d2h_gb_s": payload_bytes / d2h_ms / 1e6,
        "restore_4_blocks_from_host_ms": restore4_ms, "h2d_gb_s": 4 * payload_bytes / restore4_ms / 1e6,
        "restore_4_blocks_on_device_ms": staged4_ms,
    }
    emit(out)
    if not on_host:
        fail("spill_restore: the payload never reached host memory")
    if not (sound["rows_equal"] and sound["k2_equal"]):
        fail(f"spill_restore: the round trip is not exact: {sound}")
    if ctrl["rows_equal"] or ctrl["k2_equal"]:
        fail(f"spill_restore: the control (a restore into the neighbouring block) passes {ctrl}")
    return out


# ---------------------------------------------------------------------------
# phase 5g: the Fig. 9 harness at full width
# ---------------------------------------------------------------------------

FIG9_DENSE_BATCH, FIG9_MAX_SEQ, FIG9_PAGED_BATCH = 4, 512, 16  # paged: 4 x 512 / 32 = 64 blocks
FIG9_SHARED = dict(n=16, system_len=96, tail=8)  # a 3-block system prompt, 8-token tails
JOULES_REL = 1e-9  # per-request joules against the engine's: float sums of the same terms
# dense against paged tokens: a first difference must sit at a top-2 gap
# below this.  The dense prefill attends its fp32 K/V unrounded while the
# paged chunks attend bf16 rows, so near-ties flip.  Readings on an H100
# 80GB HBM3 at 700 W: the sound walks differ at gaps up to 0.011; the
# control (each admitted ring shifted one slot) differs at gaps far above
# the limit (PERF.md, PR 21)
FIG9_TIE_TOL = 2e-2
FIG9_CONTROL_NEW = 8  # the control's tokens: its fault shows from the second token on


def ring_one_slot_off(engine_cls):
    """The control of the dense-against-paged gate: a dense engine whose
    admission leaves each prompt's K/V one ring slot late (positions
    unchanged), so every decode step reads its neighbour's keys."""

    class RingOneSlotOff(engine_cls):
        def _admit_blocking(self, req, slot):
            admitted = super()._admit_blocking(req, slot)
            for name in ("k", "v"):
                self.cache[name][:, slot] = self.cache[name][:, slot].roll(1, dims=1)
            return admitted

    return RingOneSlotOff


def fig9_readings(s: dict) -> dict:
    """What ``fig9`` prints of one harness arm's stats."""
    keys = ("ttft_p50_s", "ttft_p99_s", "tpot_p50_s", "tpot_p99_s", "tok_per_s", "wall_s", "decode_steps",
            "decode_tick_p50_s", "tokens_out", "peak_active", "cache_bytes", "alloc_peak_in_use", "alloc_capacity",
            "alloc_blocks_in_use", "prefill_tokens", "prefix_hit_tokens", "prefix_hit_rate", "acceptance_rate",
            "accepted_per_step", "drafted_tokens", "accepted_tokens", "energy_joules", "joules_per_token",
            "request_joules", "dispatches_per_step", "host_syncs_per_step", "profile_s")
    return {k: s[k] for k in keys if k in s}


def fig9_phase(cfg, params, device, max_new_tokens=32) -> dict:
    """``repro_torch.benchmarks.llm_inference``'s closed-loop arms at full
    width: dense (4 slots, max_seq 512) against paged at the same cache
    bytes (block 32, 64 blocks, 16 slots) on 16 requests of 64-320 prompt
    tokens; the shared-system-prompt A/B (prefix cache off / on, 4 slots,
    prefill budget 128); speculative decoding off / n-gram / self-draft on
    the repetitive-suffix prompts (``spec_k = 4``, 24 new tokens).  Then
    one profiled run of each cache kind on the first arms' prompts, and the
    fused arm (legacy and fused engines, each after a warm-up round) on the
    shared prompts.  bf16 caches, an ``eos_token`` outside the vocab.

    Gates: the dense cache is ``models.cache_bytes(cfg, 4, 512, bf16)`` and
    the paged one no larger; dense and paged tokens equal up to near-ties
    (``differences``), as the fused arm's against its legacy run; cached
    prefill tokens at most half the uncached, hit rate above 0; the
    self-draft emits more than one token per slot-step; no block in use
    after any drain; the control (a dense engine whose admitted rings sit
    one slot off) differs from the dense tokens away from a near-tie; K1 and K2 ran; the profiled runs' tokens equal the
    unprofiled runs'; per-request joules sum to the engine's.  The n-gram
    arm's acceptance is a reading: random weights need not continue the
    pattern."""
    from types import SimpleNamespace

    from repro_torch.benchmarks import llm_inference as bench
    from repro_torch.kernels import paged_attention as K
    from repro_torch.models import cache_bytes
    from repro_torch.serving import InferenceEngine

    prompts = serving_prompts(cfg, SEED) + serving_prompts(cfg, SEED + 2)
    shared = bench.shared_prefix_prompts(**FIG9_SHARED)
    sizes = dict(
        device=device, cache_dtype=torch.bfloat16, eos_token=cfg.padded_vocab, max_seq=FIG9_MAX_SEQ,
        block_size=BLOCK_SIZE,
    )
    K.reset_launches()  # the harness's closed-loop arms start here
    arms = bench.closed_loop(
        cfg, params, dense_batch=FIG9_DENSE_BATCH, paged_batch=FIG9_PAGED_BATCH, prompts=prompts,
        max_new=max_new_tokens, shared=shared, shared_budget=128, spec_k=SPEC_K, **sizes,
    )
    launches = dict(K.LAUNCHES)
    dense_kw, paged_kw = bench.dense_paged_kwargs(
        dense_batch=FIG9_DENSE_BATCH, paged_batch=FIG9_PAGED_BATCH, **sizes)
    control = bench.drive(ring_one_slot_off(InferenceEngine)(cfg, params, **dense_kw), prompts,
                          max_new=FIG9_CONTROL_NEW)  # the control of the dense-against-paged gate
    for kind, kw in (("dense", dense_kw), ("paged", paged_kw)):  # the same arms, profiled
        arms[f"{kind}_profiled"] = bench.drive(InferenceEngine(cfg, params, profile=True, **kw), prompts,
                                               max_new=max_new_tokens)
    # where a decode tick's time goes, the dense ring against the paged pools
    decode_profiles = {kind: profile_phase(cfg, params, device, cache_kind=kind) for kind in ("dense", "paged")}
    fused_kw = dict(max_batch=bench.SHARED_BATCH, cache_kind="paged", prefix_cache=True, prefill_budget=128, **sizes)
    fused = {label: bench.fused_arm(cfg, params, shared, fused=f, **fused_kw)
             for label, f in (("legacy", False), ("fused", True))}

    out = {"phase": "fig9", "model": cfg.name, "requests": len(prompts), "max_new_tokens": max_new_tokens,
           "launches": launches, "decode_step_profiles": decode_profiles}
    for name, s in arms.items():
        out[name] = fig9_readings(s)
        emit({"phase": "fig9", "arm": name, **out[name]})
    for label, a in fused.items():
        row = {k: v for k, v in a.items() if k != "tokens"}
        out[f"fused_arm_{label}"] = row
        emit({"phase": "fig9", "arm": f"fused_arm_{label}", **row, "model_step_s_is": bench.MODELLED})

    as_reqs = lambda ps, toks: [SimpleNamespace(prompt=p, generated=t) for p, t in zip(ps, toks)]  # noqa: E731
    dense, paged = arms["dense"], arms["paged"]
    out["dense_vs_paged"] = differences(cfg, params, device, as_reqs(prompts, paged["tokens"]), dense["tokens"],
                                        tol=FIG9_TIE_TOL)
    out["control_vs_dense"] = differences(cfg, params, device, as_reqs(prompts, control["tokens"]),
                                          dense["tokens"], tol=FIG9_TIE_TOL)
    out["fused_vs_legacy"] = differences(cfg, params, device, as_reqs(shared, fused["fused"]["tokens"]),
                                         fused["legacy"]["tokens"])
    expect_bytes = cache_bytes(cfg, FIG9_DENSE_BATCH, FIG9_MAX_SEQ, torch.bfloat16)
    emit({"phase": "fig9", "summary": {
        "launches": launches, "dense_cache_bytes": dense["cache_bytes"], "expected_dense_cache_bytes": expect_bytes,
        "paged_cache_bytes": paged["cache_bytes"], "peak_active": {"dense": dense["peak_active"],
                                                                   "paged": paged["peak_active"]},
        "dense_vs_paged": out["dense_vs_paged"], "fused_vs_legacy": out["fused_vs_legacy"],
        "tie_limit": FIG9_TIE_TOL, "control": "ring_one_slot_off", "control_vs_dense": out["control_vs_dense"],
        "ngram_acceptance_rate": arms["spec_ngram"].get("acceptance_rate"),
        "ngram_tokens_per_verify": arms["spec_ngram"].get("accepted_per_step"),
    }})
    if dense["cache_bytes"] != expect_bytes or paged["cache_bytes"] > dense["cache_bytes"]:
        fail(f"fig9: cache bytes dense {dense['cache_bytes']} (expected {expect_bytes}), paged {paged['cache_bytes']}")
    for name, s in arms.items():
        if not all(r == "length" for r in s["finish_reasons"]):
            fail(f"fig9 {name}: requests did not all finish by length: {s['finish_reasons']}")
        if s.get("alloc_blocks_in_use", 0) != 0:
            fail(f"fig9 {name}: {s['alloc_blocks_in_use']} blocks in use after the drain")
        if abs(s["request_joules"] - s["energy_joules"]) > JOULES_REL * s["energy_joules"] or s["energy_joules"] <= 0:
            fail(f"fig9 {name}: requests' joules {s['request_joules']} against the engine's {s['energy_joules']}")
    for kind in ("dense", "paged"):
        if arms[f"{kind}_profiled"]["tokens"] != arms[kind]["tokens"]:
            fail(f"fig9: the profiled {kind} run's tokens differ from the unprofiled run's")
    if not all(d["near_tie"] for d in out["dense_vs_paged"] + out["fused_vs_legacy"]):
        fail(f"fig9: tokens differ away from a near-tie: {out['dense_vs_paged']} {out['fused_vs_legacy']}")
    if all(d["near_tie"] for d in out["control_vs_dense"]):
        fail(f"fig9: the control (rings one slot off) passes the tie gate: {out['control_vs_dense']}")
    cached, uncached = arms["prefix_cached"], arms["prefix_uncached"]
    if not (2 * cached["prefill_tokens"] <= uncached["prefill_tokens"] and cached["prefix_hit_rate"] > 0):
        fail(f"fig9: cached prefill tokens {cached['prefill_tokens']} against {uncached['prefill_tokens']}, "
             f"hit rate {cached['prefix_hit_rate']}")
    if not arms["spec_draft"]["accepted_per_step"] > 1.0:
        fail(f"fig9: the self-draft emits {arms['spec_draft']['accepted_per_step']} tokens per slot-step")
    if not (launches["paged_decode"] > 0 and launches["paged_prefill"] > 0):
        fail(f"fig9: the paged arms launched no K1 or no K2: {launches}")
    return out


# ---------------------------------------------------------------------------
# phase 5h: the always-on front-ends
# ---------------------------------------------------------------------------

# the serving_fused phase's engine settings
FRONTEND_ENGINE = dict(max_batch=4, max_seq=512, block_size=BLOCK_SIZE, prefill_budget=128,
                       cache_dtype=torch.bfloat16, fused=True, attn_impl="kernel")
ROUTER_SYSTEM_LEN = 3 * BLOCK_SIZE  # the harness's tenant system prompts: 3 full blocks
POLL_S = 0.05  # the frontend phase's /stats, /metrics and /healthz polls


def same_up_to_ties(cfg, params, device, prompts, tokens, reference, found=None) -> bool:
    """Token identity on the card: every request's tokens as many as the
    reference's and equal to them, or first different where the
    reference's top-2 logit gap is below ``PATH_TOL`` (``differences``).
    ``found`` collects each call's differences."""
    from types import SimpleNamespace

    reqs = [SimpleNamespace(prompt=p, generated=t) for p, t in zip(prompts, tokens)]
    differ = differences(cfg, params, device, reqs, reference)
    if found is not None:
        found.append(differ)
    lengths = len(tokens) == len(reference) and all(len(a) == len(b) for a, b in zip(tokens, reference))
    return lengths and all(d["near_tie"] for d in differ)


def seed_one_off(router_cls):
    """The control of the failover gate: a router whose resume seeds the
    delivered tokens one position late (the prompt's last token first, the
    last delivered token left out), so a failed-over request continues
    from a context shifted by one."""

    class SeedOneOff(router_cls):
        def _place(self, rreq, rep):
            super()._place(rreq, rep)
            if rreq.generated:
                rreq.engine_req.generated = [rreq.prompt[-1]] + rreq.generated[:-1]

    return SeedOneOff


async def read_response(reader, t0: float, *, on_first=None, drop_after_first=False) -> dict:
    """One HTTP response: its status and either its SSE frames (event,
    data, seconds since ``t0``) or its body (JSON or text)."""
    import asyncio

    head = (await reader.readuntil(b"\r\n\r\n")).decode()
    out = {"status": int(head.split(" ", 2)[1])}
    if "text/event-stream" not in head:
        body = (await reader.read()).decode()
        out["body"] = json.loads(body) if "application/json" in head else body
        return out
    out["frames"] = []
    while True:
        try:
            block = (await reader.readuntil(b"\n\n")).decode()
        except asyncio.IncompleteReadError:
            return out  # the stream ended without a done frame
        fields = dict(ln.split(": ", 1) for ln in block.strip().split("\n"))
        out["frames"].append((fields["event"], json.loads(fields["data"]), time.perf_counter() - t0))
        if fields["event"] == "token" and len(out["frames"]) == 1 and on_first is not None:
            on_first()
        if fields["event"] == "done" or drop_after_first:
            return out


async def send(reader, writer, method: str, path: str, payload=None, **kw) -> dict:
    """Send one request on an open connection and read its response."""
    t0 = time.perf_counter()
    body = json.dumps(payload).encode() if payload is not None else b""
    writer.write(f"{method} {path} HTTP/1.1\r\nHost: smoke\r\nContent-Length: {len(body)}\r\n\r\n".encode() + body)
    await writer.drain()
    try:
        return await read_response(reader, t0, **kw)
    finally:
        writer.close()
        try:
            await writer.wait_closed()
        except ConnectionError:
            pass


async def http_call(port: int, method: str, path: str, payload=None, **kw) -> dict:
    import asyncio

    return await send(*await asyncio.open_connection("127.0.0.1", port), method, path, payload, **kw)


def stream_readings(r: dict) -> dict:
    """Tokens of one SSE response, whether its token frames are contiguous
    by ``index``, its done frame, and the client's TTFT and TPOT from the
    frames' arrival times."""
    tokens, times = [], []
    contiguous = r["status"] == 200
    for event, data, t in r.get("frames", []):
        if event == "token":
            contiguous &= data["index"] == len(tokens)
            tokens += data["tokens"]
            times += [t] * len(data["tokens"])
    frames = r.get("frames", [])
    done = frames[-1][1] if frames and frames[-1][0] == "done" else None
    return {"tokens": tokens, "contiguous": contiguous, "done": done, "ttft_s": times[0] if times else None,
            "tpot_s": (times[-1] - times[0]) / (len(times) - 1) if len(times) > 1 else None}


async def serve_and_drive(engine, prompts, max_new: int, *, whole=None, dropped=None, poll=False) -> dict:
    """``serve_http`` over ``engine`` on a loopback port, driven by one SSE
    client per prompt, all at once, plus optionally a ``"stream": false``
    request of ``whole``, a client that closes its socket after the first
    token frame of ``dropped``, and ``/stats``, ``/metrics`` and
    ``/healthz`` polls every ``POLL_S``.  Once every SSE client has its
    first token the service is told to shut down (``shutdown_event``): on
    two connections opened before, a ``/healthz`` probe and a new request
    are sent once the drain began."""
    import asyncio

    from repro_torch.serving.http import serve_http

    stop = asyncio.Event()
    ready = asyncio.get_running_loop().create_future()
    server = asyncio.create_task(serve_http(engine, port=0, shutdown_event=stop, drain_timeout_s=300.0,
                                            on_ready=ready.set_result))
    front = await ready
    port = front.port
    all_first = asyncio.Event()
    firsts = []

    def first():
        firsts.append(time.perf_counter())
        if len(firsts) == len(prompts):
            all_first.set()

    polls = []

    async def poller():
        while True:
            for path in ("/stats", "/metrics", "/healthz"):
                if stop.is_set():
                    return
                try:
                    r = await http_call(port, "GET", path)
                except ConnectionError:
                    return  # the acceptor closed
                graphs = r["body"].get("graphs_captured", 0) if path == "/stats" else None
                polls.append({"path": path, "status": r["status"], "graphs_captured": graphs,
                              "draining": front.async_engine.draining})
            await asyncio.sleep(POLL_S)

    t0 = time.perf_counter()
    polling = asyncio.create_task(poller()) if poll else None
    gen = "/v1/generate"
    clients = [asyncio.create_task(http_call(port, "POST", gen, {"prompt": p, "max_new_tokens": max_new},
                                             on_first=first)) for p in prompts]
    extra = {}
    if whole is not None:
        extra["whole"] = asyncio.create_task(http_call(
            port, "POST", gen, {"prompt": whole, "max_new_tokens": max_new, "stream": False}))
    if dropped is not None:
        extra["dropped"] = asyncio.create_task(http_call(
            port, "POST", gen, {"prompt": dropped, "max_new_tokens": max_new}, drop_after_first=True))
    await all_first.wait()
    probes = [await asyncio.open_connection("127.0.0.1", port) for _ in range(2)]
    stop.set()
    while not front.async_engine.draining:
        await asyncio.sleep(0.001)
    inflight = sum(not c.done() for c in clients)
    healthz = await send(*probes[0], "GET", "/healthz")
    late = await send(*probes[1], "POST", gen, {"prompt": prompts[0][:8], "max_new_tokens": 2})
    streams = await asyncio.gather(*clients)
    extra = {k: await t for k, t in extra.items()}
    if polling is not None:
        await polling
    await server
    return {"streams": [stream_readings(r) for r in streams], "extra": extra, "polls": polls,
            "healthz_draining": healthz, "late_submission": late, "inflight_at_drain": inflight,
            "wall_s": time.perf_counter() - t0, "async_engine": front.async_engine}


def frontend_phase(cfg, params, device, legacy_tokens, max_new_tokens=32) -> dict:
    """The serving phase's 8 prompts through the HTTP/SSE service
    (``serve_http`` over an ``AsyncEngine`` over a fresh fused engine with
    ``serving_fused``'s settings), 8 concurrent SSE clients, one
    ``"stream": false`` request of the first prompt, one client that drops
    its socket after its first token, ``/stats``, ``/metrics`` and
    ``/healthz`` polls while the engine captures its graphs, then a
    graceful drain with requests still in flight.

    Gates: every stream's token frames are contiguous by ``index`` and end
    in ``done`` after 32 tokens by length; the streams' tokens (and the
    whole request's) equal the serving phase's up to near-ties; the dropped
    client's request finishes ``"cancelled"``; every poll before the drain
    answers 200 and some ``/stats`` poll lands between the first and the
    last capture; while draining, ``/healthz`` and a new request get 503
    on connections opened before it; after the drain no block is in use
    and allocations equal frees; every step ran on one stepping thread,
    gone after the drain; the replays ran K1 and K2."""
    import asyncio
    import gc

    from repro_torch.kernels import paged_attention as K
    from repro_torch.serving import InferenceEngine

    prompts = serving_prompts(cfg, SEED)
    dropped = serving_prompts(cfg, SEED + 3)[0]
    gc.collect()  # what earlier phases left in cycles, out of this phase's peak
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    eng = InferenceEngine(cfg, params, eos_token=cfg.padded_vocab, device=device, **FRONTEND_ENGINE)
    K.reset_launches()  # the main path's run starts here
    run = asyncio.run(serve_and_drive(eng, prompts, max_new_tokens, whole=prompts[0], dropped=dropped, poll=True))
    eager = dict(K.LAUNCHES)  # the captures' warm-up runs
    aeng = run.pop("async_engine")
    graphs = eng._graphs
    s = eng.stats()
    streams = run["streams"]
    whole = run["extra"]["whole"]
    dropped_reasons = [r.finish_reason for r in eng.done if r.prompt == dropped]
    by_id = {r.req_id: r for r in eng.done}
    served = [by_id[st["done"]["req_id"]] for st in streams if st["done"]]  # the SSE clients' requests
    found = []
    sound = same_up_to_ties(cfg, params, device, prompts + prompts[:1],
                            [st["tokens"] for st in streams] + [whole["body"]["tokens"]],
                            legacy_tokens + legacy_tokens[:1], found)
    stats_polls = [p for p in run["polls"] if p["path"] == "/stats"]
    during_capture = sum(0 < p["graphs_captured"] < graphs.captures for p in stats_polls)
    before_drain = sorted({p["status"] for p in run["polls"] if not p["draining"]})
    out = {
        "phase": "frontend", "model": cfg.name, "clients": len(prompts), "max_new_tokens": max_new_tokens,
        "wall_s": run["wall_s"],
        "client_ttft_p50_s": float(np.median([st["ttft_s"] for st in streams])),
        "client_tpot_p50_s": float(np.median([st["tpot_s"] for st in streams])),
        "engine_ttft_p50_s": float(np.median([r.ttft for r in served])),
        "engine_tpot_p50_s": float(np.median([r.tpot for r in served])),
        "dispatches_per_step": s["dispatches_per_step"], "host_syncs_per_step": s["host_syncs_per_step"],
        "ticks": tick_kinds(eng, float("-inf")),
        "graphs_captured": graphs.captures, "capture_s": graphs.capture_s,
        "replay_launches": dict(graphs.launches), "eager_launches": eager,
        "step_threads": sorted(aeng.step_threads), "stepping_thread_shut_down": aeng._executor is None,
        "polls": len(run["polls"]), "stats_polls_during_capture": during_capture,
        "poll_statuses_before_drain": before_drain,
        "inflight_at_drain": run["inflight_at_drain"],
        "healthz_draining": run["healthz_draining"], "late_submission": run["late_submission"],
        "dropped_finish": dropped_reasons, "whole": {k: v for k, v in whole["body"].items() if k != "tokens"},
        "done_reasons": [st["done"]["reason"] if st["done"] else None for st in streams],
        "alloc_blocks_in_use": s["alloc_blocks_in_use"], "allocs": s["alloc_total_allocs"],
        "frees": s["alloc_total_frees"], "requests_aborted": s["requests_aborted"],
        "differences": found[0], "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
    }
    emit(out)
    if not all(st["contiguous"] and st["done"] and st["done"]["reason"] == "length"
               and len(st["tokens"]) == max_new_tokens for st in streams):
        fail(f"frontend: a stream is not contiguous or did not end by length: {out['done_reasons']}")
    if whole["status"] != 200 or whole["body"]["reason"] != "length" or not sound:
        fail(f"frontend: tokens differ from the serving phase's away from a near-tie: {found}")
    if dropped_reasons != ["cancelled"]:
        fail(f"frontend: the dropped client's request finished {dropped_reasons}")
    if before_drain != [200] or during_capture < 1:
        fail(f"frontend: polls answered {before_drain}, {during_capture} /stats polls between captures")
    if run["healthz_draining"]["status"] != 503 or run["late_submission"]["status"] != 503:
        fail(f"frontend: while draining /healthz gave {run['healthz_draining']}, a new request "
             f"{run['late_submission']}")
    if s["alloc_blocks_in_use"] != 0 or s["alloc_total_allocs"] != s["alloc_total_frees"]:
        fail(f"frontend: {s['alloc_blocks_in_use']} blocks in use after the drain, "
             f"{s['alloc_total_allocs']} allocs against {s['alloc_total_frees']} frees")
    if len(aeng.step_threads) != 1 or "MainThread" in aeng.step_threads or aeng._executor is not None:
        fail(f"frontend: steps ran on {aeng.step_threads}")
    if not (graphs.launches["paged_decode"] > 0 and graphs.launches["paged_prefill"] > 0):
        fail(f"frontend: the graph replays ran no K1 or no K2: {graphs.launches}")
    del eng, aeng, graphs  # the engine and its graphs hold cycles
    gc.collect()
    torch.cuda.empty_cache()
    return out


def fleet_launches(rows) -> dict:
    """K1/K2 launches of the router arms' replicas: eager calls (the
    captures' warm-ups) and graph replays, summed over replicas and arms."""
    out = {"eager": {}, "replays": {}}
    for row in rows:
        for rid, stats in row["per_replica"].items():
            for name, n in row["replica_launches"][rid].items():
                out["eager"][name] = out["eager"].get(name, 0) + n
            for name, n in stats.get("graph_launches", {}).items():
                out["replays"][name] = out["replays"].get(name, 0) + n
    return out


def router_phase(cfg, params, device, legacy_tokens, max_new_tokens=32) -> dict:
    """``repro_torch.benchmarks.llm_inference.run_router`` at full width
    with ``serving_fused``'s engine settings: 1 replica, 2 with affinity,
    2 with random routing, 2 with replica 0 crashed halfway through the
    affinity arm's steps, on the harness's tenant prompts with 3-block (96
    token) system prompts.  Its gates are the reference's with token
    identity up to near-ties (``same_up_to_ties``): no lost request, at
    least one failover, replica 0 dead, affinity's hit rate above random's
    and the modelled scaling (on the virtual clock, where replicas run in
    parallel; on one card they step in turns, so no wall-clock scaling is
    claimed).  The control: the failover arm again under a router that
    resumes one position off (``seed_one_off``), which the token gate must
    reject.  Then a 2-replica ``Router`` behind ``serve_http`` serves 4 SSE
    requests (two prompt families, one a replica), drained gracefully."""
    import asyncio
    import gc

    from repro_torch.benchmarks import llm_inference as bench
    from repro_torch.kernels import paged_attention as K
    from repro_torch.serving import FaultPlan, ManualClock, Router

    prompts = bench.tenant_prompts(system_len=ROUTER_SYSTEM_LEN)
    kw = dict(FRONTEND_ENGINE, eos_token=cfg.padded_vocab)
    found = []

    def same(tokens, reference):
        return same_up_to_ties(cfg, params, device, prompts, tokens, reference, found)

    K.reset_launches()  # the router arms start here
    rows = bench.run_router(cfg, params, device=device, prompts=prompts, same_tokens=same, **kw)
    launches = fleet_launches(rows)  # the replicas' own: the token checks' K2 calls are not counted
    arms = {r["name"].removeprefix("llm_inference_router_"): r for r in rows}
    keys = ("tok_per_s", "wall_tok_per_s", "wall_s", "makespan_s", "prefix_hit_rate", "failovers", "retries",
            "replica_states", "requests_done", "requests_failed", "tokens_out", "prefill_tokens", "peak_mem_bytes",
            "replica_steps", "crash_at_step")
    out = {"phase": "router", "model": cfg.name, "requests": len(prompts), "time_base": rows[0]["time_base"],
           "arms": {name: {k: r.get(k) for k in keys} for name, r in arms.items()},
           "speedup_vs_single_modelled": arms["affinity"]["speedup_vs_single"],
           "wall_speedup_vs_single": arms["affinity"]["wall_tok_per_s"] / arms["single"]["wall_tok_per_s"],
           "launches": launches, "differences": found}
    for name, r in out["arms"].items():
        emit({"phase": "router", "arm": name, **r})

    # the control: the failover arm resumed one position off
    clock = ManualClock()
    control = bench.make_router(cfg, params, 2, clock=clock, router_cls=seed_one_off(Router), device=device,
                                fault_plans={0: FaultPlan(crash_at_step=arms["failover"]["crash_at_step"])}, **kw)
    cs, control_tokens = bench.drive_router(control, clock, prompts)
    del control
    gc.collect()
    torch.cuda.empty_cache()
    control_found = []
    control_passes = same_up_to_ties(cfg, params, device, prompts, control_tokens, arms["single"]["tokens"],
                                     control_found)
    out["control"] = {"failovers": cs["failovers"], "differences": control_found[0], "passes": control_passes}

    # the --replicas 2 --http path: a fleet behind the HTTP/SSE service
    http_prompts = serving_prompts(cfg, SEED)[:2] + serving_prompts(cfg, SEED + 2)[:2]
    fleet = bench.make_router(cfg, params, 2, clock=None, device=device, **kw)
    K.reset_launches()  # the fleet's service starts here
    run = asyncio.run(serve_and_drive(fleet, http_prompts, max_new_tokens))
    aeng = run.pop("async_engine")
    fs = fleet.stats()
    http_launches = fleet_launches([{"per_replica": fs["per_replica"],
                                     "replica_launches": {r.id: r.launches for r in fleet.replicas}}])
    http_found = []
    http_sound = same_up_to_ties(cfg, params, device, http_prompts[:2], [st["tokens"] for st in run["streams"][:2]],
                                 legacy_tokens[:2], http_found)
    out["http"] = {
        "requests": len(http_prompts), "wall_s": run["wall_s"],
        "client_ttft_p50_s": float(np.median([st["ttft_s"] for st in run["streams"]])),
        "client_tpot_p50_s": float(np.median([st["tpot_s"] for st in run["streams"]])),
        "done_reasons": [st["done"]["reason"] if st["done"] else None for st in run["streams"]],
        "replica_states": fs["replica_states"], "failovers": fs["failovers"],
        "served_per_replica": {i: s["requests_done"] for i, s in fs["per_replica"].items()},
        "blocks_in_use": {i: s["alloc_blocks_in_use"] for i, s in fs["per_replica"].items()},
        "launches": http_launches, "step_threads": sorted(aeng.step_threads),
        "healthz_draining": run["healthz_draining"], "inflight_at_drain": run["inflight_at_drain"],
        "differences": http_found[0],
    }
    del fleet, aeng
    gc.collect()
    torch.cuda.empty_cache()
    emit({"phase": "router", "summary": {k: v for k, v in out.items() if k != "arms"}})
    if control_passes or cs["failovers"] < 1:
        fail(f"router: the control (resume one position off) passes the token gate: {out['control']}")
    h = out["http"]
    if not all(st["contiguous"] and st["done"] and st["done"]["reason"] == "length" for st in run["streams"]):
        fail(f"router http: a stream is not contiguous or did not end by length: {h['done_reasons']}")
    if not http_sound:
        fail(f"router http: tokens differ from the serving phase's away from a near-tie: {http_found}")
    if set(h["replica_states"].values()) != {"healthy"} or min(h["served_per_replica"].values()) < 1:
        fail(f"router http: replicas {h['replica_states']}, served {h['served_per_replica']}")
    if any(h["blocks_in_use"].values()) or run["healthz_draining"]["status"] != 503 or len(h["step_threads"]) != 1:
        fail(f"router http: blocks {h['blocks_in_use']}, healthz while draining {run['healthz_draining']}, "
             f"threads {h['step_threads']}")
    for what, counts in (("arms", launches), ("http", http_launches)):
        if not (counts["replays"].get("paged_decode", 0) > 0 and counts["replays"].get("paged_prefill", 0) > 0):
            fail(f"router {what}: the graph replays ran no K1 or no K2: {counts}")
    return out


# ---------------------------------------------------------------------------
# phase 4: kernel path against plain path at full width
# ---------------------------------------------------------------------------


def path_phase(cfg, params, device) -> dict:
    from repro_torch.models import decode_step, init_paged_cache, prefill_step

    rng = np.random.default_rng(SEED + 1)
    tokens = torch.tensor(rng.integers(0, cfg.vocab_size, 2 * PREFILL_C + 1), dtype=torch.int32, device=device)
    B, nb = 4, NB
    row = torch.arange(1, nb + 1, dtype=torch.int32, device=device)[None]
    logits = {}
    for impl in ("kernel", "plain"):
        cache = init_paged_cache(cfg, 1 + B * nb, BLOCK_SIZE, B, nb, torch.bfloat16, device=device)
        outs = []
        for start in (0, PREFILL_C):  # the second chunk attends over the first
            lg, cache = prefill_step(
                cfg, params, cache, tokens[None, start : start + PREFILL_C],
                torch.tensor([start], dtype=torch.int32, device=device), row, attn_impl=impl,
            )
            outs.append(lg)
        cache["tbl"][0] = row[0]  # slot 0 decodes, slots 1-3 stay null
        tok = torch.zeros((B, 1), dtype=torch.int32, device=device)
        tok[0, 0] = tokens[2 * PREFILL_C]
        pos = torch.zeros((B,), dtype=torch.int32, device=device)
        pos[0] = 2 * PREFILL_C
        lg, cache = decode_step(cfg, params, cache, tok, pos, attn_impl=impl)
        outs.append(lg[:1])
        logits[impl] = outs
    errs = [float((a - b).abs().max()) for a, b in zip(logits["kernel"], logits["plain"])]
    finite = all(bool(torch.isfinite(t).all()) for t in logits["kernel"])
    out = {
        "phase": "path", "model": cfg.name, "calls": ["prefill@0", f"prefill@{PREFILL_C}", f"decode@{2 * PREFILL_C}"],
        "max_abs_err": errs, "tol": PATH_TOL, "finite": finite,
        "logits_std": float(logits["plain"][0].std()),
    }
    emit(out)
    if not finite or max(errs) >= PATH_TOL:
        fail(f"kernel path logits differ from plain path by {errs} (tol {PATH_TOL}) or are not finite")
    return out


# ---------------------------------------------------------------------------
# phase 5: where a decode step's time goes
# ---------------------------------------------------------------------------


# record_function spans of the port's code; the profiler puts each on the
# device's timeline too, beside the kernels inside it
SPANS = ("fp8_layout_copy",)


def profiled(fn, steps: int = 1) -> tuple[dict, float, float, dict]:
    """``fn()`` run ``steps`` times under ``torch.profiler``: (device ms by
    kernel name, device launches, wall ms under the profiler, device ms of
    each span of ``SPANS``), each per run."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            fn()
        torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3 / steps
    by_name: dict[str, float] = {}
    by_span = dict.fromkeys(SPANS, 0.0)
    launches = 0
    for e in prof.events():
        if e.device_type != DeviceType.CUDA:
            continue
        ms = e.time_range.elapsed_us() / 1e3 / steps
        if e.name in by_span:  # the span's range on the device, not a kernel
            by_span[e.name] += ms
        else:
            by_name[e.name] = by_name.get(e.name, 0.0) + ms
            launches += 1
    return by_name, launches / steps, wall_ms, by_span


def profile_phase(cfg, params, device, steps=5, quantize_kv=False, cache_kind="paged") -> dict:
    """The 4-slot decode step at the kernel phase's lengths: host wall time
    per step (no profiler), then device time by kernel under
    ``torch.profiler``.  Idle share = 1 - device busy / wall.  With
    ``quantize_kv`` the pools are int8 / e4m3 and read plain; with
    ``cache_kind="dense"`` the step reads the dense ring cache (4 rows of
    512 slots, each slot's history filled to its length)."""
    from repro_torch.models import decode_step, init_paged_cache
    from repro_torch.serving.kvcache import make_engine_cache

    B = len(DECODE_LENS)
    if cache_kind == "dense":
        cache = make_engine_cache(cfg, B, NB * BLOCK_SIZE, torch.bfloat16, device=device)
        for b, n in enumerate(DECODE_LENS):
            cache["pos"][:, b, : n - 1] = torch.arange(n - 1, dtype=torch.int32, device=device)
    else:
        cache = init_paged_cache(cfg, 1 + B * NB, BLOCK_SIZE, B, NB, torch.bfloat16, quantized=quantize_kv,
                                 device=device)
        cache["tbl"].copy_(torch.arange(1, 1 + B * NB, dtype=torch.int32).reshape(B, NB))
    tok = torch.zeros((B, 1), dtype=torch.int32, device=device)
    pos = torch.tensor([n - 1 for n in DECODE_LENS], dtype=torch.int32, device=device)

    def step():
        decode_step(cfg, params, cache, tok, pos)

    for _ in range(3):
        step()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(steps):
        step()
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3 / steps
    by_name, launches, _, _ = profiled(step, steps)
    busy = sum(by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    layout = "a bf16 ring cache" if cache_kind == "dense" else f"{quantize_kv or 'bf16'} pools"
    out = {
        "phase": "profile", "model": cfg.name,
        "what": f"decode_step, 4 slots, {layout}, fp32 weights",
        "wall_ms": wall_ms, "device_busy_ms": busy if by_name else None,
        "idle_share": 1.0 - busy / wall_ms if by_name else None,
        "device_launches_per_step": launches,
        "paged_decode_ms": sum(v for k, v in by_name.items() if "paged_decode_kernel" in k),
        "top_kernels_ms": [[name[:90], ms] for name, ms in top],
    }
    emit(out)
    return out


# ---------------------------------------------------------------------------
# phase 2b: K3 and K4 against their plain versions
# ---------------------------------------------------------------------------

# K3 cases: name, (B, H, KV, Sq, Skv, hd), dtype, causal, window, softcap,
# q scale.  The first is the training path's shape (olmo-1b, batch 4 x 2048
# tokens).  The softcap case scales q by 8 so that the scores (standard
# deviation 8) reach the cap: at scale 1 a cap of 30 moves a score by only
# about s^3/2700.  hubert-xlarge (16 heads of 80, a bidirectional encoder)
# and stablelm-12b (32 heads of 160 over 8 kv heads) have head dims that TMA
# pads to a multiple of 64.  The no-key cases (Sq > Skv with a window)
# hold rows >= 256 + 63 that see no key, where the Pallas kernel averages V
# over all keys.
FLASH_CASES = [
    ("olmo-1b", (4, 16, 16, 2048, 2048, 128), torch.bfloat16, True, 0, 0.0, 1.0),
    ("gqa-32/8", (1, 32, 8, 2048, 2048, 128), torch.bfloat16, True, 0, 0.0, 1.0),
    ("window-256", (4, 16, 16, 2048, 2048, 128), torch.bfloat16, True, 256, 0.0, 1.0),
    ("gemma-7b-softcap", (1, 16, 16, 2048, 2048, 256), torch.bfloat16, True, 0, 30.0, 8.0),
    ("olmo-1b-fp32", (1, 16, 16, 2048, 2048, 128), torch.float32, True, 0, 0.0, 1.0),
    ("ragged-1000", (2, 16, 16, 1000, 1000, 128), torch.bfloat16, True, 0, 0.0, 1.0),
    ("hubert-xlarge-hd80", (2, 16, 16, 1500, 1500, 80), torch.bfloat16, False, 0, 0.0, 1.0),
    ("stablelm-12b-hd160", (1, 32, 8, 2048, 2048, 160), torch.bfloat16, True, 0, 0.0, 1.0),
    ("no-key", (1, 4, 2, 512, 256, 128), torch.bfloat16, True, 64, 0.0, 1.0),
    ("no-key-fp32", (1, 4, 2, 512, 256, 128), torch.float32, True, 64, 0.0, 1.0),
]
# K3 against its plain version.  Both keep scores and the sums in fp32 and P
# at fp32 accuracy (the bf16 kernel carries P as two bf16 terms, good to
# about 2^-17) and differ only in the order of the sums, far below a bf16
# spacing.  So with bf16 outputs the two roundings differ by at most one
# bf16 spacing of the row's largest |output|, and only where the fp32 values
# straddle a rounding boundary; with fp32 outputs sums of up to 2048 terms
# in another order differ by tens of fp32 spacings of it.  The mean error
# relative to the mean |output| then stays near 1e-6.  The controls,
# computed in every run, are the plain version with P rounded to bf16
# before P.V and, in the softcap case, without the cap; the limits lie
# between the readings of the sound runs and of the controls on the H100
# (PERF.md), and the script fails if a control passes the checks.
FLASH_MAX_SPACINGS = {torch.bfloat16: 1.0, torch.float32: 512.0}
FLASH_MEAN_RTOL = 2e-5

TRAIN_B, TRAIN_S = 4, 2048  # 8192 tokens per step
# K4 cases at M = 8192 tokens: name, (M, K, N), operand dtypes, transposes
D_MODEL, D_FF, M_TOK = 2048, 8192, TRAIN_B * TRAIN_S
GEMM_CASES = [
    ("fwd attn_q/k/v/o", (M_TOK, D_MODEL, D_MODEL), ("e4m3", "e4m3"), (False, False)),
    ("fwd ffn_up/gate", (M_TOK, D_MODEL, D_FF), ("e4m3", "e4m3"), (False, False)),
    ("fwd ffn_down", (M_TOK, D_FF, D_MODEL), ("e4m3", "e4m3"), (False, False)),
    ("bwd dx attn_q/k/v/o: g @ w.T", (M_TOK, D_MODEL, D_MODEL), ("e5m2", "e4m3"), (False, True)),
    ("bwd dw attn_q/k/v/o: x.T @ g", (D_MODEL, M_TOK, D_MODEL), ("e4m3", "e5m2"), (True, False)),
    ("bwd dx ffn_up/gate: g @ w.T", (M_TOK, D_FF, D_MODEL), ("e5m2", "e4m3"), (False, True)),
    ("bwd dw ffn_up/gate: x.T @ g", (D_MODEL, M_TOK, D_FF), ("e4m3", "e5m2"), (True, False)),
    ("bwd dx ffn_down: g @ w.T", (M_TOK, D_MODEL, D_FF), ("e5m2", "e4m3"), (False, True)),
    ("bwd dw ffn_down: x.T @ g", (D_FF, M_TOK, D_MODEL), ("e4m3", "e5m2"), (True, False)),
    ("ragged", (1000, 1000, 1000), ("e4m3", "e4m3"), (False, False)),
]
# K4 against its plain version: its products are exact and its sums fp32,
# so only the order of the fp32 sums differs; relative to the output's
# largest magnitude.  The control, computed in every case, is the plain GEMM
# without its last 32 k-elements; the script fails if it passes.  Each case
# also reads torch._scaled_mm's error against the plain version.
GEMM_RTOL = 1e-5


def flash_work(B, H, KV, Sq, Skv, hd, itemsize, causal, window) -> tuple[int, int]:
    """(bytes, operations) of one call: q, k, v read once, the output written
    once; 4 hd operations (QK^T and PV multiply-adds) per visible (query,
    key) pair, and the mean of V over all Skv keys for a row that sees no
    key."""
    r = np.arange(Sq)
    lo = np.maximum(0, r - window + 1) if window else np.zeros_like(r)
    hi = np.minimum(Skv, r + 1) if causal else np.full_like(r, Skv)
    seen = np.maximum(0, hi - lo)
    ops = int(seen.sum()) * 4 * hd + int((seen == 0).sum()) * Skv * hd
    nbytes = (2 * B * H * Sq * hd + 2 * B * KV * Skv * hd) * itemsize
    return nbytes, B * H * ops


def flash_passes(r, dt) -> bool:
    return r["max_spacings"] <= FLASH_MAX_SPACINGS[dt] and r["mean_rel"] <= FLASH_MEAN_RTOL


def finite_or_none(r: dict) -> dict:
    return {k: v if np.isfinite(v) else None for k, v in r.items()}


def flash_phase(device) -> dict:
    from repro_torch.kernels import flash_attention as K3
    from repro_torch.kernels.flash_attention_ref import flash_attention_plain, flash_attention_split_p, flash_errors

    main = None
    for seed, (name, (B, H, KV, Sq, Skv, hd), dt, causal, window, cap, q_scale) in enumerate(FLASH_CASES):
        g = torch.Generator(device=device).manual_seed(100 + seed)
        q = (q_scale * torch.randn((B, H, Sq, hd), generator=g, device=device)).to(dt)
        k = torch.randn((B, KV, Skv, hd), generator=g, device=device).to(dt)
        v = torch.randn((B, KV, Skv, hd), generator=g, device=device).to(dt)
        kw = dict(causal=causal, window=window, softcap=cap)
        out = K3.flash_attention_bhsd(q, k, v, **kw)
        ref = flash_attention_plain(q, k, v, **kw)
        errs = flash_errors(out, ref)
        controls = {"p_bf16": flash_errors(flash_attention_split_p(q, k, v, terms=1, **kw), ref)}
        if cap:
            controls["no_softcap"] = flash_errors(flash_attention_plain(q, k, v, causal=causal, window=window), ref)
        model_layout_equal = None
        if seed == 0:  # the model's (B, S, H, hd) tensors, strided views in the kernel
            qm, km, vm = (t.transpose(1, 2).contiguous() for t in (q, k, v))
            model_layout_equal = torch.equal(K3.flash_attention(qm, km, vm, **kw).transpose(1, 2), out)
            del qm, km, vm
        del out
        lib = lib_errors = None
        if not cap:  # SDPA has no softcap
            mask = None
            if window or (causal and Sq != Skv):
                rel = torch.arange(Sq, device=device)[:, None] - torch.arange(Skv, device=device)[None, :]
                mask = (rel >= 0) & (rel < window) if window else rel >= 0

            def lib(i, mask=mask):
                return F.scaled_dot_product_attention(q, k, v, attn_mask=mask, is_causal=causal and mask is None,
                                                      enable_gqa=H != KV)

            lib_errors = finite_or_none(flash_errors(lib(0), ref))
        del ref
        nbytes, flops = flash_work(B, H, KV, Sq, Skv, hd, q.element_size(), causal, window)
        bound_ms, bound_by = bound(nbytes, flops, BF16_FLOPS_PER_S if dt == torch.bfloat16 else FP32_FLOPS_PER_S)
        row = {
            "phase": "kernel", "kernel": "flash_attention", "case": name, "shape": [B, H, KV, Sq, Skv, hd],
            "dtype": str(dt).replace("torch.", ""), "route": K3.ROUTES[dt], "causal": causal, "window": window,
            "softcap": cap, "q_scale": q_scale, "max_abs_err": errs["max_abs"], "errors": errs, "controls": controls,
            "library_errors": lib_errors,
            "tol": {"max_spacings": FLASH_MAX_SPACINGS[dt], "mean_rel": FLASH_MEAN_RTOL},
            "model_layout_equal": model_layout_equal,
            **kernel_times(lambda i: K3.flash_attention_bhsd(q, k, v, **kw), iters=10, warmup=2),
            # the CUDA-core kernel (v1) on the same bf16 inputs, the yardstick
            "cuda_cores_ms": (timed_ms(lambda i: K3.flash_attention_cuda_cores(q, k, v, **kw), iters=5, warmup=1)
                              if dt == torch.bfloat16 else None),
            "plain_ms": timed_ms(lambda i: flash_attention_plain(q, k, v, **kw), iters=5, warmup=1),
            "library_ms": timed_ms(lib, iters=10, warmup=2) if lib else None,
            "bound_ms": bound_ms, "bound_by": bound_by,
        }
        emit(row)
        if not flash_passes(errs, dt):
            fail(f"flash_attention {name}: errors {errs} beyond {row['tol']}")
        passing = [c for c, r in controls.items() if flash_passes(r, dt)]
        if passing:
            fail(f"flash_attention {name}: the controls {passing} pass the checks, which then prove nothing")
        if model_layout_equal is False:
            fail(f"flash_attention {name}: the model layout's output differs from the (B, H, S, hd) one")
        main = main or row
        del q, k, v
        torch.cuda.empty_cache()
    return main


def rel_err(out, ref) -> float:
    """max |out - ref| over max |ref|."""
    return float((out - ref).abs().max()) / float(ref.abs().max())


def gemm_phase(device) -> dict:
    from repro_torch.fp8 import FP8_DTYPES, compute_scale, quantize, tensor_amax
    from repro_torch.fp8 import gemm as K4
    from repro_torch.fp8.gemm_ref import fp8_gemm_plain

    rows = {}
    for seed, (name, (M, K, N), (fa, fb), (ta, tb)) in enumerate(GEMM_CASES):
        g = torch.Generator(device=device).manual_seed(200 + seed)
        ops = []
        for shape, fmt, tr in (((M, K), fa, ta), ((K, N), fb, tb)):
            x = torch.randn(shape[::-1] if tr else shape, generator=g, device=device)
            sx = compute_scale(tensor_amax(x), FP8_DTYPES[fmt])
            qx = quantize(x, sx, FP8_DTYPES[fmt])
            ops.append((qx.T if tr else qx, sx))  # a transposed view, as the backward passes it
            del x
        (a, sa), (b, sb) = ops
        copies_before = K4.LAUNCHES["fp8_layout_copy"]
        out = K4.fp8_gemm(a, b, sa, sb)
        copies = K4.LAUNCHES["fp8_layout_copy"] - copies_before
        ref = fp8_gemm_plain(a, b, sa, sb)
        err = float((out - ref).abs().max())
        tol = GEMM_RTOL * float(ref.abs().max())
        # the control: the plain GEMM without its last 32 k-elements
        control = float((fp8_gemm_plain(a[:, : K - 32], b[: K - 32], sa, sb) - ref).abs().max())
        kernel_rel_err = rel_err(out, ref)
        del out
        # the operands as the kernel reads them, made outside the timing, and
        # the wrapper's layout copies on their own
        plan_a, plan_b = K4.layout_plan(a, 1), K4.layout_plan(b, 0)
        ak = K4.kmajor_copy(a, 1, plan_a[1])[:, :K] if plan_a[0] else a
        bk = K4.kmajor_copy(b, 0, plan_b[1])[:, :K].T if plan_b[0] else b

        def layout_copies(i):
            if plan_a[0]:
                K4.kmajor_copy(a, 1, plan_a[1])
            if plan_b[0]:
                K4.kmajor_copy(b, 0, plan_b[1])

        lib = lib_err = None
        if M % 16 == 0 and K % 16 == 0 and N % 16 == 0:  # torch._scaled_mm's shape rule
            a_row, b_col = a.contiguous(), b.T.contiguous().T  # its layouts, made outside the timing
            inv_a, inv_b = 1.0 / sa, 1.0 / sb

            def lib(i):
                return torch._scaled_mm(a_row, b_col, scale_a=inv_a, scale_b=inv_b, out_dtype=torch.float32)

            try:
                lib_err = float((lib(0) - ref).abs().max())
            except RuntimeError:  # an operand-type pair it does not take
                lib = None
        del ref
        bound_ms, bound_by = bound(M * K + K * N + 4 * M * N + 8, 2 * M * N * K, FP8_FLOPS_PER_S)
        row = {
            "phase": "kernel", "kernel": "fp8_gemm", "case": name, "mkn": [M, K, N], "dtypes": [fa, fb],
            "transposed": [ta, tb], "max_abs_err": err, "tol": tol, "control_err": control,
            "rel_err": kernel_rel_err, "library_max_abs_err": lib_err, "layout_copies": copies,
            # the wrapper on the operands as the path passes them, its layout
            # copies included; the kernel alone; the copies alone
            **kernel_times(lambda i: K4.fp8_gemm(a, b, sa, sb), iters=20, warmup=3),
            "kernel_alone_ms": timed_ms(lambda i: K4.fp8_gemm(ak, bk, sa, sb), iters=20, warmup=3),
            "layout_copy_ms": timed_ms(layout_copies, iters=20, warmup=3) if copies else 0.0,
            "plain_ms": timed_ms(lambda i: fp8_gemm_plain(a, b, sa, sb), iters=10, warmup=2),
            "library_ms": timed_ms(lib, iters=20, warmup=3) if lib else None,
            "bound_ms": bound_ms, "bound_by": bound_by,
        }
        emit(row)
        if not err <= tol:
            fail(f"fp8_gemm {name}: err {err} > {tol}")
        if control <= tol:
            fail(f"fp8_gemm {name}: the control (the last 32 k dropped) passes, err {control} <= {tol}")
        rows[name] = row
        del a, b, ak, bk, ops
        torch.cuda.empty_cache()
    return rows


def kernel_label(mangled: str) -> str:
    """A readable name for a kernel of K4's, K3's or K1/K2's library: its
    template arguments."""
    import re

    dtype = {"f": "fp32", "13__nv_bfloat16": "bf16"}
    if m := re.search(r"paged_prefill_tc_kernelI(f|13__nv_bfloat16)Li(\d+)E", mangled):
        return f"prefill_tensor_cores,q={dtype[m[1]]},hd_pad={m[2]}"
    if m := re.search(r"paged_(prefill_kernel|decode_cuda_cores_kernel)I(f|13__nv_bfloat16)(f|13__nv_bfloat16|S\d*_)E",
                      mangled):
        return f"{m[1].split('_')[0]}_cuda_cores,q={dtype[m[2]]},pools={'fp32' if m[3] == 'f' else 'bf16'}"
    if m := re.search(r"paged_decode_kernel_splitI(f|13__nv_bfloat16)(f|13__nv_bfloat16|S\d*_)Li(\d+)ELi(\d+)E",
                      mangled):
        return f"decode_split,q={dtype[m[1]]},pools={'fp32' if m[2] == 'f' else 'bf16'},hd_pad={m[3]},rows={m[4]}"
    if m := re.search(r"wkv6_kernel_chunkILi(\d+)ELi(\d+)E", mangled):
        return f"wkv6_chunk,n={m[1]},chunk={m[2]}"
    if m := re.search(r"wkv6_cuda_cores_kernelILi(\d+)ELi(\d+)E", mangled):
        return f"wkv6_cuda_cores,n={m[1]},chunk={m[2]}"
    if m := re.search(r"fp8_gemm_kernelILb(\d)ELb(\d)E", mangled):
        return f"a_e5m2={m[1]},b_e5m2={m[2]}"
    if m := re.search(r"flash_tc_kernelILi(\d+)E", mangled):
        return f"tensor_cores_bf16,hd_pad={m[1]}"
    if m := re.search(r"flash_fwd_kernelI(f|13__nv_bfloat16)Li(\d)E", mangled):
        return f"cuda_cores_{'fp32' if m[1] == 'f' else 'bf16'},hd<={64 * int(m[2])}"
    return mangled


def hgmma_counts(lib, op: str = "HGMMA") -> dict:
    """Tensor-core instructions in the SASS of each kernel of a library, by
    ``kernel_label``: HGMMA (warpgroup MMA on fp16/bf16 operands) or, with
    ``op="HMMA"``, the warp-level ``mma.sync`` products."""
    import re

    from repro_torch.kernels import build

    tool = os.path.join(os.path.dirname(build._nvcc()), "cuobjdump")
    sass = subprocess.run([tool, "-sass", str(lib)], capture_output=True, text=True, check=True).stdout
    counts, fn = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            fn = kernel_label(line.split("Function :", 1)[1].strip())
            counts[fn] = 0
        elif fn is not None:
            counts[fn] += bool(re.search(rf"\b{op}\b", line))
    return counts


# ---------------------------------------------------------------------------
# phases 6-9: FP8 training at full width and depth
# ---------------------------------------------------------------------------

TRAIN_STEPS = 4
# The train path: one kernel step in which every K4 call is also computed by
# the plain GEMM on the same fp8 operands and held to GEMM_RTOL of its
# output's largest magnitude, as the K4 phase holds its cases, with the same
# control (the plain GEMM without its last 32 k-elements); the script fails
# if the control passes in any call.  Then the whole step against the plain
# step from the same state: the fp8 casts of its activations turn a last-bit
# difference in a GEMM's fp32 sum into a flipped fp8 value, so any kernel
# whose sums run in another order than cuBLAS's moves the loss by about 1e-5
# (PERF.md).  An order probe (the plain GEMM with its sums in another fp32
# order, K split in halves) shows what a sound order reads; the control is
# the plain GEMM with 1/(sa sb) rounded to bf16 (up to 2^-9 off, a fault an
# epilogue could have).  Each limit lies between the kernel's and the
# probe's readings and the control's on the H100 (PERF.md); the script fails
# if the kernel or the probe passes one, or the control passes one.  The
# gradient norm does not separate them (the probe reads above the control)
# and is reported only.  Parameters are compared in units of the step's lr,
# since AdamW moves each by about lr whatever its gradient.
PATH_LIMITS = {"loss_rel": 8e-5, "param_mean_over_lr": 4.3e-3}
# flash against torch attention at full width, bf16: the torch path rounds
# the scores and P to bf16 (as the reference's einsums do), K3 keeps them in
# fp32.  The control is attention that also sees the next key, an off-by-one
# of the causal mask.  Limits set as above.
EVAL_LIMITS = {"loss_diff": 2e-4, "max_logits_diff": 0.5}


def train_run_config(fp8_gemm="kernel"):
    from repro_torch.config import ParallelConfig, PrecisionConfig, RunConfig, TrainConfig

    return RunConfig(
        arch="olmo-1b",
        train=TrainConfig(global_batch=TRAIN_B, seq_len=TRAIN_S, warmup_steps=2, total_steps=10),
        parallel=ParallelConfig(remat="full"),
        precision=PrecisionConfig(param_dtype="float32", compute_dtype="bfloat16", fp8=True, fp8_gemm=fp8_gemm),
    )


def model_flops_per_step(cfg, tokens: int, seq: int) -> float:
    """3 x the forward's matmul FLOPs (forward + backward, recompute not
    counted): per token 2 (L (4 D^2 + 3 D F) + D V) for the projections and
    the tied head, plus 2 L D S for causal attention (QK^T and PV over S/2
    keys on average)."""
    L, D, F_, V = cfg.num_layers, cfg.d_model, cfg.d_ff, cfg.padded_vocab
    per_token = 2 * (L * (4 * D * D + 3 * D * F_) + D * V) + 2 * L * D * seq
    return 3.0 * tokens * per_token


def train_phase(cfg, device):
    from repro_torch.data import make_batch_fn
    from repro_torch.fp8 import fp8_sites
    from repro_torch.fp8 import gemm as K4
    from repro_torch.train import init_train_state, make_train_step
    from repro_torch.utils.tree import tree_leaves

    run = train_run_config("kernel")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    state = init_train_state(cfg, run, SEED, device)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    step = make_train_step(cfg, run)
    batch_fn = make_batch_fn(cfg, global_batch=TRAIN_B, seq_len=TRAIN_S, seed=SEED, device=device)
    batches = [batch_fn(i) for i in range(TRAIN_STEPS + 1)]
    tokens = TRAIN_B * TRAIN_S
    flops = model_flops_per_step(cfg, tokens, TRAIN_S)
    per_step = 4 * cfg.num_layers * len(fp8_sites(cfg))  # forward, recompute, dx and dw of every site
    K4.reset_launches()  # the main path's run starts here
    steps = []
    for i in range(TRAIN_STEPS):
        before, copies_before = K4.LAUNCHES["fp8_gemm"], K4.LAUNCHES["fp8_layout_copy"]
        t0 = time.perf_counter()
        state, m = step(state, batches[i])
        loss = float(m["loss"])
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        rec = {"phase": "train_step", "step": i, "loss": loss, "ms": dt * 1e3, "tokens_per_s": tokens / dt,
               "lr": float(m["lr"]), "grad_norm": float(m["grad_norm"]),
               "k4_launches": K4.LAUNCHES["fp8_gemm"] - before,
               "k4_layout_copies": K4.LAUNCHES["fp8_layout_copy"] - copies_before}
        emit(rec)
        steps.append(rec)
        if not np.isfinite(loss) or rec["k4_launches"] != per_step:
            fail(f"train step {i}: loss {loss}, {rec['k4_launches']} K4 launches (expected {per_step})")
    launches = K4.LAUNCHES["fp8_gemm"]
    steady = steps[1:]  # step 0 builds nothing but warms the allocator
    step_s = float(np.mean([r["ms"] for r in steady])) / 1e3
    out = {
        "phase": "train", "model": cfg.name, "params": sum(t.numel() for t in tree_leaves(state.params)),
        "tokens_per_step": tokens, "steps": TRAIN_STEPS, "init_s": init_s, "k4_launches": launches,
        "k4_layout_copies": K4.LAUNCHES["fp8_layout_copy"],
        "losses": [r["loss"] for r in steps], "step_ms_mean_steps_1_3": step_s * 1e3,
        "tokens_per_s_steps_1_3": tokens / step_s, "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
        "model_tflop_per_step": flops / 1e12, "model_tflop_s": flops / step_s / 1e12,
        "bf16_peak_share": flops / step_s / BF16_FLOPS_PER_S,
        "flops_formula": "3 * T * (2 * (L * (4 D^2 + 3 D F) + D V) + 2 L D S)",
    }
    emit(out)
    return state, batches[TRAIN_STEPS], out


def clone_state(state):
    from repro_torch.train import TrainState
    from repro_torch.utils.tree import tree_map

    c = lambda t: t.clone()  # noqa: E731
    return TrainState(params=tree_map(c, state.params), opt=type(state.opt)(state.opt.step.clone(), tree_map(c, state.opt.m), tree_map(c, state.opt.v)),
                      compress_residual=None, fp8=type(state.fp8)(tree_map(c, state.fp8.amax_history), tree_map(c, state.fp8.scale), state.fp8.step.clone()))


def path_readings(r, ref) -> dict:
    lr = ref["lr"]
    diffs = [(r["params"][n] - ref["params"][n]).abs() for n in ref["params"]]
    return {"loss_rel": abs(r["loss"] - ref["loss"]) / abs(ref["loss"]),
            "grad_norm_rel": abs(r["grad_norm"] - ref["grad_norm"]) / abs(ref["grad_norm"]),
            "param_mean_over_lr": float(sum(d.sum() for d in diffs)) / sum(d.numel() for d in diffs) / lr,
            "param_max_over_lr": max(float(d.max()) for d in diffs) / lr}


def within(readings: dict, limits: dict) -> bool:
    return all(readings[k] <= v for k, v in limits.items())


def train_path_phase(cfg, state, batch):
    """One kernel step in which every K4 call is checked against the plain
    GEMM on its own operands (with the control), and whole steps with the
    plain GEMM, the control and the order probe.  Returns the kernel step's
    state."""
    from repro_torch.fp8 import fp8_gemm, fp8_sites
    from repro_torch.fp8.gemm_ref import fp8_gemm_plain
    from repro_torch.train import make_train_step

    picks = {"blocks.0.attn.wq": lambda p: p["blocks"][0]["attn"]["wq"],
             f"blocks.{cfg.num_layers - 1}.mlp.w_down": lambda p: p["blocks"][-1]["mlp"]["w_down"]}

    def run(gemm, st):  # one step with ``gemm`` as the quantized GEMMs
        new, m = make_train_step(cfg, train_run_config(gemm))(st, batch)
        return {"loss": float(m["loss"]), "grad_norm": float(m["grad_norm"]), "lr": float(m["lr"]),
                "params": {n: get(new.params).clone() for n, get in picks.items()}}, new

    def control(a, b, sa, sb):
        return fp8_gemm_plain(a, b, sa, sb) * ((1 / (sa * sb)).bfloat16().float() * (sa * sb))

    def order_probe(a, b, sa, sb):
        h = a.shape[1] // 2
        return (a[:, :h].float() @ b[:h].float() + a[:, h:].float() @ b[h:].float()) * (1.0 / (sa.float() * sb.float()))

    calls = []

    def checked(a, b, sa, sb):  # K4, the plain GEMM and the call's control on the same operands
        out = fp8_gemm(a, b, sa, sb)
        ref = fp8_gemm_plain(a, b, sa, sb)
        tol = GEMM_RTOL * float(ref.abs().max())
        dropped = fp8_gemm_plain(a[:, :-32], b[:-32], sa, sb)
        calls.append((float((out - ref).abs().max()), float((dropped - ref).abs().max()), tol,
                      [a.shape[0], a.shape[1], b.shape[1], str(a.dtype).split(".")[1], str(b.dtype).split(".")[1]]))
        return out

    plain, _ = run("plain", clone_state(state))
    ctl, _ = run(control, clone_state(state))
    probe, _ = run(order_probe, clone_state(state))
    kernel, state = run(checked, state)
    worst = max(calls, key=lambda c: c[0] / c[2])
    weakest_control = min(calls, key=lambda c: c[1] / c[2])
    out = {"phase": "train_path", "k4_calls": len(calls),
           "worst_call": {"err": worst[0], "tol": worst[2], "mkn_dtypes": worst[3]},
           "weakest_control_call": {"err": weakest_control[1], "tol": weakest_control[2], "mkn_dtypes": weakest_control[3]},
           "loss": {"kernel": kernel["loss"], "plain": plain["loss"]},
           "grad_norm": {"kernel": kernel["grad_norm"], "plain": plain["grad_norm"]}, "lr": plain["lr"],
           "kernel_vs_plain": path_readings(kernel, plain), "control_vs_plain": path_readings(ctl, plain),
           "order_probe_vs_plain": path_readings(probe, plain), "limits": PATH_LIMITS}
    emit(out)
    per_step = 4 * cfg.num_layers * len(fp8_sites(cfg))
    if len(calls) != per_step:
        fail(f"the checked kernel step made {len(calls)} K4 calls, expected {per_step}")
    if worst[0] > worst[2]:
        fail(f"a K4 call of the train step differs from the plain GEMM on its operands: {out}")
    if weakest_control[1] <= weakest_control[2]:
        fail(f"the control passes a K4 call's limit, which then proves nothing: {out}")
    if not within(out["kernel_vs_plain"], PATH_LIMITS):
        fail(f"kernel and plain train steps differ: {out}")
    if not within(out["order_probe_vs_plain"], PATH_LIMITS):
        fail(f"the order probe, a sound order of the sums, fails the train path's limits: {out}")
    for k, limit in PATH_LIMITS.items():
        if out["control_vs_plain"][k] <= limit:
            fail(f"the control step passes the train path's {k} limit, which then proves nothing: {out}")
    torch.cuda.empty_cache()
    return state


def attention_next_key(q, k, v, *, causal, window, softcap):
    """A control for the eval: causal attention in the model layout that
    also sees the next key."""
    S = q.shape[1]
    pos = torch.arange(S, device=q.device)
    mask = pos[None, :] <= pos[:, None] + 1
    return F.scaled_dot_product_attention(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                                          attn_mask=mask, enable_gqa=q.shape[2] != k.shape[2]).transpose(1, 2)


def eval_phase(cfg, params, batch) -> dict:
    from repro_torch.kernels import flash_attention as K3
    from repro_torch.models import attention, forward
    from repro_torch.train import loss_fn

    def evaluate(impl):
        K3.reset_launches()
        t0 = time.perf_counter()
        loss = float(loss_fn(cfg, params, batch, attn_impl=impl, compute_dtype=torch.bfloat16)[0])
        dt = time.perf_counter() - t0
        launches = K3.LAUNCHES["flash_attention"]
        t0 = time.perf_counter()  # the same forward again, warm
        float(loss_fn(cfg, params, batch, attn_impl=impl, compute_dtype=torch.bfloat16)[0])
        warm = time.perf_counter() - t0
        logits = forward(cfg, params, batch, attn_impl=impl, compute_dtype=torch.bfloat16)[0]
        return {"loss": loss, "wall_s": dt, "warm_wall_s": warm, "k3_launches": launches, "logits": logits}

    def readings(r):
        return {"loss_diff": abs(r["loss"] - ref["loss"]),
                "max_logits_diff": float((r["logits"] - ref["logits"]).abs().max())}

    with torch.no_grad():
        ref = evaluate("torch")
        flash = evaluate("flash")
        finite = bool(torch.isfinite(flash["logits"]).all())
        k3 = attention.flash_attention
        attention.flash_attention = attention_next_key
        try:
            control = evaluate("flash")
        finally:
            attention.flash_attention = k3
        out = {"phase": "eval", "loss": {"torch": ref["loss"], "flash": flash["loss"], "control": control["loss"]},
               "wall_s": {"torch": ref["wall_s"], "flash": flash["wall_s"]},
               "warm_wall_s": {"torch": ref["warm_wall_s"], "flash": flash["warm_wall_s"]},
               "k3_launches": flash["k3_launches"],
               "k3_launches_torch": ref["k3_launches"],
               "flash_vs_torch": readings(flash), "control_vs_torch": readings(control), "limits": EVAL_LIMITS}
        del ref, flash, control
    emit(out)
    if out["k3_launches"] != cfg.num_layers or out["k3_launches_torch"] != 0:
        fail(f"flash eval launched K3 {out['k3_launches']} times (expected {cfg.num_layers})")
    if not finite or not within(out["flash_vs_torch"], EVAL_LIMITS):
        fail(f"flash and torch attention disagree: {out}")
    if within(out["control_vs_torch"], EVAL_LIMITS):
        fail(f"the control passes the eval's limits, which then prove nothing: {out}")
    torch.cuda.empty_cache()
    return out


def train_profile_phase(cfg, state, batch) -> dict:
    from repro_torch.train import make_train_step

    step = make_train_step(cfg, train_run_config("kernel"))

    def run():
        nonlocal state
        state, m = step(state, batch)
        float(m["loss"])

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    run()  # the step's wall time, without the profiler
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    by_name, launches, prof_wall_ms, spans = profiled(run)
    busy = sum(by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:15]
    k4_ms = sum(v for k, v in by_name.items() if "fp8_gemm_kernel" in k)
    out = {
        "phase": "train_profile", "model": cfg.name, "what": "one fp8 train step, 4 x 2048 tokens, remat full",
        "wall_ms": wall_ms, "wall_ms_under_profiler": prof_wall_ms, "device_busy_ms": busy if by_name else None,
        "idle_share": 1.0 - busy / wall_ms if by_name else None,
        "idle_share_under_profiler": 1.0 - busy / prof_wall_ms if by_name else None, "device_launches": int(launches),
        "fp8_gemm_ms": k4_ms, "fp8_gemm_share": k4_ms / busy if by_name else None,
        "fp8_layout_copy_ms": spans["fp8_layout_copy"],
        "top_kernels_ms": [[name[:160], ms] for name, ms in top],
    }
    emit(out)
    return out


# ---------------------------------------------------------------------------
# phase 10: K6 (BabelStream) and K5 (RWKV6 WKV scan) against their plain versions
# ---------------------------------------------------------------------------

STREAM_N = 2**27  # elements: 512 MiB per fp32 array, the paper's BabelStream size
STREAM_KERNELS = ("copy", "mul", "add", "triad", "dot")
# dot on non-negative inputs against its plain version, relative to the
# exact-sign sum sum |a b| (then the sum itself): fp32 sums of 2^27 terms in
# another order stay near 1e-7 of it, and the control, the sum without its
# last tile's partial, is 1/2048 = 4.9e-4 short.  The limit lies between.
DOT_RTOL = 1e-5


def stream_inputs(n, dtype, device, seed):
    g = torch.Generator(device=device).manual_seed(seed)
    return [torch.randn((n,), generator=g, device=device).to(dtype) for _ in range(3)]


def stream_phase(device, n=STREAM_N) -> dict:
    """Each K6 kernel in fp32 and bf16 against its plain version (bit-equal
    but dot), timed beside its PyTorch call; returns the fp32 rows."""
    from repro_torch.kernels import babelstream as K6
    from repro_torch.kernels import babelstream_ref as ref

    rows = {}
    for seed, dt in enumerate((torch.float32, torch.bfloat16)):
        a, b, c = stream_inputs(n, dt, device, 300 + seed)
        aa, ba = a.abs(), b.abs()  # dot: a dropped tile shows against a sum of non-negative terms
        s = ref.round_scalar(0.4, dt)
        dst = torch.empty_like(a)
        calls = {
            "copy": (lambda: K6.stream_copy(a), lambda: ref.copy_ref(a), lambda: dst.copy_(a)),
            "mul": (lambda: K6.stream_mul(c), lambda: ref.mul_ref(c), lambda: torch.mul(c, s)),
            "add": (lambda: K6.stream_add(a, b), lambda: ref.add_ref(a, b), lambda: torch.add(a, b)),
            # one PyTorch call for b + s c: it rounds once in bf16 too, so only its time compares
            "triad": (lambda: K6.stream_triad(b, c), lambda: ref.triad_ref(b, c), lambda: torch.add(b, c, alpha=s)),
            "dot": (lambda: K6.stream_dot(aa, ba), lambda: ref.dot_ref(aa, ba),
                    (lambda: torch.dot(aa, ba)) if dt == torch.float32 else None),
        }
        for name in STREAM_KERNELS:
            kernel, plain, lib = calls[name]
            out, want = kernel(), plain()
            control = None
            if name == "dot":
                err = float((out - want).abs())
                tol = DOT_RTOL * float(want)
                partials = K6.dot_partials(aa, ba)
                control = abs(float(partials[:-1].sum()) - float(want))  # the last tile dropped
                ok, control_ok = err <= tol, control <= tol
            else:
                err = float((out.float() - want.float()).abs().max())
                tol = 0.0
                ok = torch.equal(out, want)
                if name == "triad" and dt == torch.bfloat16:  # the scalar left unrounded
                    unrounded = K6.launch_map("triad", b, c, 0.4)
                    control = int((unrounded != want).sum())
                    control_ok = control == 0
                    del unrounded
            torch.cuda.synchronize()
            flops = {"copy": 0, "mul": n, "add": n, "triad": 2 * n, "dot": 2 * n}[name]
            nbytes = K6.stream_bytes(name, n, a.element_size()) + (4 * (n // K6.DEFAULT_BLOCK) if name == "dot" else 0)
            bound_ms, bound_by = bound(nbytes, flops, FP32_FLOPS_PER_S)
            times = kernel_times(lambda i: kernel())
            kernel_ms = times["kernel_ms"]
            row = {
                "phase": "kernel", "kernel": f"stream_{name}", "n": n, "dtype": str(dt).replace("torch.", ""),
                "bit_equal": None if name == "dot" else ok, "max_abs_err": err, "tol": tol, "control": control,
                **times, "plain_ms": timed_ms(lambda i: plain(), iters=5, warmup=1),
                "library_ms": timed_ms(lambda i: lib()) if lib else None,
                "bound_ms": bound_ms, "bound_by": bound_by, "gbps": nbytes / 1e6 / kernel_ms,
            }
            emit(row)
            del out, want
            if not ok:
                fail(f"stream_{name} {row['dtype']}: error {err} beyond {tol}")
            if control is not None and control_ok:
                fail(f"stream_{name} {row['dtype']}: the control passes the check ({control}), which then proves nothing")
            if dt == torch.float32:
                rows[f"stream_{name}"] = row
        del a, b, c, aa, ba, dst
        torch.cuda.empty_cache()
    return rows


def babelstream_phase(device, n=STREAM_N) -> dict:
    """The Fig. 10 entry point on the card: fp32 (the counted run), then bf16."""
    from repro_torch.benchmarks import babelstream as bench
    from repro_torch.kernels import babelstream as K6

    K6.reset_launches()  # the main path's run starts here
    rows = bench.run(n=n, dtype=torch.float32, device=device)
    torch.cuda.synchronize()
    launches = dict(K6.LAUNCHES)
    rows += bench.run(n=n, dtype=torch.bfloat16, device=device)
    for r in rows:
        emit({"phase": "babelstream", **r})
    out = {"phase": "babelstream_launches", "launches": launches}
    emit(out)
    missing = [k for k, v in launches.items() if v == 0]
    if missing:
        fail(f"BabelStream's run did not launch {missing}: {launches}")
    torch.cuda.empty_cache()
    return launches


# K5 cases: name, (B, S, H, n), chunk, logw (None: -exp(N(0,1) - 1)).  The
# first is rwkv6-7b's eval shape (4 x 2048 tokens, 64 heads of 64).
WKV_CASES = [
    ("rwkv6-7b", (4, 2048, 64, 64), 64, None),
    ("small", (2, 128, 3, 16), 16, None),
    ("fast-decay", (1, 256, 4, 64), 64, -8.0),
]
# K5 against the plain version and the sequential oracle: all three in fp32,
# the sums in other orders.  Relative to the largest |output|; the control
# (the decay applied one step late in the inter-chunk term) moves whole
# outputs.  The limit lies between the readings (PERF.md).
WKV_RTOL = 1e-4


def wkv_late_decay(r, k, v, logw, u, *, chunk=64):
    """A control: the plain version on (BH, S, n) with r decayed by exp(la)
    in place of exp(la_prev) in the inter-chunk term, the decay applied one
    step late: each chunk's output gains r (exp(la) - exp(la_prev)) @ S0."""
    from repro_torch.kernels.rwkv6_scan_ref import wkv_chunk

    BH, S, n = r.shape
    state = torch.zeros((BH, n, n), dtype=torch.float32, device=r.device)
    outs = []
    for c0 in range(0, S, chunk):
        rr, kk, vv, lw = (x[:, c0 : c0 + chunk].float() for x in (r, k, v, logw))
        out, next_state = wkv_chunk(state, rr, kk, vv, lw, u.float()[:, None, :])
        la = torch.cumsum(lw, dim=1)
        outs.append(out + (rr * (torch.exp(la) - torch.exp(la - lw))) @ state)
        state = next_state
    return torch.cat(outs, dim=1)


def on_model_layout(scan):
    """A scan on (BH, S, n) as a ``wkv_impl``: (B, S, H, n) operands, u (H, n)."""

    def model_scan(r, k, v, logw, u, *, chunk):
        B, S, H, n = r.shape
        to_bh = lambda x: x.transpose(1, 2).reshape(B * H, S, n)  # noqa: E731
        out = scan(*(to_bh(x) for x in (r, k, v, logw)), u.expand(B, H, n).reshape(B * H, n), chunk=chunk)
        return out.reshape(B, H, S, n).transpose(1, 2)

    return model_scan


def wkv_work(BH, S, n) -> tuple[int, int, int]:
    """(bytes, fp32 operations, exponentials) that the scan needs in any
    formulation: r, k, v, logw and u read and the output written once; per
    token and head, r read against the state (n^2 multiply-adds) and the
    token's outer product added into it (n^2 multiply-adds, the decay
    folded over a chunk): 4 n^2 operations; one exponential per channel
    (the decay).  K5's chunked form does more: its pairwise scores take
    about L / 2 exponentials per token and channel at chunk L."""
    return 5 * BH * S * n * 4 + BH * n * 4, BH * S * 4 * n * n, BH * S * n


def wkv_bound(BH, S, n) -> tuple[float, str]:
    nbytes, flops, exps = wkv_work(BH, S, n)
    t_b, t_o = nbytes / HBM_BYTES_PER_S, max(flops / FP32_FLOPS_PER_S, exps / EXP_PER_S)
    return 1e3 * max(t_b, t_o), "bytes" if t_b >= t_o else "operations"


def wkv_phase(device, cases=WKV_CASES) -> dict:
    from repro_torch.kernels import rwkv6_scan as K5
    from repro_torch.kernels.rwkv6_scan_ref import wkv6_chunked_plain, wkv6_ref

    main = None
    for seed, (name, (B, S, H, n), chunk, logw) in enumerate(cases):
        g = torch.Generator(device=device).manual_seed(400 + seed)
        r, k, v = (0.5 * torch.randn((B, S, H, n), generator=g, device=device) for _ in range(3))
        lw = (-torch.exp(torch.randn((B, S, H, n), generator=g, device=device) - 1.0) if logw is None
              else torch.full((B, S, H, n), logw, device=device))
        u = 0.3 * torch.randn((H, n), generator=g, device=device)
        to_bh = lambda x: x.transpose(1, 2).reshape(B * H, S, n)  # noqa: E731
        bh = [to_bh(x) for x in (r, k, v, lw)]
        ub = u.expand(B, H, n).reshape(B * H, n)
        with torch.no_grad():
            out = K5.wkv6(r, k, v, lw, u, chunk=chunk)  # the model's layout, strided
            out_bh = to_bh(out)
            plain = wkv6_chunked_plain(*bh, ub, chunk=chunk)
            oracle = wkv6_ref(*bh, ub)
            control = wkv_late_decay(*bh, ub, chunk=chunk)
            layout_equal = torch.equal(K5.wkv6_chunked(*bh, ub, chunk=chunk), out_bh)
            v1 = to_bh(K5.wkv6_cuda_cores(r, k, v, lw, u, chunk=chunk))  # the yardstick
        scale = float(plain.abs().max())
        rel = lambda x, y: float((x - y).abs().max()) / scale  # noqa: E731
        mean_rel = lambda x, y: float((x - y).abs().mean() / plain.abs().mean())  # noqa: E731
        readings = {"vs_plain": rel(out_bh, plain), "vs_oracle": rel(out_bh, oracle),
                    "mean_vs_plain": mean_rel(out_bh, plain), "mean_vs_oracle": mean_rel(out_bh, oracle),
                    "control_vs_plain": rel(control, plain), "control_vs_oracle": rel(control, oracle),
                    "cuda_cores_vs_plain": rel(v1, plain)}
        finite = bool(torch.isfinite(out).all())
        del out, out_bh, plain, oracle, control, v1
        bound_ms, bound_by = wkv_bound(B * H, S, n)
        row = {
            "phase": "kernel", "kernel": "rwkv6_scan", "case": name, "shape_bshn": [B, S, H, n], "chunk": chunk,
            "max_abs_err": readings["vs_plain"] * scale, "max_abs_out": scale, "readings": readings, "tol": WKV_RTOL,
            "finite": finite, "model_layout_equal": layout_equal,
            **kernel_times(lambda i: K5.wkv6(r, k, v, lw, u, chunk=chunk), iters=10, warmup=2),
            "cuda_cores_ms": timed_ms(lambda i: K5.wkv6_cuda_cores(r, k, v, lw, u, chunk=chunk), iters=5, warmup=1),
            "plain_ms": timed_ms(lambda i: wkv6_chunked_plain(*bh, ub, chunk=chunk), iters=3, warmup=1),
            "library_ms": None,  # no single PyTorch call computes the scan
            "bound_ms": bound_ms, "bound_by": bound_by, "work": dict(zip(("bytes", "flops", "exps"), wkv_work(B * H, S, n))),
        }
        emit(row)
        if not finite or readings["vs_plain"] > WKV_RTOL or readings["vs_oracle"] > WKV_RTOL or not layout_equal:
            fail(f"rwkv6_scan {name}: {readings} beyond {WKV_RTOL}, finite {finite}, layouts equal {layout_equal}")
        if readings["cuda_cores_vs_plain"] > WKV_RTOL:
            fail(f"rwkv6_scan_cuda_cores {name}: {readings} beyond {WKV_RTOL}")
        if readings["control_vs_plain"] <= WKV_RTOL or readings["control_vs_oracle"] <= WKV_RTOL:
            fail(f"rwkv6_scan {name}: the late-decay control passes the check ({readings}), which then proves nothing")
        main = main or row
        del r, k, v, lw, u, bh, ub
        torch.cuda.empty_cache()
    return main


# ---------------------------------------------------------------------------
# phase 12: rwkv6-7b eval at full width and depth
# ---------------------------------------------------------------------------

# K5 against the chunked scan at full width.  The random-init rwkv6-7b is
# chaotic over 32 layers: noise of 1e-6 of every WKV output moves the
# logits by more than the late-decay control does (PERF.md), so the whole
# forward's loss and logits are reported, not held to a limit.  The check
# is per layer: each block gets the chunked forward's input and runs once
# with K5 and once with the chunked scan.  The readings are the largest
# over the layers of mean |difference| / mean |block increment| and of
# max |difference| / max |block increment|.  In bf16 compute (the eval's
# own) the two differ where a WKV output lands on the other side of a bf16
# rounding boundary; in fp32 compute only the scans' summation orders
# differ.  The control is the scan with the decay one step late.  Each
# limit lies between the readings of the sound run and of the control on
# the H100 (PERF.md).
RWKV_LAYER_LIMITS = {
    torch.bfloat16: {"layer_mean_rel": 1e-3, "layer_max_rel": 3.5e-2},
    torch.float32: {"layer_mean_rel": 1e-4, "layer_max_rel": 1e-3},
}
WKV_NOISE = 1e-6  # the chaos probe: relative noise on every plain WKV output


def layer_readings(cfg, params, tokens, control, dtype) -> dict:
    """Per layer, on the chunked forward's own input in ``dtype``: K5 and
    the control scan against the chunked scan (see RWKV_LAYER_LIMITS)."""
    from repro_torch.models import embed_input
    from repro_torch.models.blocks import rwkv_block

    limits = RWKV_LAYER_LIMITS[dtype]
    worst = {"sound": dict.fromkeys(limits, 0.0), "control": dict.fromkeys(limits, 0.0)}
    x = embed_input(cfg, params, tokens, None).to(dtype)
    for p in params["blocks"]:
        ref = rwkv_block(cfg, p, x, wkv_impl="chunked")
        inc = (ref.float() - x.float()).abs()
        for name, impl in (("sound", "kernel"), ("control", control)):
            d = (rwkv_block(cfg, p, x, wkv_impl=impl).float() - ref.float()).abs()
            w = worst[name]
            w["layer_mean_rel"] = max(w["layer_mean_rel"], float(d.mean() / inc.mean()))
            w["layer_max_rel"] = max(w["layer_max_rel"], float(d.max() / inc.max()))
        x = ref
    return worst


def rwkv_eval_phase(cfg, device, batch_size=TRAIN_B, seq=TRAIN_S) -> dict:
    from repro_torch.data import make_batch_fn
    from repro_torch.kernels import rwkv6_scan as K5
    from repro_torch.kernels.rwkv6_scan_ref import wkv6_chunked_plain
    from repro_torch.models import forward, init_params
    from repro_torch.train import loss_fn
    from repro_torch.utils.tree import tree_leaves

    t0 = time.perf_counter()
    params = init_params(cfg, SEED, device)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    batch = make_batch_fn(cfg, global_batch=batch_size, seq_len=seq, seed=SEED, device=device)(0)

    def evaluate(impl):
        K5.reset_launches()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        loss = float(loss_fn(cfg, params, batch, wkv_impl=impl, compute_dtype=torch.bfloat16)[0])
        dt = time.perf_counter() - t0
        launches = K5.LAUNCHES["rwkv6_scan"]
        peak = torch.cuda.max_memory_allocated() / 1e9
        logits = forward(cfg, params, batch, wkv_impl=impl, compute_dtype=torch.bfloat16)[0]
        return {"loss": loss, "wall_s": dt, "k5_launches": launches, "peak_mem_gb": peak, "logits": logits}

    def whole(r):
        return {"loss_diff": abs(r["loss"] - ref["loss"]),
                "max_logits_diff": float((r["logits"] - ref["logits"]).abs().max())}

    with torch.no_grad():
        evaluate("kernel")  # warm-up: library handles, the allocator
        ref = evaluate("chunked")
        kern = evaluate("kernel")
        finite = bool(torch.isfinite(kern["logits"]).all())
        g = torch.Generator(device=device).manual_seed(SEED)

        def noisy(*args, chunk):
            out = wkv6_chunked_plain(*args, chunk=chunk)
            return out * (1 + WKV_NOISE * torch.randn(out.shape, generator=g, device=out.device))

        noise = evaluate(on_model_layout(noisy))
        control = on_model_layout(wkv_late_decay)
        layers = {str(dt).removeprefix("torch."): layer_readings(cfg, params, batch["tokens"], control, dt)
                  for dt in RWKV_LAYER_LIMITS}
        by_name, launches, prof_wall_ms, _ = profiled(lambda: float(loss_fn(cfg, params, batch, wkv_impl="kernel",
                                                                          compute_dtype=torch.bfloat16)[0]))
        busy = sum(by_name.values())
        profile_out = {
            "wall_ms": kern["wall_s"] * 1e3, "wall_ms_under_profiler": prof_wall_ms,
            "device_busy_ms": busy if by_name else None,
            "idle_share": 1.0 - busy / (kern["wall_s"] * 1e3) if by_name else None, "device_launches": int(launches),
            "rwkv6_scan_ms": sum(v for k, v in by_name.items() if "wkv6_kernel" in k),
            "top_kernels_ms": [[name[:90], ms] for name, ms in sorted(by_name.items(), key=lambda kv: -kv[1])[:10]],
        }
        out = {"phase": "rwkv_eval", "model": cfg.name, "params": sum(t.numel() for t in tree_leaves(params)),
               "tokens": batch_size * seq, "init_s": init_s,
               "loss": {"chunked": ref["loss"], "kernel": kern["loss"]},
               "wall_s": {"chunked": ref["wall_s"], "kernel": kern["wall_s"]},
               "peak_mem_gb": {"chunked": ref["peak_mem_gb"], "kernel": kern["peak_mem_gb"]},
               "k5_launches": kern["k5_launches"], "k5_launches_chunked": ref["k5_launches"],
               "logits_std": float(ref["logits"].std()), "logits_shape": list(kern["logits"].shape),
               "whole_kernel_vs_chunked": whole(kern), "whole_noise_vs_chunked": whole(noise), "wkv_noise": WKV_NOISE,
               "layers_kernel_vs_chunked": {dt: r["sound"] for dt, r in layers.items()},
               "layers_control_vs_chunked": {dt: r["control"] for dt, r in layers.items()},
               "limits": {str(dt).removeprefix("torch."): lim for dt, lim in RWKV_LAYER_LIMITS.items()},
               "profile_kernel_eval": profile_out}
        del ref, kern, noise
    emit(out)
    if out["k5_launches"] != cfg.num_layers or out["k5_launches_chunked"] != 0:
        fail(f"rwkv eval launched K5 {out['k5_launches']} times (expected {cfg.num_layers})")
    if out["logits_shape"] != [batch_size, seq, cfg.padded_vocab]:
        fail(f"rwkv eval logits of shape {out['logits_shape']}")
    for dt, limits in out["limits"].items():
        if not finite or not np.isfinite(out["loss"]["kernel"]) or not within(out["layers_kernel_vs_chunked"][dt], limits):
            fail(f"the K5 and chunked rwkv blocks disagree in {dt}: {out}")
        if within(out["layers_control_vs_chunked"][dt], limits):
            fail(f"the control passes the rwkv eval's {dt} limits, which then prove nothing: {out}")
    del params, batch
    torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on an NVIDIA card", file=sys.stderr)
        return 2
    # imported before any output: a copy without the package prints nothing
    from repro_torch.configs import get_config
    from repro_torch.device import resolve_device
    from repro_torch.kernels import build
    from repro_torch.models import init_params

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    idle_w = []  # board power before this run puts work on the card (core.telemetry.CHIP_IDLE_W)
    for _ in range(10):
        idle_w.append(float(subprocess.run(
            ["nvidia-smi", "--query-gpu=power.draw", "--format=csv,noheader,nounits"],
            capture_output=True, text=True, check=True,
        ).stdout.split()[0]))
        time.sleep(0.2)
    emit({"phase": "card", "nvidia_smi": smi, "torch": torch.__version__, "cuda": torch.version.cuda,
          "device": torch.cuda.get_device_name(0), "idle_power_w": idle_w,
          "idle_power_median_w": float(np.median(idle_w))})

    device = resolve_device("cuda")  # also pins fp32 matmuls to full precision
    sources = ["paged_attention.cu", "fp8_gemm.cu", "flash_attention.cu", "babelstream.cu", "rwkv6_scan.cu"]

    def timed_build(src):
        t0 = time.perf_counter()
        lib, log = build.build(src, verbose=True)
        return src, time.perf_counter() - t0, lib, log

    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(sources)) as pool:  # one nvcc per source, all started together
        built = list(pool.map(timed_build, sources))
    for src, secs, lib, log in built:
        emit({"phase": "build", "source": src, "seconds": secs, "library": os.path.relpath(lib, ROOT),
              "ptxas": [ln.strip() for ln in log.splitlines() if "registers" in ln or "Compiling" in ln]})
    emit({"phase": "build", "wall_seconds": time.perf_counter() - t0})
    # K4, K3's bf16 route and K2's bf16-pool route run on the tensor cores:
    # each of K4's four kernels (one per type pair), K3's four bf16 kernels
    # (one per padded head dim) and K2's eight (q dtype x padded head dim)
    # holds HGMMA
    libs = {src: lib for src, _, lib, _ in built}
    hgmma = hgmma_counts(libs["fp8_gemm.cu"])
    emit({"phase": "sass", "source": "fp8_gemm.cu", "hgmma_per_kernel": hgmma})
    if len(hgmma) != 4 or min(hgmma.values()) == 0:
        fail(f"fp8_gemm.cu: K4 needs four kernels that each hold HGMMA: {hgmma}")
    hgmma_k3 = hgmma_counts(libs["flash_attention.cu"])
    emit({"phase": "sass", "source": "flash_attention.cu", "hgmma_per_kernel": hgmma_k3})
    k3_tc = [n for n in hgmma_k3 if n.startswith("tensor_cores_bf16")]
    if len(k3_tc) != 4 or min(hgmma_k3[n] for n in k3_tc) == 0:
        fail(f"flash_attention.cu: K3's bf16 route needs four kernels that each hold HGMMA: {hgmma_k3}")
    # K2's tensor-core route: one kernel per q dtype and padded head dim
    hgmma_k2 = hgmma_counts(libs["paged_attention.cu"])
    emit({"phase": "sass", "source": "paged_attention.cu", "hgmma_per_kernel": hgmma_k2})
    k2_tc = [n for n in hgmma_k2 if n.startswith("prefill_tensor_cores")]
    if len(k2_tc) != 8 or min(hgmma_k2[n] for n in k2_tc) == 0:
        fail(f"paged_attention.cu: K2's tensor-core route needs eight kernels that each hold HGMMA: {hgmma_k2}")

    # K5's chunk kernel takes its products on the tensor cores with mma.sync:
    # each of its nine (head size x chunk) holds HMMA
    hmma_k5 = hgmma_counts(libs["rwkv6_scan.cu"], "HMMA")
    emit({"phase": "sass", "source": "rwkv6_scan.cu", "hmma_per_kernel": hmma_k5})
    k5_tc = [n for n in hmma_k5 if n.startswith("wkv6_chunk,")]
    if len(k5_tc) != 9 or min(hmma_k5[n] for n in k5_tc) == 0:
        fail(f"rwkv6_scan.cu: K5 needs nine chunk kernels that each hold HMMA: {hmma_k5}")

    seconds = {"build": time.perf_counter() - t0}

    def phase(name, fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        torch.cuda.synchronize()
        seconds[name] = time.perf_counter() - t0
        return out

    main_rows = phase("kernel_k1_k2", kernel_phase, device)
    flash_main = phase("kernel_k3", flash_phase, device)
    gemm_rows = phase("kernel_k4", gemm_phase, device)
    stream_rows = phase("kernel_k6", stream_phase, device)
    wkv_main = phase("kernel_k5", wkv_phase, device)
    stream_launches = phase("babelstream", babelstream_phase, device)

    cfg = get_config("olmo-1b")  # full width and depth
    params = phase("init", init_params, cfg, SEED, device)
    emit({"phase": "init", "model": cfg.name, "seconds": seconds["init"]})
    serving, legacy_tokens = phase("serving", serving_phase, cfg, params, device)
    phase("path", path_phase, cfg, params, device)
    phase("profile", profile_phase, cfg, params, device)
    phase("serving_fused", serving_fused_phase, cfg, params, device, legacy_tokens)
    phase("profile_fused", profile_fused_phase, cfg, params, device)
    spec = phase("serving_spec", serving_spec_phase, cfg, params, device, legacy_tokens)
    phase("spec_rollback", spec_rollback_phase, cfg, params, device)
    phase("kv_quant_read", kv_quant_read_phase, device)
    quantized = phase("serving_quantized", serving_quantized_phase, cfg, params, device, legacy_tokens,
                      serving["pool_bytes"])
    tiered = phase("serving_tiered", serving_tiered_phase, cfg, params, device)
    phase("spill_restore", spill_restore_phase, cfg, device)
    fig9 = phase("fig9", fig9_phase, cfg, params, device)
    frontend = phase("frontend", frontend_phase, cfg, params, device, legacy_tokens)
    router = phase("router", router_phase, cfg, params, device, legacy_tokens)
    del params  # the serving model's memory goes back before training
    torch.cuda.empty_cache()

    state, batch, train = phase("train", train_phase, cfg, device)
    state = phase("train_path", train_path_phase, cfg, state, batch)
    evaluation = phase("eval", eval_phase, cfg, state.params, batch)
    phase("train_profile", train_profile_phase, cfg, state, batch)
    del state, batch  # the olmo-1b training state's memory goes back before rwkv6-7b
    torch.cuda.empty_cache()

    rwkv = phase("rwkv_eval", rwkv_eval_phase, get_config("rwkv6-7b"), device)
    emit({"phase": "seconds", **seconds})

    src = "src/repro_torch/kernels/csrc/"
    kernels = []
    for name, row in main_rows.items():
        kernels.append({
            "name": name, "route": "cuda", "source": src + "paged_attention.cu",
            "replaces": {"paged_decode": "src/repro/kernels/paged_attention.py:149",
                         "paged_prefill": "src/repro/kernels/paged_attention.py:283"}[name],
            "launches": serving["launches"][name],
            "max_abs_err": row["max_abs_err"], "ms": row["kernel_ms"], "enqueue_ms": row["kernel_enqueue_ms"],
            "plain_ms": row["plain_ms"],
            "bound_ms": row["bound_ms"], "bound_by": row["bound_by"], "library_ms": row["library_ms"],
        })
    gemm_main = gemm_rows["fwd ffn_up/gate"]  # the step's largest forward shape
    stream_lines = {"copy": 60, "mul": 72, "add": 84, "triad": 96, "dot": 108}  # pallas_call sites
    for name, source, replaces, launches, row in (
        ("flash_attention", "flash_attention.cu", "src/repro/kernels/flash_attention.py:124", evaluation["k3_launches"], flash_main),
        ("fp8_gemm", "fp8_gemm.cu", "src/repro/fp8/gemm.py:91", train["k4_launches"], gemm_main),
        ("rwkv6_scan", "rwkv6_scan.cu", "src/repro/kernels/rwkv6_scan.py:85", rwkv["k5_launches"], wkv_main),
        *((f"stream_{k}", "babelstream.cu", f"src/repro/kernels/babelstream.py:{line}", stream_launches[f"stream_{k}"],
           stream_rows[f"stream_{k}"]) for k, line in stream_lines.items()),
    ):
        kernels.append({
            "name": name, "route": "cuda", "source": src + source, "replaces": replaces, "launches": launches,
            "max_abs_err": row["max_abs_err"], "ms": row["kernel_ms"], "enqueue_ms": row["kernel_enqueue_ms"],
            "plain_ms": row["plain_ms"],
            "bound_ms": row["bound_ms"], "bound_by": row["bound_by"], "library_ms": row["library_ms"],
        })
    for k in kernels:  # K4's time covers its layout copies; the parts beside it
        if k["name"] in ("paged_decode", "paged_prefill"):  # the kernel, v1 and the unsplit kernel beside it
            r = main_rows[k["name"]]
            k.update(kernel=r["route"], cuda_cores_ms=r["cuda_cores_ms"], split=r["split"], split1_ms=r["split1_ms"],
                     host_us=r["host_us"], cuda_cores_host_us=r["cuda_cores_host_us"])
        if k["name"] == "paged_prefill":  # the verify passes of each spec run, its own count
            k["spec_launches"] = spec["k2_launches"]
        if k["name"] in ("paged_decode", "paged_prefill"):  # this slice's runs: each KV-tier arm's own count
            which = "k1_launches" if k["name"] == "paged_decode" else "k2_launches"
            k["tier_launches"] = {arm: tiered[arm][which] for arm in ("spill", "drop", "uncached", "spill_budget_32",
                                                                      "spill_fused", "drop_fused")}
            k["fig9_launches"] = fig9["launches"][k["name"]]  # the Fig. 9 harness's closed-loop arms
            # the front-ends' runs: graph replays and the captures' eager warm-ups
            k["frontend_launches"] = {"replays": frontend["replay_launches"][k["name"]],
                                      "eager": frontend["eager_launches"][k["name"]]}
            k["router_launches"] = {run: {how: counts[how].get(k["name"], 0) for how in ("replays", "eager")}
                                    for run, counts in (("arms", router["launches"]),
                                                        ("http", router["http"]["launches"]))}
            k["quantized_launches"] = {  # quantized pools read plain: none
                run: quantized[run]["eager_launches"][k["name"]] + (quantized[run]["replay_launches"] or {}).get(k["name"], 0)
                for run in ("int8_legacy", "int8_fused", "fp8_legacy", "fp8_fused")
            }
        if k["name"] == "rwkv6_scan":  # v1 beside the chunk-parallel kernels
            k.update(cuda_cores_ms=wkv_main["cuda_cores_ms"], mean_rel=wkv_main["readings"]["mean_vs_plain"])
        if k["name"] == "flash_attention":  # the bf16 route's kernel, v1 beside it
            k.update(kernel=flash_main["route"], cuda_cores_ms=flash_main["cuda_cores_ms"])
        if k["name"] == "fp8_gemm":
            k.update(kernel_alone_ms=gemm_main["kernel_alone_ms"], layout_copy_ms=gemm_main["layout_copy_ms"],
                     layout_copies_per_call=gemm_main["layout_copies"],
                     layout_copies=train["k4_layout_copies"])
    print(smi, flush=True)
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
