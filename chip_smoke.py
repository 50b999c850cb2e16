#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one NVIDIA card and check what comes out.

Run from the repository root with no arguments: ``python3 chip_smoke.py``.
It needs one CUDA card and exits non-zero, printing no result, without one
or when any check fails.  Phases:

1. Card and build: the card's name and power limit, the torch and CUDA
   versions, then ``nvcc`` builds the five sources of
   ``src/repro_torch/kernels/csrc`` for ``sm_90a``, all started together,
   with the seconds each took; then the count of HGMMA (``wgmma``)
   instructions in each kernel of K4 and K3 (``cuobjdump -sass``): each of
   K4's four kernels and of K3's four bf16 kernels must hold some.
2. Kernels: K1 (paged decode) and K2 (chunked prefill) against their plain
   PyTorch versions on the card, bf16 pools, fp32 and bf16 queries, at the
   head shapes of olmo-1b, mistral-nemo-12b and gemma-7b, block size 32,
   random block tables with null padding and ragged lengths, plus one
   sliding-window and one softcap case.  Then K3 (flash attention forward)
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
3. Serving: the engine serves 8 greedy requests on the full-width olmo-1b
   (random weights from a seed) with bf16 pools, block size 32, 4 slots,
   a 128-token prefill budget and the prefix cache.  The launch counters
   are set to 0 just before the run and read just after.
4. Kernel path against plain path at full width: two prefill chunks and a
   decode step on olmo-1b with ``attn_impl="kernel"`` and ``"plain"``.
5. Profile: one 4-slot decode step of olmo-1b, its wall time, its device
   time by kernel under ``torch.profiler`` and the device's idle share.
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
   fast decay, against its plain version and the sequential oracle.  Each
   check computes a control (triad with the scalar left unrounded, dot
   without its last tile, the scan with the decay one step late) that it
   must reject.
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


def timed_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean time of ``fn(i)`` over ``iters`` calls, by CUDA events."""
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


# ---------------------------------------------------------------------------
# phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------


def kernel_case(kind, H, KV, hd, q_dtype, window, softcap, device, layers=16, seed=0):
    """Inputs of one case.  ``layers`` pools are made so that timing loops
    can read a different layer's pool each call, as the model does; their
    total exceeds the 50 MB L2 cache."""
    g = torch.Generator().manual_seed(seed)
    B = len(DECODE_LENS) if kind == "decode" else 1
    N = 1 + B * NB + 2
    last = [n - 1 for n in DECODE_LENS] if kind == "decode" else [PREFILL_START + PREFILL_C - 1]
    tbl = (torch.randperm(N - 1, generator=g)[: B * NB] + 1).reshape(B, NB).to(torch.int32)
    for b in range(B):
        tbl[b, last[b] // BLOCK_SIZE + 1 :] = 0  # null padding past the live blocks
    pools = [torch.randn((layers, N, BLOCK_SIZE, KV, hd), generator=g).to(torch.bfloat16) for _ in range(2)]
    if kind == "decode":
        q = torch.randn((B, H, hd), generator=g)
        lens = torch.tensor(DECODE_LENS, dtype=torch.int32)
    else:
        q = torch.randn((B, PREFILL_C, H, hd), generator=g)
        lens = torch.tensor([PREFILL_START], dtype=torch.int32)
    to = lambda t: t.to(device)  # noqa: E731
    return dict(
        kind=kind, H=H, KV=KV, hd=hd, window=window, softcap=softcap, q=to(q.to(q_dtype)),
        k=to(pools[0]), v=to(pools[1]), tbl=to(tbl), lens=to(lens), layers=layers,
    )


def case_work(c) -> tuple[int, int]:
    """(bytes, fp32 operations) the case needs: each input read once, each
    output written once, K/V only at the positions some query can see."""
    H, KV, hd, w = c["H"], c["KV"], c["hd"], c["window"]
    q_bytes = c["q"].numel() * c["q"].element_size()
    kv_row = KV * hd * c["k"].element_size() * 2  # K and V of one position
    meta = c["tbl"].numel() * 4 + c["lens"].numel() * 4
    if c["kind"] == "decode":
        vis = [min(n, w) if w else n for n in DECODE_LENS]
        kv_rows, pairs = sum(vis), sum(vis)
    else:
        lo = max(0, PREFILL_START - w + 1) if w else 0
        kv_rows = PREFILL_START + PREFILL_C - lo
        pairs = sum(min(PREFILL_START + i + 1, w) if w else PREFILL_START + i + 1 for i in range(PREFILL_C))
    return 2 * q_bytes + kv_rows * kv_row + meta, pairs * H * hd * 4  # QK^T and PV: 2 multiply-adds


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
        q_pos = c["lens"].long()[:, None] + torch.arange(PREFILL_C, device=q.device)[None]  # (B, C)
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


def kernel_phase(device) -> dict:
    from repro_torch.kernels import paged_attention as K
    from repro_torch.kernels.paged_attention_ref import paged_attention_plain, paged_prefill_attention_plain

    fns = {"decode": (K.paged_attention, paged_attention_plain), "prefill": (K.paged_prefill_attention, paged_prefill_attention_plain)}
    cases = [(m, H, KV, hd, dt, 0, 0.0) for (m, H, KV, hd) in HEAD_SHAPES for dt in (torch.float32, torch.bfloat16)]
    cases += [("mistral-nemo-12b", 32, 8, 128, torch.float32, 32, 0.0), ("gemma-7b", 16, 16, 256, torch.float32, 0, 30.0)]
    main = {}  # per kernel: the serving path's case (olmo-1b, fp32 queries)
    for kind in ("decode", "prefill"):
        kernel, plain = fns[kind]
        for seed, (model, H, KV, hd, dt, window, cap) in enumerate(cases):
            c = kernel_case(kind, H, KV, hd, dt, window, cap, device, seed=seed)
            kw = dict(softcap=cap, window=window)

            def run(fn, i, c=c, kw=kw):
                layer = i % c["layers"]
                return fn(c["q"], c["k"][layer], c["v"][layer], c["tbl"], c["lens"], **kw)

            err = float((run(kernel, 0).float() - run(plain, 0).float()).abs().max())
            torch.cuda.synchronize()
            tol = TOL[dt]
            lib = library_call(c, lambda i: run(plain, i))
            nbytes, flops = case_work(c)
            row = {
                "phase": "kernel", "kernel": f"paged_{kind}", "model": model, "q_dtype": str(dt).replace("torch.", ""),
                "window": window, "softcap": cap, "max_abs_err": err, "tol": tol,
                "kernel_ms": timed_ms(lambda i: run(kernel, i)),
                "plain_ms": timed_ms(lambda i: run(plain, i)),
                "library_ms": timed_ms(lib[0]) if lib else None,
                "library_max_abs_err": lib[1] if lib else None,
                "bound_ms": 1e3 * max(nbytes / HBM_BYTES_PER_S, flops / FP32_FLOPS_PER_S),
                "bound_by": "bytes" if nbytes / HBM_BYTES_PER_S >= flops / FP32_FLOPS_PER_S else "operations",
            }
            emit(row)
            if not err < tol:
                fail(f"{row['kernel']} {model} {row['q_dtype']} window={window} softcap={cap}: err {err} >= {tol}")
            if model == "olmo-1b" and dt == torch.float32:
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
        "output_tok_s": s["tokens_out"] / wall,
        "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
    }
    emit(out)
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


def profile_phase(cfg, params, device, steps=5) -> dict:
    """The 4-slot decode step at the kernel phase's lengths: host wall time
    per step (no profiler), then device time by kernel under
    ``torch.profiler``.  Idle share = 1 - device busy / wall."""
    from repro_torch.models import decode_step, init_paged_cache

    B = len(DECODE_LENS)
    cache = init_paged_cache(cfg, 1 + B * NB, BLOCK_SIZE, B, NB, torch.bfloat16, device=device)
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
    out = {
        "phase": "profile", "model": cfg.name, "what": "decode_step, 4 slots, bf16 pools, fp32 weights",
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
            "kernel_ms": timed_ms(lambda i: K3.flash_attention_bhsd(q, k, v, **kw), iters=10, warmup=2),
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
            "kernel_ms": timed_ms(lambda i: K4.fp8_gemm(a, b, sa, sb), iters=20, warmup=3),
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
    """A readable name for a kernel of K4's or K3's library: its template
    arguments."""
    import re

    if m := re.search(r"fp8_gemm_kernelILb(\d)ELb(\d)E", mangled):
        return f"a_e5m2={m[1]},b_e5m2={m[2]}"
    if m := re.search(r"flash_tc_kernelILi(\d+)E", mangled):
        return f"tensor_cores_bf16,hd_pad={m[1]}"
    if m := re.search(r"flash_fwd_kernelI(f|13__nv_bfloat16)Li(\d)E", mangled):
        return f"cuda_cores_{'fp32' if m[1] == 'f' else 'bf16'},hd<={64 * int(m[2])}"
    return mangled


def hgmma_counts(lib) -> dict:
    """HGMMA (warpgroup MMA on fp16/bf16 operands) instructions in the SASS of
    each kernel of a library, by ``kernel_label``."""
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
            counts[fn] += bool(re.search(r"\bHGMMA\b", line))
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
            kernel_ms = timed_ms(lambda i: kernel())
            row = {
                "phase": "kernel", "kernel": f"stream_{name}", "n": n, "dtype": str(dt).replace("torch.", ""),
                "bit_equal": None if name == "dot" else ok, "max_abs_err": err, "tol": tol, "control": control,
                "kernel_ms": kernel_ms, "plain_ms": timed_ms(lambda i: plain(), iters=5, warmup=1),
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
        scale = float(plain.abs().max())
        rel = lambda x, y: float((x - y).abs().max()) / scale  # noqa: E731
        readings = {"vs_plain": rel(out_bh, plain), "vs_oracle": rel(out_bh, oracle),
                    "control_vs_plain": rel(control, plain), "control_vs_oracle": rel(control, oracle)}
        finite = bool(torch.isfinite(out).all())
        del out, out_bh, plain, oracle, control
        bound_ms, bound_by = wkv_bound(B * H, S, n)
        row = {
            "phase": "kernel", "kernel": "rwkv6_scan", "case": name, "shape_bshn": [B, S, H, n], "chunk": chunk,
            "max_abs_err": readings["vs_plain"] * scale, "max_abs_out": scale, "readings": readings, "tol": WKV_RTOL,
            "finite": finite, "model_layout_equal": layout_equal,
            "kernel_ms": timed_ms(lambda i: K5.wkv6(r, k, v, lw, u, chunk=chunk), iters=10, warmup=2),
            "plain_ms": timed_ms(lambda i: wkv6_chunked_plain(*bh, ub, chunk=chunk), iters=3, warmup=1),
            "library_ms": None,  # no single PyTorch call computes the scan
            "bound_ms": bound_ms, "bound_by": bound_by, "work": dict(zip(("bytes", "flops", "exps"), wkv_work(B * H, S, n))),
        }
        emit(row)
        if not finite or readings["vs_plain"] > WKV_RTOL or readings["vs_oracle"] > WKV_RTOL or not layout_equal:
            fail(f"rwkv6_scan {name}: {readings} beyond {WKV_RTOL}, finite {finite}, layouts equal {layout_equal}")
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
    emit({"phase": "card", "nvidia_smi": smi, "torch": torch.__version__, "cuda": torch.version.cuda,
          "device": torch.cuda.get_device_name(0)})

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
    # K4 and K3's bf16 route run on the tensor cores: each of K4's four
    # kernels (one per type pair) and each of K3's four bf16 kernels (one per
    # padded head dim) holds HGMMA
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
    serving = phase("serving", serving_phase, cfg, params, device)
    phase("path", path_phase, cfg, params, device)
    phase("profile", profile_phase, cfg, params, device)
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
            "max_abs_err": row["max_abs_err"], "ms": row["kernel_ms"], "plain_ms": row["plain_ms"],
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
            "max_abs_err": row["max_abs_err"], "ms": row["kernel_ms"], "plain_ms": row["plain_ms"],
            "bound_ms": row["bound_ms"], "bound_by": row["bound_by"], "library_ms": row["library_ms"],
        })
    for k in kernels:  # K4's time covers its layout copies; the parts beside it
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
