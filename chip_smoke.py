#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one NVIDIA card and check what comes out.

Run from the repository root with no arguments: ``python3 chip_smoke.py``.
It needs one CUDA card and exits non-zero, printing no result, without one
or when any check fails.  Phases:

1. Card and build: the card's name and power limit, the torch and CUDA
   versions, then ``nvcc`` builds the kernels from
   ``src/repro_torch/kernels/csrc`` for ``sm_90a``.
2. Kernels: K1 (paged decode) and K2 (chunked prefill) against their plain
   PyTorch versions on the card, bf16 pools, fp32 and bf16 queries, at the
   head shapes of olmo-1b, mistral-nemo-12b and gemma-7b, block size 32,
   random block tables with null padding and ragged lengths, plus one
   sliding-window and one softcap case.  One JSON line per case with the
   error, the kernel's, the plain version's and the library's time, and the
   case's bound.
3. Serving: the engine serves 8 greedy requests on the full-width olmo-1b
   (random weights from a seed) with bf16 pools, block size 32, 4 slots,
   a 128-token prefill budget and the prefix cache.  The launch counters
   are set to 0 just before the run and read just after.
4. Kernel path against plain path at full width: two prefill chunks and a
   decode step on olmo-1b with ``attn_impl="kernel"`` and ``"plain"``.
5. Profile: one 4-slot decode step of olmo-1b, its wall time, its device
   time by kernel under ``torch.profiler`` and the device's idle share.

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

import numpy as np
import torch
import torch.nn.functional as F

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

HBM_BYTES_PER_S = 3.35e12  # H100 SXM memory rate
FP32_FLOPS_PER_S = 67e12  # H100 SXM fp32 on the CUDA cores (the kernels' math)
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
    from repro_torch.models.initializers import tree_leaves
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


def profile_phase(cfg, params, device, steps=5) -> dict:
    """The 4-slot decode step at the kernel phase's lengths: host wall time
    per step (no profiler), then device time by kernel under
    ``torch.profiler``.  Idle share = 1 - device busy / wall."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

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
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            step()
        torch.cuda.synchronize()
    by_name: dict[str, float] = {}
    launches = 0
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us() / 1e3 / steps
            launches += 1
    busy = sum(by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    out = {
        "phase": "profile", "model": cfg.name, "what": "decode_step, 4 slots, bf16 pools, fp32 weights",
        "wall_ms": wall_ms, "device_busy_ms": busy if by_name else None,
        "idle_share": 1.0 - busy / wall_ms if by_name else None,
        "device_launches_per_step": launches / steps,
        "paged_decode_ms": sum(v for k, v in by_name.items() if "paged_decode_kernel" in k),
        "top_kernels_ms": [[name[:90], ms] for name, ms in top],
    }
    emit(out)
    return out


# ---------------------------------------------------------------------------


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on an NVIDIA card", file=sys.stderr)
        return 2
    # imported before any output: a copy without the package prints nothing
    from repro_torch.configs import get_config
    from repro_torch.device import resolve_device
    from repro_torch.kernels import paged_attention as K
    from repro_torch.models import init_params

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    emit({"phase": "card", "nvidia_smi": smi, "torch": torch.__version__, "cuda": torch.version.cuda,
          "device": torch.cuda.get_device_name(0)})

    device = resolve_device("cuda")  # also pins fp32 matmuls to full precision
    t0 = time.perf_counter()
    lib, log = K.build(verbose=True)
    emit({"phase": "build", "seconds": time.perf_counter() - t0, "library": os.path.relpath(lib, ROOT),
          "ptxas": [ln.strip() for ln in log.splitlines() if "registers" in ln or "Compiling" in ln]})

    main_rows = kernel_phase(device)

    cfg = get_config("olmo-1b")  # full width and depth
    t0 = time.perf_counter()
    params = init_params(cfg, SEED, device)
    torch.cuda.synchronize()
    emit({"phase": "init", "model": cfg.name, "seconds": time.perf_counter() - t0})
    serving = serving_phase(cfg, params, device)
    path_phase(cfg, params, device)
    profile_phase(cfg, params, device)

    replaces = {"paged_decode": "src/repro/kernels/paged_attention.py:149",
                "paged_prefill": "src/repro/kernels/paged_attention.py:283"}
    kernels = []
    for name, row in main_rows.items():
        kernels.append({
            "name": name, "route": "cuda", "source": "src/repro_torch/kernels/csrc/paged_attention.cu",
            "replaces": replaces[name], "launches": serving["launches"][name],
            "max_abs_err": row["max_abs_err"], "ms": row["kernel_ms"], "plain_ms": row["plain_ms"],
            "bound_ms": row["bound_ms"], "bound_by": row["bound_by"], "library_ms": row["library_ms"],
        })
    print(smi, flush=True)
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
