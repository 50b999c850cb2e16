"""Serving launcher of the port: the continuous-batching engine over a
synthetic request mix, or the always-on HTTP/SSE service.

    python -m repro_torch.launch.serve --arch olmo-1b --full --fused --prefill-budget 128
    python -m repro_torch.launch.serve --arch olmo-1b --full --fused --replicas 2 --shared-prefix 96
    python -m repro_torch.launch.serve --arch olmo-1b --full --fused --http --port 8731
    PYTHONPATH=src python -m repro_torch.launch.serve --device cpu --replicas 2   # smoke size

It takes the JAX launcher's flags and defaults (``src/repro/launch/serve.py``):
the closed-loop drive of ``--requests`` synthetic prompts (``--shared-prefix
N`` prepends a common N-token system prompt, every third request is
offline), the engine's options (``--cache``, ``--block-size``,
``--num-blocks``, ``--cache-dtype``, ``--quantize-kv``, ``--fused``,
``--prefill-budget``, ``--no-prefix-cache``, ``--spill-bytes``,
``--spill-dtype``, ``--restore-budget``, ``--spec-decode``, ``--spec-k``,
``--policy``, ``--profile``), ``--metrics-json`` / ``--trace-out`` after the
drain, ``--http`` (``serving.http.serve_http`` on ``--host``/``--port``:
``POST /v1/generate`` streams Server-Sent Events, ``GET /metrics``,
``/stats``, ``/healthz``; SIGTERM or SIGINT drains gracefully before the
flush) and ``--replicas N`` (N engines behind the prefix-affinity
``serving.router.Router``).  It adds ``--device`` (the card unless ``cpu``
is asked for) and ``--reduced`` (the default, smoke size) / ``--full``
(the published widths), as ``launch/train.py`` has them.  ``--attn-impl``
takes the port's ``kernel`` (the default: the paged-attention kernels on
the card, their plain versions on the CPU) or ``plain``.

Until tensor parallelism is ported (the tensor-parallel item of ROADMAP
Queue 1), ``--tp`` above 1 exits, and ``--replicas N`` puts N engines on
the one card: they share one params dict (an engine keeps its params by
reference, so the card holds one copy of the weights), each with its own
K/V pools and, with ``--fused``, its own CUDA graphs.  The router steps
them in turns.  Every run prints the device it ran on.
"""

from __future__ import annotations

import argparse
import random

import torch

from repro_torch.config import reduce_for_smoke
from repro_torch.configs import ARCHS, get_config
from repro_torch.device import resolve_device
from repro_torch.models import init_params
from repro_torch.models.attention import ATTN_IMPLS
from repro_torch.serving import InferenceEngine, Replica, Router

DTYPES = {"bf16": torch.bfloat16, "fp32": torch.float32}
TP_ITEM = "the tensor-parallel item of ROADMAP Queue 1"


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="mistral-nemo-12b", choices=sorted(ARCHS.names()))
    ap.add_argument("--requests", type=int, default=12)
    ap.add_argument("--max-batch", type=int, default=4)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--cache", default="paged", choices=("paged", "dense"))
    ap.add_argument("--block-size", type=int, default=16)
    ap.add_argument("--num-blocks", type=int, default=None)
    ap.add_argument("--cache-dtype", default="bf16", choices=sorted(DTYPES))
    ap.add_argument("--quantize-kv", nargs="?", const="int8", default=False, choices=("int8", "fp8"),
                    help="quantized paged block pools (bare flag = int8)")
    ap.add_argument("--attn-impl", default="kernel", choices=ATTN_IMPLS)
    ap.add_argument("--fused", action="store_true",
                    help="fused one-dispatch step: one CUDA-graph replay and one host sync per tick on the card")
    ap.add_argument("--top-k", type=int, default=0)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--shared-prefix", type=int, default=0,
                    help="prepend a common N-token system prompt to every request")
    ap.add_argument("--no-prefix-cache", action="store_true",
                    help="disable prefix caching (measure the re-prefill baseline)")
    ap.add_argument("--prefill-budget", type=int, default=0,
                    help="max prompt tokens prefilled per step (0 = unbounded)")
    ap.add_argument("--spill-bytes", type=int, default=0,
                    help="host-RAM budget of the spill tier for evicted prefix blocks (0 = drop on evict)")
    ap.add_argument("--spill-dtype", default="cache", choices=("cache", "int8", "fp8"),
                    help="at-rest encoding of spilled blocks")
    ap.add_argument("--restore-budget", type=int, default=4,
                    help="max spilled blocks swapped back per scheduler step")
    ap.add_argument("--spec-decode", default="off", choices=("off", "ngram", "draft"),
                    help="speculative decoding: n-gram prompt lookup or a reduced-depth draft model")
    ap.add_argument("--spec-k", type=int, default=4, help="drafted tokens scored per verify pass")
    ap.add_argument("--replicas", type=int, default=1,
                    help="independent engine replicas behind the prefix-affinity router (all on the one card)")
    ap.add_argument("--tp", type=int, default=1, help=f"tensor-parallel degree (only 1 until {TP_ITEM})")
    ap.add_argument("--metrics-json", default=None, metavar="PATH",
                    help="write the metrics registry snapshot as JSON after the drain")
    ap.add_argument("--trace-out", default=None, metavar="PATH",
                    help="write the request-lifecycle trace as Chrome-trace JSON")
    ap.add_argument("--profile", action="store_true",
                    help="sync after each dispatch so step latency decomposes by phase (adds host syncs)")
    ap.add_argument("--policy", default="slo", choices=("slo", "fcfs"),
                    help="scheduler policy: 'slo' honors priority/deadline_s and preempts; 'fcfs' arrival order")
    ap.add_argument("--http", action="store_true",
                    help="serve the always-on HTTP/SSE front-end instead of draining a synthetic batch")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=8080)
    ap.add_argument("--reduced", dest="reduced", action="store_true", default=True)
    ap.add_argument("--full", dest="reduced", action="store_false")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    return ap.parse_args(argv)


def main(argv=None) -> dict:
    """Serve; returns the engine's (or the fleet's) ``stats()`` after the
    drain or the service's shutdown."""
    args = parse_args(argv)
    if args.tp > 1:
        raise SystemExit(f"--tp {args.tp}: tensor parallelism is not ported yet ({TP_ITEM})")
    if args.replicas < 1:
        raise SystemExit(f"--replicas {args.replicas} (need >= 1)")
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = reduce_for_smoke(cfg)
    if cfg.is_encoder_only:
        raise SystemExit(f"{args.arch} is encoder-only; no decode serving")
    device = resolve_device(args.device)
    on = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
    print(f"[serve] {cfg.name} (reduced={args.reduced}) on {on}, {args.replicas} replica(s)", flush=True)

    params = init_params(cfg, args.seed, device=device)  # one copy, shared by every replica

    def build_engine():
        return InferenceEngine(
            cfg, params, max_batch=args.max_batch, max_seq=256, seed=args.seed, cache_kind=args.cache,
            block_size=args.block_size, num_blocks=args.num_blocks, cache_dtype=DTYPES[args.cache_dtype],
            quantize_kv=args.quantize_kv, attn_impl=args.attn_impl, fused=args.fused,
            prefix_cache=False if args.no_prefix_cache else None, prefill_budget=args.prefill_budget,
            spill_bytes=args.spill_bytes, spill_dtype=args.spill_dtype, restore_budget=args.restore_budget,
            policy=args.policy, spec_decode=args.spec_decode, spec_k=args.spec_k, profile=args.profile,
            trace_capacity=65536 if args.trace_out else 4096, device=device,
        )

    if args.replicas > 1:
        eng = Router([Replica(i, build_engine()) for i in range(args.replicas)],
                     trace_capacity=65536 if args.trace_out else 4096)
    else:
        eng = build_engine()

    if args.http:
        import asyncio

        from repro_torch.serving.http import serve_http

        try:
            asyncio.run(serve_http(eng, host=args.host, port=args.port, metrics_json=args.metrics_json,
                                   trace_out=args.trace_out))
        except KeyboardInterrupt:
            print("[serve] shutting down")
        return eng.stats()

    rng = random.Random(args.seed)
    system = [rng.randrange(2, cfg.vocab_size) for _ in range(args.shared_prefix)]
    reqs = []
    for i in range(args.requests):
        prompt = system + [rng.randrange(2, cfg.vocab_size) for _ in range(rng.randint(2, 8))]
        reqs.append(eng.submit(prompt, max_new_tokens=args.max_new, online=(i % 3 != 0),
                               temperature=args.temperature, top_k=args.top_k))
    eng.run_until_drained()
    for r in reqs:
        online = r.online if hasattr(r, "online") else r.kwargs.get("online", True)
        kind = "online " if online else "offline"
        ttft = f"{r.ttft * 1e3:8.1f}ms" if r.ttft is not None else "   never admitted"
        hit_toks = getattr(r, "prefix_hit_tokens", 0)
        hit = f" prefix_hit={hit_toks:3d}" if hit_toks else ""
        rep = f" replica={r.replica_id}" if hasattr(r, "replica_id") else ""
        print(f"req {r.req_id:3d} [{kind}] ttft={ttft} len={len(r.generated)}{hit}{rep} head={r.generated[:6]}")
    stats = eng.stats()
    print("[serve] stats:", stats)
    for name in ("engine_ttft_seconds", "engine_tpot_seconds", "engine_step_seconds"):
        p = eng.metrics.percentiles(name)
        if p[50] is not None:
            pretty = "  ".join(f"p{int(k)}={v * 1e3:.2f}ms" for k, v in p.items())
            print(f"[serve] {name}: {pretty}")
    if args.metrics_json:
        eng.metrics.write_json(args.metrics_json)
        print(f"[serve] metrics snapshot -> {args.metrics_json}")
    if args.trace_out:
        eng.tracer.write(args.trace_out)
        print(f"[serve] chrome trace -> {args.trace_out} "
              f"({len(eng.tracer.events)} events, {eng.tracer.dropped} dropped)")
    return stats


if __name__ == "__main__":
    main()
