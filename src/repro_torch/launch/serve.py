"""Serving launcher of the port: the continuous-batching engine over a
synthetic request mix, or the always-on HTTP/SSE service.

    python -m repro_torch.launch.serve --arch olmo-1b --full --fused --prefill-budget 128
    python -m repro_torch.launch.serve --arch olmo-1b --full --fused --replicas 2 --shared-prefix 96
    python -m repro_torch.launch.serve --arch olmo-1b --full --fused --http --port 8731
    python -m repro_torch.launch.serve --arch hymba-1.5b --full --max-batch 4
    python -m repro_torch.launch.serve --arch rwkv6-7b --full --max-batch 4
    python -m repro_torch.launch.serve --arch llama-3.2-vision-90b   # smoke size; --full is 350 GB of fp32
    PYTHONPATH=src python -m repro_torch.launch.serve --device cpu --replicas 2   # smoke size
    PYTHONPATH=src python -m repro_torch.launch.serve --device cpu --tp 2        # two gloo ranks
    PYTHONPATH=src python -m repro_torch.launch.serve --device cpu --replicas 2 --tp 2   # four gloo ranks
    python -m repro_torch.launch.serve --arch olmo-1b --full --tp 2 --backend gloo   # two ranks on one card
    python -m repro_torch.launch.serve --arch olmo-1b --full --replicas 2 --tp 2 --backend gloo   # four

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

``--tp N`` serves one engine over N tensor-parallel ranks
(``launch.mesh.run_ranks``, one process a rank, ``InferenceEngine(mesh=)``):
every rank draws the full weights from ``--seed`` and keeps its slice;
rank 0 runs the prompts, or ``--http``, and prints; the other ranks
``follow()``.  ``--backend`` is the process group's: ``nccl`` (the default
on the card, one card a rank) or ``gloo`` (the CPU's, and on the card the
way to put several ranks on one card, staging every collective through
host memory).  With ``--http`` the launcher forwards SIGTERM and SIGINT to
rank 0, which drains and then releases the others.

``--replicas R --tp T`` with T above 1 serves R tensor-parallel engines
behind one router, as the JAX launcher's fleet: R x T ranks, replica ``i``
on ranks ``[i T, (i + 1) T)`` (``launch.mesh.make_replica_meshes``), the
router on rank 0, which leads replica 0 and drives every other replica's
lead through a ``serving.remote.RemoteEngine`` (the leads run
``serving.remote.serve_remote``, the other ranks ``follow()``); at the
end rank 0 releases every replica's ranks.  On the card it needs R x T
cards unless ``--backend gloo`` is given (the reference's error).
``--replicas N`` alone puts N engines on the one card: they
share one params dict (an engine keeps its params by reference, so the
card holds one copy of the weights), each with its own K/V pools and, with
``--fused``, its own CUDA graphs.  The router steps them in turns.  Every run prints the device it ran on.  The recurrent
families serve with the engine's blocking admission (hymba-1.5b on the
paged cache, K1 for its attention; rwkv6-7b on the dense slot cache,
whose stats print ``cache_kind: dense``), and the chunked options warn
and are ignored for them, as in the JAX launcher.
"""

from __future__ import annotations

import argparse
import random

import torch
import torch.distributed as dist

from repro_torch.config import reduce_for_smoke
from repro_torch.configs import ARCHS, get_config
from repro_torch.device import resolve_device
from repro_torch.launch.mesh import BACKENDS, check_replica_devices, make_replica_meshes, run_ranks
from repro_torch.models import init_params
from repro_torch.models.attention import ATTN_IMPLS
from repro_torch.serving import InferenceEngine, Replica, Router
from repro_torch.serving.remote import RemoteEngine, fleet_group, lead_ranks, serve_remote

DTYPES = {"bf16": torch.bfloat16, "fp32": torch.float32}


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
                    help="independent engine replicas behind the prefix-affinity router (on the one card; "
                         "with --tp, each on --tp ranks of its own)")
    ap.add_argument("--tp", type=int, default=1, help="tensor-parallel degree: ranks of one engine")
    ap.add_argument("--backend", default=None, choices=BACKENDS,
                    help="process-group backend of --tp (default: nccl on the card, gloo on the CPU)")
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
    drain or the service's shutdown (rank 0's with ``--tp``)."""
    args = parse_args(argv)
    if args.replicas < 1:
        raise SystemExit(f"--replicas {args.replicas} (need >= 1)")
    if args.tp < 1:
        raise SystemExit(f"--tp {args.tp} (need >= 1)")
    if args.tp > 1:
        check_replica_devices(args.replicas, args.tp, backend=args.backend, device=args.device)
        return run_ranks(_serve_rank, (args.replicas, args.tp), backend=args.backend, device=args.device,
                         args=(args,), timeout_s=None if args.http else 600.0, forward_signals=args.http)[0]
    return serve(args)


def _serve_rank(rank: int, mesh, args) -> dict:
    """One rank of ``--tp`` (of ``--replicas R --tp T``: of R x T ranks):
    rank 0 serves and prints, each other replica's lead serves rank 0's
    messages, the other ranks follow."""
    meshes, fleet = [mesh], None
    if args.replicas > 1:
        meshes = make_replica_meshes(args.replicas, args.tp, backend=dist.get_backend(), device=args.device)
        fleet = fleet_group(args.replicas, args.tp)
    replica, local = divmod(rank, args.tp)
    if rank == 0:
        return serve(args, meshes[0], fleet)
    cfg = _model_config(args)
    eng = _build_engine(args, cfg, init_params(cfg, args.seed, device=resolve_device(args.device)), meshes[replica])
    if local == 0:
        serve_remote(eng, fleet)
    else:
        eng.follow()
    return eng.stats()


def _model_config(args):
    cfg = get_config(args.arch)
    return reduce_for_smoke(cfg) if args.reduced else cfg


def _build_engine(args, cfg, params, mesh=None):
    return InferenceEngine(
        cfg, params, max_batch=args.max_batch, max_seq=256, seed=args.seed, cache_kind=args.cache,
        block_size=args.block_size, num_blocks=args.num_blocks, cache_dtype=DTYPES[args.cache_dtype],
        quantize_kv=args.quantize_kv, attn_impl=args.attn_impl, fused=args.fused,
        prefix_cache=False if args.no_prefix_cache else None, prefill_budget=args.prefill_budget,
        spill_bytes=args.spill_bytes, spill_dtype=args.spill_dtype, restore_budget=args.restore_budget,
        policy=args.policy, spec_decode=args.spec_decode, spec_k=args.spec_k, profile=args.profile,
        trace_capacity=65536 if args.trace_out else 4096, device=resolve_device(args.device), mesh=mesh,
    )


def serve(args, mesh=None, fleet=None) -> dict:
    """Build the engine (or fleet) and serve ``args``; with a ``mesh``, on
    rank 0, and the followers are released at the end.  ``fleet``: the
    leads' group of ``--replicas`` with ``--tp``, whose replicas past the
    first are driven through ``RemoteEngine``s."""
    cfg = _model_config(args)
    if cfg.is_encoder_only:
        raise SystemExit(f"{args.arch} is encoder-only; no decode serving")
    device = resolve_device(args.device)
    on = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
    ranks = f", tp={args.tp} over {dist.get_backend(mesh.get_group('model'))}" if mesh is not None else ""
    print(f"[serve] {cfg.name} (reduced={args.reduced}) on {on}, {args.replicas} replica(s){ranks}", flush=True)

    params = init_params(cfg, args.seed, device=device)  # one copy, shared by the replicas on this card

    if fleet is not None:
        engines = [_build_engine(args, cfg, params, mesh)]
        engines += [RemoteEngine(lead, fleet) for lead in lead_ranks(args.replicas, args.tp)[1:]]
    else:
        engines = [_build_engine(args, cfg, params, mesh) for _ in range(args.replicas)]
    if args.replicas > 1:
        eng = Router([Replica(i, e) for i, e in enumerate(engines)], trace_capacity=65536 if args.trace_out else 4096)
    else:
        eng = engines[0]
    stats = _drive(args, cfg, eng)
    if mesh is not None:
        for e in engines:  # every replica's ranks, a failed replica's too
            e.stop_followers()
    return stats


def _drive(args, cfg, eng) -> dict:
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
