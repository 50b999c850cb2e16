"""Rank functions of the port's tensor-parallel CPU tests.

``launch.mesh.run_ranks`` runs them in spawned processes, one a rank of a
``(1, 2)`` gloo mesh.  This module imports ``torch`` and ``repro_torch``
only, so the ranks never load JAX (each rank reports whether it did).
Each function runs every case of its test file in one spawn.
"""

from __future__ import annotations

import sys
import time
import warnings

import numpy as np
import torch

from repro_torch.models import init_paged_cache, prefill, prefill_step, supports_chunked_prefill
from repro_torch.parallel import collectives
from repro_torch.parallel.sharding import executed_specs, local_kv_heads, shard_params
from repro_torch.serving import InferenceEngine
from repro_torch.serving.metrics import ManualClock
from repro_torch.serving.remote import RemoteEngine

STEP_S = 0.01  # rank 0's manual clock advances this much before each step


class RecordingEngine(InferenceEngine):
    """An engine that keeps its host block table after every step (none
    where its cache is not paged)."""

    def _step(self, now):
        out = super()._step(now)
        if hasattr(self, "tbl"):
            self.tables.append(self.tbl.copy())
        return out


def prefill_logits(cfg, params, prompt, mesh=None) -> np.ndarray:
    """The logits of one whole-prompt ``prefill_step`` on a fresh fp32 cache
    (this rank's kv heads); a family without chunked prefill takes the
    blocking ``prefill``."""
    if not supports_chunked_prefill(cfg):
        return prefill(cfg, params, {"tokens": torch.tensor([prompt], dtype=torch.int32)}, mesh=mesh)[0].numpy()
    bs, nb = 8, 8
    cache = init_paged_cache(cfg, nb + 1, bs, 1, nb, torch.float32, device="cpu", kv_heads=local_kv_heads(cfg, mesh))
    row = torch.arange(1, nb + 1, dtype=torch.int32)[None]
    logits, _ = prefill_step(cfg, params, cache, torch.tensor([prompt], dtype=torch.int32),
                             torch.zeros(1, dtype=torch.int32), row, mesh=mesh)
    return logits.numpy()


def serve(cfg, params, case: dict, mesh=None) -> dict:
    """Serve ``case["prompts"]`` on one engine (a rank's under ``mesh``) and
    report what the tests compare.  Rank 0 drives; the others follow.
    ``case["clock"] == "slo"``: rank 0 steps on a manual clock, a follower
    reads the wall clock an hour ahead."""
    rank = 0 if mesh is None else mesh.get_local_rank("model")
    clock = None
    if case.get("clock") == "slo":
        clock = ManualClock() if rank == 0 else (lambda: time.monotonic() + 3600.0)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        eng = RecordingEngine(cfg, params, mesh=mesh, clock=clock, device="cpu", **case["engine"])
    eng.tables = []
    if rank == 0:
        reqs = [eng.submit(p, **kw) for p, kw in zip(case["prompts"], case["submit"])]
        while eng.has_work:
            if isinstance(clock, ManualClock):
                clock.advance(STEP_S)
            eng.step()
        eng.stop_followers()
        ids = [r.req_id for r in reqs]
    else:
        eng.follow()
        ids = sorted(r.req_id for r in eng.done)
    done = {r.req_id: r for r in eng.done}
    return {
        "tokens": [list(done[i].generated) for i in ids],
        "reasons": [done[i].finish_reason for i in ids],
        "stats": eng.stats(),
        "pool_shapes": {k: tuple(eng.cache[k].shape) for k in ("k", "v") if k in eng.cache},
        "tables": np.stack(eng.tables) if eng.tables else np.zeros((0,)),
        "warnings": [str(w.message) for w in caught],
    }


def run_serving_cases(rank, mesh, cases) -> list[dict]:
    """Every case of ``test_torch_tp_serving.py`` on this rank: the rank's
    slice of the case's full params (``shard_params``), the engine run and
    one prefill's logits."""
    torch.set_num_threads(1)
    out = []
    for case in cases:
        cfg = case["cfg"]
        local = shard_params(cfg, case["params"], executed_specs(cfg, mesh)["executed"], mesh)
        r = serve(cfg, local, case, mesh)
        r["logits"] = prefill_logits(cfg, local, case["prompts"][0], mesh)
        attn = local["blocks"][0].get("attn")  # none in the ssm family
        r["local_shapes"] = {"wq": attn and tuple(attn["wq"].shape), "tok": tuple(local["embed"]["tok"].shape)}
        out.append(r)
    return out + [{"jax_loaded": any(m.split(".")[0] in ("jax", "repro") for m in sys.modules)}]


def primitives(rank, mesh):
    """``all_reduce`` in place and ``all_gather`` along the last dim, with
    the counters they leave, and the other meshes of ``launch.mesh`` over
    the same two ranks: their shapes and this rank's coordinates
    (``test_torch_collectives.py``)."""
    from repro_torch.launch.mesh import make_local_mesh, make_replica_meshes

    collectives.reset_collectives()
    x = torch.arange(6, dtype=torch.float32).reshape(2, 3) * (rank + 1)
    out = collectives.all_reduce(x, mesh)
    g = collectives.all_gather(torch.full((2, 1), float(rank)), mesh, dim=-1)
    meshes = {"local_2x1": make_local_mesh(2, 1), "replicas": make_replica_meshes(2, 1, device="cpu")}
    shapes = {"serving": (tuple(mesh.mesh_dim_names), tuple(mesh.shape)),
              "local_2x1": tuple(meshes["local_2x1"].shape),
              "replicas": [(m.mesh.flatten().tolist(), m.get_coordinate()) for m in meshes["replicas"]]}
    return out is x, x.tolist(), g.tolist(), dict(collectives.COLLECTIVES), shapes


def cuda_checks(rank, mesh) -> dict:
    """``test_torch_cuda_tp.py`` on one rank of a gloo mesh on the card:
    K1/K2 on this rank's local head slice against their plain versions,
    the smoke olmo-1b served at TP=2 (and at TP=1 on rank 0 first, from
    the same weights), and ``fused=True`` refused on the gloo group."""
    from repro_torch.config import reduce_for_smoke
    from repro_torch.configs import get_config
    from repro_torch.kernels import paged_attention as K
    from repro_torch.kernels.paged_attention_ref import paged_attention_plain, paged_prefill_attention_plain
    from repro_torch.models import init_params

    torch.set_num_threads(1)
    cfg = reduce_for_smoke(get_config("olmo-1b"))
    params = init_params(cfg, 0, device="cuda")
    local = shard_params(cfg, params, executed_specs(cfg, mesh)["executed"], mesh)
    H, KV, hd = local["blocks"][0]["attn"]["wq"].shape[1], local_kv_heads(cfg, mesh), cfg.head_dim
    g = torch.Generator(device="cuda").manual_seed(rank)
    N, bs = 9, 16  # the kernels take blocks of 16 or 32 positions
    pools = [torch.randn((N, bs, KV, hd), generator=g, device="cuda").bfloat16() for _ in range(2)]
    tbl = torch.tensor([[1, 2, 3, 0], [4, 5, 6, 7]], dtype=torch.int32, device="cuda")
    q1 = torch.randn((2, H, hd), generator=g, device="cuda")
    lens = torch.tensor([19, 30], dtype=torch.int32, device="cuda")
    q2 = torch.randn((2, 5, H, hd), generator=g, device="cuda")
    start = torch.tensor([11, 20], dtype=torch.int32, device="cuda")
    K.reset_launches()
    errs = {
        "paged_decode": float((K.paged_attention(q1, *pools, tbl, lens) - paged_attention_plain(q1, *pools, tbl, lens))
                              .abs().max()),
        "paged_prefill": float((K.paged_prefill_attention(q2, *pools, tbl, start)
                                - paged_prefill_attention_plain(q2, *pools, tbl, start)).abs().max()),
    }
    kernel_launches = dict(K.LAUNCHES)
    case = {"prompts": [p * 2 for p in ([11, 12, 13, 14], [5, 9, 12], [21, 22, 23, 24, 25])],
            "submit": [dict(max_new_tokens=6)] * 3,
            "engine": dict(max_batch=2, max_seq=64, block_size=16, cache_dtype=torch.float32, eos_token=1 << 30,
                           prefill_budget=8)}
    cuda = dict(case, engine=dict(case["engine"], device="cuda"))
    tp1 = serve_cuda(cfg, params, cuda) if rank == 0 else None
    K.reset_launches()
    tp2 = serve_cuda(cfg, local, cuda, mesh)
    launches = dict(K.LAUNCHES)
    try:
        InferenceEngine(cfg, local, mesh=mesh, fused=True, **cuda["engine"])
        refusal = None
    except ValueError as e:
        refusal = str(e)
    return {"kernel_errs": errs, "kernel_launches": kernel_launches, "local_heads": (H, KV), "tp1": tp1,
            "tp2": tp2, "launches": launches, "fused_refusal": refusal}


def serve_cuda(cfg, params, case, mesh=None) -> list:
    """The tokens of ``case``'s prompts on the card (rank 0 drives)."""
    eng = InferenceEngine(cfg, params, mesh=mesh, **case["engine"])
    if eng.rank != 0:
        eng.follow()
        return [list(r.generated) for r in sorted(eng.done, key=lambda r: r.req_id)]
    reqs = [eng.submit(p, **kw) for p, kw in zip(case["prompts"], case["submit"])]
    eng.run_until_drained()
    eng.stop_followers()
    return [list(r.generated) for r in reqs]




def fleet_router(cfg, params, engine_kw, meshes, fleet, plans, remote_cls):
    """Rank 0's router over replica 0 (its own engine, the lead of
    ``meshes[0]``) and replica 1 (a ``remote_cls`` of the lead at rank 2),
    all reading one ``ManualClock`` ticking 1e-4 s a read; ``plans`` the
    replicas' fault plans by id.  Returns (router, engines)."""
    from repro_torch.serving import FaultPlan, ManualClock, Replica, Router

    clock = ManualClock(tick=1e-4)
    engines = [InferenceEngine(cfg, params, mesh=meshes[0], clock=clock, **engine_kw), remote_cls(2, fleet)]
    replicas = [Replica(i, e, clock=clock, fault_plan=FaultPlan(**plans[i]) if i in plans else None)
                for i, e in enumerate(engines)]
    return Router(replicas, clock=clock, backoff_base_s=1e-4), engines


def run_fleet_cases(rank, mesh, cfg, params, spec, device="cpu") -> list[dict]:
    """Every scenario of ``test_torch_replicas_tp.py`` on one rank of a
    world of four: two replicas of TP=2 engines (``make_replica_meshes(2,
    2)``), the router on rank 0 driving replica 1's lead (rank 2) through a
    ``RemoteEngine`` (or the scenario's ``remote`` class, a control), rank
    2 serving it, ranks 1 and 3 following.  Rank 0 reports each request's
    placement, final replica and tokens, the router's counts and each
    replica's stats; every rank its kernel launches and whether it loaded
    JAX."""
    from repro_torch.kernels import paged_attention as K
    from repro_torch.launch.mesh import make_replica_meshes
    from chip_smoke import seed_dropping
    from repro_torch.serving.remote import fleet_group, serve_remote

    torch.set_num_threads(1)
    meshes = make_replica_meshes(2, 2, backend="gloo", device=device)
    fleet = fleet_group(2, 2)
    replica, local = divmod(rank, 2)
    out = []
    for scenario in spec["scenarios"]:
        K.reset_launches()
        if rank == 0:
            # the control (``chip_smoke.seed_dropping``): the resume's seed never reaches the lead
            remote_cls = seed_dropping(RemoteEngine) if scenario.get("remote") == "drop_seeds" else RemoteEngine
            router, engines = fleet_router(cfg, params, spec["engine"], meshes, fleet, scenario["plans"], remote_cls)
            reqs = [router.submit(p, max_new_tokens=spec["max_new"]) for p in spec["prompts"]]
            placed = [r.replica_id for r in reqs]
            router.run_until_drained()
            s = router.stats()
            for e in engines:  # the crashed replica's ranks too
                e.stop_followers()
            res = {"tokens": [list(r.generated) for r in reqs], "placed": placed,
                   "finished_on": [r.replica_id for r in reqs], "requests_done": s["requests_done"],
                   "requests_failed": s["requests_failed"], "failovers": int(s["failovers"]),
                   "states": s["replica_states"], "per_replica": s["per_replica"],
                   "replica_launches": {r.id: dict(r.launches) for r in router.replicas}}
        else:
            eng = InferenceEngine(cfg, params, mesh=meshes[replica], **spec["engine"])
            if local == 0:
                serve_remote(eng, fleet)
            else:
                eng.follow()
            res = {"stats": eng.stats()}
        res["launches"] = dict(K.LAUNCHES)
        out.append(res)
    return out + [{"jax_loaded": any(m.split(".")[0] in ("jax", "repro") for m in sys.modules)}]


def cloverleaf_blocks(rank, mesh, grid: np.ndarray, steps: int, sizes: tuple) -> dict:
    """``test_torch_cloverleaf_ranks.py`` on one rank of a world of four: for
    each row mesh of ``sizes`` ranks (``cloverleaf.row_mesh``; the ranks
    past it idle), this rank's block after each of ``steps`` chained steps
    of ``cloverleaf.make_step`` and of the control (each rank wraps its own
    rows: ``cloverleaf.step`` on the block)."""
    from repro_torch.benchmarks import cloverleaf

    out = {}
    u = torch.from_numpy(grid)
    for n in sizes:
        rows = cloverleaf.row_mesh(n)
        if rows is None:
            continue
        step_block = cloverleaf.make_step(rows)
        mine = control = cloverleaf.block_of(u, rows)
        out[n] = {"steps": [], "control": []}
        for _ in range(steps):
            mine, control = step_block(mine), cloverleaf.step(control)
            out[n]["steps"].append(mine.numpy().copy())
            out[n]["control"].append(control.numpy().copy())
    return out


def tp1_fleet(cfg, params, spec, plans) -> dict:
    """``spec``'s prompts through a router over two TP=1 engines in this
    process (fault ``plans`` by replica id), every clock a ``ManualClock``
    ticking 1e-4 s a read: each request's placement, final replica and
    tokens, and the router's counts and replica states."""
    from repro_torch.serving import FaultPlan, Replica, Router

    clock = ManualClock(tick=1e-4)
    replicas = [Replica(i, InferenceEngine(cfg, params, clock=clock, **spec["engine"]), clock=clock,
                        fault_plan=FaultPlan(**plans[i]) if i in plans else None) for i in range(2)]
    router = Router(replicas, clock=clock, backoff_base_s=1e-4)
    reqs = [router.submit(p, max_new_tokens=spec["max_new"]) for p in spec["prompts"]]
    placed = [r.replica_id for r in reqs]
    router.run_until_drained()
    s = router.stats()
    return {"tokens": [list(r.generated) for r in reqs], "placed": placed, "finished_on": [r.replica_id for r in reqs],
            "requests_done": s["requests_done"], "requests_failed": s["requests_failed"],
            "failovers": int(s["failovers"]), "states": s["replica_states"]}


def cuda_fleet_checks(rank, mesh) -> dict:
    """``test_torch_cuda_tp.py``'s fleet on one rank of four gloo ranks on
    the card: the smoke olmo-1b (fp32 pools, block 16, K1/K2 on each rank's
    kv-head slice), two replicas of TP=2 engines with replica 0 crashed at
    its 4th step, against the same fleet of TP=1 engines on rank 0."""
    from repro_torch.config import reduce_for_smoke
    from repro_torch.configs import get_config
    from repro_torch.models import init_params

    torch.set_num_threads(1)
    cfg = reduce_for_smoke(get_config("olmo-1b"))
    params = init_params(cfg, 0, device="cuda")
    plans = {0: {"crash_at_step": 4}}
    spec = {"prompts": [[(13 * t + 5 * j + 7) % 197 + 2 for j in range(16)] + [200 + 4 * t + i, 210 + t]
                        for i in range(2) for t in range(4)],
            "max_new": 6, "scenarios": [{"name": "crash_0", "plans": plans}],
            "engine": dict(max_batch=4, max_seq=64, block_size=16, prefill_budget=16, cache_dtype=torch.float32,
                           cache_kind="paged", prefix_cache=True, eos_token=1 << 30, device="cuda")}
    tp1 = tp1_fleet(cfg, params, spec, plans) if rank == 0 else None
    got = run_fleet_cases(rank, mesh, cfg, params, spec, device="cuda")
    return {"tp1": tp1, "tp2": got[0], "jax_loaded": got[-1]["jax_loaded"]}
