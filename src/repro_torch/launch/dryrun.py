"""Dry run: cost every (architecture x shape) cell on the meta device, on
one card or as one rank of a production mesh.

The counterpart of the JAX package's ``launch/dryrun.py``, for the H100.
For each runnable cell it builds the port's real ``train_step`` (the train
step of ``repro_torch.train``, with the cell's microbatches, remat, fp8 and
parameter and optimizer dtypes from ``launch.specs.run_config_for``),
``prefill`` (``forward`` for encoder-only configs) or ``decode_step`` (over
a dense slot cache of the cell's batch and length), at the cell's full
config and shape, with parameters, optimizer state, cache and inputs as
meta tensors (shapes and dtypes from ``models.param_specs`` and
``models.cache``'s layout; nothing is drawn from a generator, nothing is
allocated), and runs it once under ``launch.cost``.  It records, under the
JAX record's names:

* ``per_device_flops`` and ``per_device_hbm_bytes`` (``launch.cost``):
  the global step's over ``n_devices``,
* ``params``, ``active_params``, ``model_flops`` (6ND for train, 2ND for
  inference, D the tokens of the step) and ``useful_ratio``,
* ``roofline``, ``dominant`` and ``fp8`` (``launch.roofline``: fp8 train
  cells of the families whose quantized sites carry the dominant GEMMs
  are costed at the fp8 peak),
* ``memory.peak_estimate_bytes``: the most bytes of meta storage live at
  once during the step (one rank's, on a mesh), its arguments included;
* ``collectives`` (on a mesh): each collective's calls and operand bytes
  over one step of one rank, whose total gives the roofline's
  ``collective_s``.

On meta the cell selects the plain implementations by name, as the JAX
dry run lowers ``attn_impl="xla"``: the train step's loss runs its default
``attn_impl="torch"`` and ``wkv_impl="chunked"`` (K3 and K5 are
forward-only), prefill and the dense decode step run attention in tensor
ops, and the fp8 GEMM is ``fp8_gemm="plain"`` in place of K4.  The kernel
wrappers keep raising on any device that is neither the CPU nor the card.

**On a mesh** (``--mesh single|multi|both``, the reference's; ``one_card``,
the default, is the one-card run above).  ``single`` is the 256-device
single-pod mesh ``(data 16, model 16)``; ``multi`` the 512-device
multi-pod mesh, whose data axes ``("pod", "data")`` run as one data axis
of 32 (the rule table claims the pair as one candidate of 32, so every
rank's slices are the same), over ``(data 32, model 16)``.  The cell's
real sharded step is traced on the meta device as rank 0 of a world of
``n_devices`` ranks in this process: a fake process group
(``torch.testing._internal.distributed.fake_pg``, whose collectives on
meta tensors return without touching data; ``fake_world``) under a
``DeviceMesh`` of the mesh's shape.  No rank is spawned, nothing is
allocated.  Train cells run ``make_train_step(cfg, run, rules, mesh)`` on
the rank's slices of the meta state (``parallel.sharding.shard_state``)
with the global batch as one broadcast row (the step cuts the rank's rows,
so the rank holds only those, and its arguments count those rows, as the
reference's batch shard); prefill and decode run ``prefill`` /
``forward`` / ``decode_step`` with ``mesh=`` on the serving layout's slices
(``executed_specs``: tensor parallelism, the weights stationary over
data) and the rank's share of the batch (the global batch over the data
axis, where it divides, as the reference shards it).  Attention follows
``parallel.sharding.attention_layout``: where the query heads divide the
model axis they split over it, as the reference's ``heads`` rule, also
where the kv heads do not (the ``"grouped"`` layout).  Where the kv heads
do not divide the model axis, the K/V cache splits its sequence over it
instead, every kv head on every rank (``parallel.sharding.kv_seq_shards``:
the reference's ``kv_seq`` rule; ``decode_step`` / ``prefill`` with
``kv_seq_split=True``).  The record then holds:

* ``per_device_flops`` / ``per_device_hbm_bytes``: the one-card trace's
  global cost over ``n_devices``, as the reference defines them;
* ``collectives``: ``parallel.collectives``' counts of the rank's step
  (``TRAIN_COLLECTIVES`` and ``COLLECTIVES``: each call and its operand
  bytes where the port issues it), and ``collective_s`` their operand
  bytes over ``roofline.NVLINK_BW``, as the reference takes operand bytes
  per device over one link's rate;
* ``memory``: the rank's arguments and peak, the per-device footprint the
  reference's ``memory_analysis`` proves and what ``fits 80GB`` reads.

Results are written incrementally to ``build/dryrun/dryrun_h100.json``
(one card) or ``dryrun_<mesh>.json`` (``--out-dir`` another directory),
so an interrupted sweep resumes from its cached cells.  It needs no
card::

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch olmo-1b --shape train_4k
    PYTHONPATH=src python -m repro_torch.launch.dryrun --mesh single --arch olmo-1b --shape train_4k
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch all --fp8
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import functools
import json
import math
import time
import traceback
from pathlib import Path

import torch
import torch.distributed as dist

from repro_torch.config import SHAPES, MeshConfig, ShapeConfig
from repro_torch.configs import ASSIGNED, get_config
from repro_torch.fp8 import Fp8State, fp8_peak_applies, fp8_supported, scale_keys
from repro_torch.launch.cost import estimate_cost, storage_bytes
from repro_torch.launch.roofline import (
    MESHES,
    RESULTS_DIR,
    dominant_term,
    results_file,
    roofline_terms,
)
from repro_torch.launch.specs import (
    PREFILL_Q_CHUNK,
    TRAIN_KNOBS,
    CellKnobs,
    cell_status,
    decode_input_specs,
    meta,
    prefill_input_specs,
    run_config_for,
    train_input_specs,
)
from repro_torch.models import decode_step, forward, num_scan_groups, param_specs, prefill
from repro_torch.models.cache import cache_window, layer_cache_layout
from repro_torch.optim import adamw_init
from repro_torch.parallel import collectives
from repro_torch.parallel.sharding import (
    executed_specs,
    kv_seq_shards,
    local_kv_heads,
    shard_params,
    shard_state,
    state_shardings,
    training_rules,
)
from repro_torch.train.step import DTYPES, TrainState, make_train_step
from repro_torch.utils.tree import tree_map

# the plain implementations a meta step selects by name
PLAIN = {"attn_impl": "torch", "wkv_impl": "chunked", "fp8_gemm": "plain"}


# ---------------------------------------------------------------------------
# meta state
# ---------------------------------------------------------------------------


def meta_params(cfg, dtype) -> dict:
    """Every parameter of ``param_specs(cfg)`` as a meta tensor of ``dtype``."""
    return tree_map(lambda s: meta(s.shape, dtype), param_specs(cfg))


def meta_cache(cfg, B: int, seq_len: int, dtype, kv_heads: int | None = None, seq_shards: int = 1) -> dict:
    """The dense slot cache of ``models.init_cache`` on the meta device (at
    ``kv_heads`` and ``seq_shards``: a rank's share)."""
    G = num_scan_groups(cfg)

    def make(lay):
        return {k: make(v) if isinstance(v, dict) else meta((G,) + v[0], v[1]) for k, v in lay.items()}

    return make(layer_cache_layout(cfg, B, seq_len, dtype, kv_heads=kv_heads, seq_shards=seq_shards))


def meta_train_state(cfg, run) -> TrainState:
    """``train.init_train_state``'s state on the meta device: parameters,
    AdamW moments and, with fp8, the delayed-scaling state."""
    prec = run.precision
    params = meta_params(cfg, DTYPES[prec.param_dtype])
    opt = adamw_init(params, dtype=DTYPES[prec.optimizer_dtype])
    fp8 = None
    if prec.fp8 and fp8_supported(cfg):
        keys, L = scale_keys(cfg), cfg.num_layers
        fp8 = Fp8State(amax_history={k: meta((L, prec.fp8_amax_history), torch.float32) for k in keys},
                       scale={k: meta((L,), torch.float32) for k in keys}, step=meta((), torch.int32))
    return TrainState(params=params, opt=opt, compress_residual=None, fp8=fp8)


# ---------------------------------------------------------------------------
# per-kind builders: (fn, args) of one step on meta
# ---------------------------------------------------------------------------


def build_train(cfg, run, shape: ShapeConfig, q_chunk: int = 0):
    run = dataclasses.replace(run, precision=dataclasses.replace(run.precision, fp8_gemm=PLAIN["fp8_gemm"]))
    step = make_train_step(cfg, run, q_chunk=q_chunk)
    return step, (meta_train_state(cfg, run), train_input_specs(cfg, shape))


def build_prefill(cfg, run, shape: ShapeConfig, q_chunk: int = PREFILL_Q_CHUNK):
    params = meta_params(cfg, DTYPES[run.precision.param_dtype])
    batch = prefill_input_specs(cfg, shape)
    if cfg.is_encoder_only:  # encoder "prefill" = batched forward inference (no cache exists)

        def fn(p, b):
            return forward(cfg, p, b, q_chunk=q_chunk, attn_impl=PLAIN["attn_impl"], wkv_impl=PLAIN["wkv_impl"])[0]

    else:

        def fn(p, b):
            return prefill(cfg, p, b, q_chunk=q_chunk)

    return fn, (params, batch)


def build_decode(cfg, run, shape: ShapeConfig, q_chunk: int = 0):
    dtype = DTYPES[run.precision.param_dtype]
    params = meta_params(cfg, dtype)
    cache = meta_cache(cfg, shape.global_batch, shape.seq_len, dtype)
    inp = decode_input_specs(cfg, shape)

    def fn(p, c, token, pos):
        return decode_step(cfg, p, c, token, pos)

    return fn, (params, cache, inp["token"], inp["pos"])


BUILDERS = {"train": build_train, "prefill": build_prefill, "decode": build_decode}


# ---------------------------------------------------------------------------
# one rank of a production mesh
# ---------------------------------------------------------------------------


def mesh_geometry(mesh_name: str) -> tuple[int, int, dict]:
    """(data ranks, model ranks, the reference's axis sizes) of a mesh:
    the data axes of ``MeshConfig`` run as one axis of their product."""
    cfg = MeshConfig(multi_pod=mesh_name == "multi")
    sizes = dict(zip(cfg.axis_names, cfg.shape))
    return math.prod(sizes[a] for a in cfg.data_axes), sizes[cfg.model_axis], sizes


@contextlib.contextmanager
def fake_world(n: int):
    """A process group of ``n`` ranks held by this process alone, as rank
    0: torch's fake backend, whose collectives return at once without
    touching data (on meta tensors there is none).  Taken down on exit."""
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        raise RuntimeError("a process group is already initialized; the dry run traces a mesh in a world of its own")
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=n)
    try:
        yield
    finally:
        dist.destroy_process_group()


def rank_mesh(data: int, model: int):
    """The ``(data, model)`` ``DeviceMesh`` over the fake world's ranks."""
    from torch.distributed.device_mesh import DeviceMesh

    return DeviceMesh("cpu", torch.arange(data * model).reshape(data, model), mesh_dim_names=("data", "model"))


def broadcast_rows(t: torch.Tensor) -> torch.Tensor:
    """A meta batch leaf of the global shape as one row broadcast over the
    batch dim: no storage beyond the row (each rank holds only the rows
    the step cuts)."""
    return meta((1,) + tuple(t.shape[1:]), t.dtype).expand(t.shape)


def local_shape_of(shape: ShapeConfig, mesh) -> ShapeConfig:
    """The rank's share of a serving cell's batch: the global batch over the
    data axis where it divides (the reference's ``_batch_shardings``)."""
    d = mesh.size(0)
    return dataclasses.replace(shape, global_batch=shape.global_batch // d if shape.global_batch % d == 0
                               else shape.global_batch)


def meta_serving_params(cfg, run, mesh) -> dict:
    """The rank's slices of the serving layout's parameters, on meta."""
    full = meta_params(cfg, DTYPES[run.precision.param_dtype])
    return shard_params(cfg, full, executed_specs(cfg, mesh)["executed"], mesh)


def build_train_rank(cfg, run, shape: ShapeConfig, mesh, q_chunk: int = 0):
    run = dataclasses.replace(run, precision=dataclasses.replace(run.precision, fp8_gemm=PLAIN["fp8_gemm"]))
    rules = training_rules(run.parallel)
    state = shard_state(meta_train_state(cfg, run), state_shardings(cfg, run, rules, mesh), mesh)
    step = make_train_step(cfg, run, rules, mesh, q_chunk=q_chunk)
    return step, (state, {k: broadcast_rows(v) for k, v in train_input_specs(cfg, shape).items()})


def build_prefill_rank(cfg, run, shape: ShapeConfig, mesh, q_chunk: int = PREFILL_Q_CHUNK):
    params = meta_serving_params(cfg, run, mesh)
    batch = prefill_input_specs(cfg, local_shape_of(shape, mesh))
    if cfg.is_encoder_only:

        def fn(p, b):
            return forward(cfg, p, b, q_chunk=q_chunk, attn_impl=PLAIN["attn_impl"], wkv_impl=PLAIN["wkv_impl"],
                           mesh=mesh)[0]

    else:
        split = kv_seq_shards(cfg, mesh, shape.seq_len) > 1

        def fn(p, b):
            return prefill(cfg, p, b, q_chunk=q_chunk, mesh=mesh, kv_seq_split=split)

    return fn, (params, batch)


def build_decode_rank(cfg, run, shape: ShapeConfig, mesh, q_chunk: int = 0):
    dtype = DTYPES[run.precision.param_dtype]
    params = meta_serving_params(cfg, run, mesh)
    local = local_shape_of(shape, mesh)
    shards = kv_seq_shards(cfg, mesh, cache_window(cfg, local.seq_len))
    kv_heads = cfg.num_kv_heads if shards > 1 else local_kv_heads(cfg, mesh)  # a split ring holds every kv head
    cache = meta_cache(cfg, local.global_batch, local.seq_len, dtype, kv_heads=kv_heads, seq_shards=shards)
    inp = decode_input_specs(cfg, local)

    def fn(p, c, token, pos):
        return decode_step(cfg, p, c, token, pos, mesh=mesh, kv_seq_split=shards > 1)

    return fn, (params, cache, inp["token"], inp["pos"])


RANK_BUILDERS = {"train": build_train_rank, "prefill": build_prefill_rank, "decode": build_decode_rank}


def collective_record(ops_seen: dict) -> dict:
    """The collectives ``parallel.collectives`` counted since its last
    reset, in the reference's record form: calls and operand bytes by
    name, and their total; ``ops``: the c10d ops the trace dispatched
    (``launch.cost``), one a counted call where every collective is
    counted."""
    tables = {**collectives.COLLECTIVES, **collectives.TRAIN_COLLECTIVES}
    names = [k for k in tables if not k.endswith("_bytes") and tables[k]]
    count = {k: tables[k] for k in names}
    operand = {k: tables[k + "_bytes"] for k in names}
    return {"count": count, "operand_bytes": operand, "total_operand_bytes": float(sum(operand.values())),
            "ops": ops_seen}


def cost_rank(cfg, run, shape: ShapeConfig, data: int, model: int, *, q_chunk: int = 0) -> dict:
    """Rank 0's step of ``shape.kind`` on a ``(data, model)`` mesh, traced
    on meta in a fake world of ``data * model`` ranks: its collectives
    (``collective_record``), arguments and peak, and the trace's FLOPs and
    bytes (``rank_flops``, ``rank_hbm_bytes``)."""
    t0 = time.time()
    with fake_world(data * model):
        mesh = rank_mesh(data, model)
        fn, args = RANK_BUILDERS[shape.kind](cfg, run, shape, mesh, q_chunk)
        # a train step's batch is a broadcast row that stands for the rank's rows: it holds those
        rows = args[1] if shape.kind == "train" else {}
        held = sum(t.numel() // data * t.element_size() for t in rows.values()) - storage_bytes(rows)
        argument_bytes = storage_bytes(args) + held
        collectives.reset_collectives()
        est = estimate_cost(fn, *args)
        colls = collective_record(est["collective_ops"])
        del fn, args, rows
    return {"executed_mesh": {"data": data, "model": model}, "rank_trace_s": round(time.time() - t0, 2),
            "collectives": colls, "rank_flops": est["flops"], "rank_hbm_bytes": est["hbm_bytes"],
            "memory": {"argument_bytes": argument_bytes, "temp_bytes": est["peak_bytes"] + held - argument_bytes,
                       "peak_estimate_bytes": est["peak_bytes"] + held}}


# ---------------------------------------------------------------------------
# model-FLOPs reference (6ND convention) for the useful-compute ratio
# ---------------------------------------------------------------------------


def model_flops(cfg, shape) -> float:
    n = cfg.active_param_count()
    tokens = shape.global_batch * (shape.seq_len if shape.kind != "decode" else 1)
    mult = 6.0 if shape.kind == "train" else 2.0
    return mult * n * tokens


# ---------------------------------------------------------------------------
# cell runner
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=8)
def global_cost(cfg, run, shape: ShapeConfig, q_chunk: int = 0) -> tuple[dict, int, float]:
    """(``estimate_cost``'s record, argument bytes, seconds) of the whole
    step on one card, traced on meta once for every mesh that reads it."""
    t0 = time.time()
    fn, args = BUILDERS[shape.kind](cfg, run, shape, q_chunk)
    argument_bytes = storage_bytes(args)
    est = estimate_cost(fn, *args)
    return est, argument_bytes, time.time() - t0


def cost_step(cfg, run, shape: ShapeConfig, *, q_chunk: int = 0, mesh: str = "one_card") -> dict:
    """The dry-run fields of one step of ``shape.kind`` for ``cfg`` under
    ``run``, on meta: FLOPs, bytes, peak memory, roofline, model FLOPs; on
    a production ``mesh``, the global cost over its devices with one
    rank's collectives and memory (``cost_rank``)."""
    kind = shape.kind
    est, argument_bytes, trace_s = global_cost(cfg, dataclasses.replace(run, mesh=MeshConfig()), shape, q_chunk)
    is_fp8 = bool(run.precision.fp8) and fp8_peak_applies(cfg) and kind == "train"
    rec = {"trace_s": round(trace_s, 2), "fp8": is_fp8, "collectives": {},
           "memory": {"argument_bytes": argument_bytes, "temp_bytes": est["peak_bytes"] - argument_bytes,
                      "peak_estimate_bytes": est["peak_bytes"]}}
    n, coll_bytes = 1, 0.0
    if mesh != "one_card":
        data, model, sizes = mesh_geometry(mesh)
        rec.update(cost_rank(cfg, run, shape, data, model, q_chunk=q_chunk), mesh_shape=sizes)
        n = data * model
        coll_bytes = rec["collectives"]["total_operand_bytes"]
    flops, nbytes = est["flops"] / n, est["hbm_bytes"] / n
    terms = roofline_terms(flops, nbytes, coll_bytes, fp8=is_fp8)
    mf = model_flops(cfg, shape)
    rec.update({
        "per_device_flops": flops,
        "per_device_hbm_bytes": nbytes,
        "roofline": terms,
        "dominant": dominant_term(terms),
        "params": cfg.param_count(),
        "active_params": cfg.active_param_count(),
        "model_flops": mf,
        "useful_ratio": mf / max(est["flops"], 1.0),
    })
    return rec


def run_cell(arch: str, shape_name: str, knobs: CellKnobs | None = None, verbose: bool = True,
             mesh: str = "one_card") -> dict:
    if mesh not in MESHES:
        raise ValueError(f"mesh={mesh!r} (choose from {MESHES})")
    cfg = get_config(arch)
    shape = SHAPES[shape_name]
    status = cell_status(cfg, shape_name)
    n = 1 if mesh == "one_card" else MeshConfig(multi_pod=mesh == "multi").num_devices
    rec = {"arch": arch, "shape": shape_name, "mesh": mesh, "n_devices": n, "status": status}
    if status != "run":
        return rec
    cell_knobs = knobs or (TRAIN_KNOBS.get(arch, CellKnobs()) if shape.kind == "train" else CellKnobs())
    run = run_config_for(arch, shape, MeshConfig(multi_pod=mesh == "multi"), knobs=knobs)
    q_chunk = cell_knobs.q_chunk if shape.kind == "train" else PREFILL_Q_CHUNK
    rec.update(cost_step(cfg, run, shape, q_chunk=q_chunk, mesh=mesh))
    rec["knobs"] = dataclasses.asdict(knobs) if knobs else None
    if verbose:
        t = rec["roofline"]
        print(f"  cost ({mesh}, per device of {n}): flops={rec['per_device_flops']:.4g} "
              f"hbm_bytes={rec['per_device_hbm_bytes']:.4g} peak={rec['memory']['peak_estimate_bytes'] / 1e9:.2f} GB "
              f"({rec['trace_s']} s on meta)")
        if rec["collectives"]:
            print(f"  collectives: { {k: f'{v / 1e6:.1f}MB' for k, v in rec['collectives']['operand_bytes'].items()} }")
        print(f"  roofline: compute={t['compute_s'] * 1e3:.2f}ms memory={t['memory_s'] * 1e3:.2f}ms "
              f"collective={t['collective_s'] * 1e3:.2f}ms dominant={rec['dominant']}")
    return rec


# ---------------------------------------------------------------------------
# sweep loop with incremental JSON persistence
# ---------------------------------------------------------------------------


def load_results(out_dir: Path = RESULTS_DIR, mesh: str = "one_card") -> dict:
    path = Path(out_dir) / results_file(mesh)
    if path.exists():
        return json.loads(path.read_text())
    return {}


def save_results(results: dict, out_dir: Path = RESULTS_DIR, mesh: str = "one_card") -> None:
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    (out_dir / results_file(mesh)).write_text(json.dumps(results, indent=1, sort_keys=True))


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--mesh", default="one_card", choices=MESHES + ("both",),
                    help="one card, or one rank of the single-pod (256) or multi-pod (512) mesh; both: single and multi")
    ap.add_argument("--arch", default="all", help="'all' or comma-separated arch ids")
    ap.add_argument("--shape", default="all", help="'all' or comma-separated shape names")
    ap.add_argument("--force", action="store_true", help="recompute cached cells")
    ap.add_argument("--fp8", action="store_true", help="cost train cells with FP8 quantized training enabled")
    ap.add_argument("--out-dir", default=str(RESULTS_DIR), help="directory of the results files")
    args = ap.parse_args(argv)

    archs = ASSIGNED if args.arch == "all" else args.arch.split(",")
    shapes = list(SHAPES) if args.shape == "all" else args.shape.split(",")
    meshes = ["single", "multi"] if args.mesh == "both" else [args.mesh]
    out_dir = Path(args.out_dir)
    for mesh in meshes:
        results = load_results(out_dir, mesh)
        for arch in archs:
            for shape_name in shapes:
                # fp8 cells get their own rows, so a sweep holds both precisions
                key = f"{arch}|{shape_name}" + ("|fp8" if args.fp8 else "")
                if key in results and not args.force and "error" not in results[key]:
                    print(f"[{mesh}] {key}: cached ({results[key]['status']})")
                    continue
                print(f"[{mesh}] {key}: tracing on meta...", flush=True)
                knobs = dataclasses.replace(TRAIN_KNOBS.get(arch, CellKnobs()), fp8=True) if args.fp8 else None
                try:
                    rec = run_cell(arch, shape_name, knobs, mesh=mesh)
                except Exception as e:  # a failure here is a fault of the port
                    traceback.print_exc()
                    rec = {"arch": arch, "shape": shape_name, "mesh": mesh, "status": "error",
                           "error": f"{type(e).__name__}: {e}"}
                results[key] = rec
                save_results(results, out_dir, mesh)
                extra = f" trace={rec.get('trace_s')}s dom={rec.get('dominant')}" if rec["status"] == "run" else ""
                print(f"[{mesh}] {key}: {rec['status']}{extra}", flush=True)

        ok = sum(1 for r in results.values() if r["status"] == "run" and "error" not in r)
        skip = sum(1 for r in results.values() if r["status"].startswith("skip"))
        err = sum(1 for r in results.values() if r["status"] == "error")
        print(f"[{mesh}] {ok} costed, {skip} skipped (documented), {err} errors")


if __name__ == "__main__":
    main()
