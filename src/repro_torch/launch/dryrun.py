"""One-card dry run: cost every (architecture x shape) cell on the meta device.

The counterpart of the JAX package's ``launch/dryrun.py``, for one H100.
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

* ``per_device_flops`` and ``per_device_hbm_bytes`` (``launch.cost``;
  ``n_devices`` is 1),
* ``params``, ``active_params``, ``model_flops`` (6ND for train, 2ND for
  inference, D the tokens of the step) and ``useful_ratio``,
* ``roofline``, ``dominant`` and ``fp8`` (``launch.roofline``: fp8 train
  cells of the families whose quantized sites carry the dominant GEMMs
  are costed at the fp8 peak),
* ``memory.peak_estimate_bytes``: the most bytes of meta storage live at
  once during the step, its arguments included.

On meta the cell selects the plain implementations by name, as the JAX
dry run lowers ``attn_impl="xla"``: the train step's loss runs its default
``attn_impl="torch"`` and ``wkv_impl="chunked"`` (K3 and K5 are
forward-only), prefill and the dense decode step run attention in tensor
ops, and the fp8 GEMM is ``fp8_gemm="plain"`` in place of K4.  The kernel
wrappers keep raising on any device that is neither the CPU nor the card.
No collective term yet (``launch.roofline``).

Results are written incrementally to ``build/dryrun/dryrun_h100.json``
(``--out-dir`` another directory), so an interrupted sweep resumes from
its cached cells.  It needs no card::

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch olmo-1b --shape train_4k
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch all --fp8
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import time
import traceback
from pathlib import Path

import torch

from repro_torch.config import SHAPES, ShapeConfig
from repro_torch.configs import ASSIGNED, get_config
from repro_torch.fp8 import Fp8State, fp8_peak_applies, fp8_supported, scale_keys
from repro_torch.launch.cost import estimate_cost, storage_bytes
from repro_torch.launch.roofline import RESULTS_DIR, RESULTS_FILE, dominant_term, roofline_terms
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
from repro_torch.models.cache import layer_cache_layout
from repro_torch.optim import adamw_init
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


def meta_cache(cfg, B: int, seq_len: int, dtype) -> dict:
    """The dense slot cache of ``models.init_cache`` on the meta device."""
    G = num_scan_groups(cfg)

    def make(lay):
        return {k: make(v) if isinstance(v, dict) else meta((G,) + v[0], v[1]) for k, v in lay.items()}

    return make(layer_cache_layout(cfg, B, seq_len, dtype))


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


def cost_step(cfg, run, shape: ShapeConfig, *, q_chunk: int = 0) -> dict:
    """The dry-run fields of one step of ``shape.kind`` for ``cfg`` under
    ``run``, on meta: FLOPs, bytes, peak memory, roofline, model FLOPs."""
    kind = shape.kind
    t0 = time.time()
    fn, args = BUILDERS[kind](cfg, run, shape, q_chunk)
    argument_bytes = storage_bytes(args)
    est = estimate_cost(fn, *args)
    trace_s = time.time() - t0
    is_fp8 = bool(run.precision.fp8) and fp8_peak_applies(cfg) and kind == "train"
    terms = roofline_terms(est["flops"], est["hbm_bytes"], 0.0, fp8=is_fp8)
    mf = model_flops(cfg, shape)
    return {
        "trace_s": round(trace_s, 2),
        "fp8": is_fp8,
        "per_device_flops": est["flops"],
        "per_device_hbm_bytes": est["hbm_bytes"],
        "collectives": {},
        "memory": {"argument_bytes": argument_bytes, "temp_bytes": est["peak_bytes"] - argument_bytes,
                   "peak_estimate_bytes": est["peak_bytes"]},
        "roofline": terms,
        "dominant": dominant_term(terms),
        "params": cfg.param_count(),
        "active_params": cfg.active_param_count(),
        "model_flops": mf,
        "useful_ratio": mf / max(est["flops"], 1.0),
    }


def run_cell(arch: str, shape_name: str, knobs: CellKnobs | None = None, verbose: bool = True) -> dict:
    cfg = get_config(arch)
    shape = SHAPES[shape_name]
    status = cell_status(cfg, shape_name)
    rec = {"arch": arch, "shape": shape_name, "mesh": "one_card", "n_devices": 1, "status": status}
    if status != "run":
        return rec
    cell_knobs = knobs or (TRAIN_KNOBS.get(arch, CellKnobs()) if shape.kind == "train" else CellKnobs())
    run = run_config_for(arch, shape, knobs=knobs)
    q_chunk = cell_knobs.q_chunk if shape.kind == "train" else PREFILL_Q_CHUNK
    rec.update(cost_step(cfg, run, shape, q_chunk=q_chunk))
    rec["knobs"] = dataclasses.asdict(knobs) if knobs else None
    if verbose:
        t = rec["roofline"]
        print(f"  cost (one card): flops={rec['per_device_flops']:.4g} hbm_bytes={rec['per_device_hbm_bytes']:.4g} "
              f"peak={rec['memory']['peak_estimate_bytes'] / 1e9:.2f} GB ({rec['trace_s']} s on meta)")
        print(f"  roofline: compute={t['compute_s'] * 1e3:.2f}ms memory={t['memory_s'] * 1e3:.2f}ms "
              f"collective={t['collective_s'] * 1e3:.2f}ms dominant={rec['dominant']}")
    return rec


# ---------------------------------------------------------------------------
# sweep loop with incremental JSON persistence
# ---------------------------------------------------------------------------


def load_results(out_dir: Path = RESULTS_DIR) -> dict:
    path = Path(out_dir) / RESULTS_FILE
    if path.exists():
        return json.loads(path.read_text())
    return {}


def save_results(results: dict, out_dir: Path = RESULTS_DIR) -> None:
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    (out_dir / RESULTS_FILE).write_text(json.dumps(results, indent=1, sort_keys=True))


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="all", help="'all' or comma-separated arch ids")
    ap.add_argument("--shape", default="all", help="'all' or comma-separated shape names")
    ap.add_argument("--force", action="store_true", help="recompute cached cells")
    ap.add_argument("--fp8", action="store_true", help="cost train cells with FP8 quantized training enabled")
    ap.add_argument("--out-dir", default=str(RESULTS_DIR), help=f"directory of {RESULTS_FILE}")
    args = ap.parse_args(argv)

    archs = ASSIGNED if args.arch == "all" else args.arch.split(",")
    shapes = list(SHAPES) if args.shape == "all" else args.shape.split(",")
    out_dir = Path(args.out_dir)
    results = load_results(out_dir)
    for arch in archs:
        for shape_name in shapes:
            # fp8 cells get their own rows, so a sweep holds both precisions
            key = f"{arch}|{shape_name}" + ("|fp8" if args.fp8 else "")
            if key in results and not args.force and "error" not in results[key]:
                print(f"[one_card] {key}: cached ({results[key]['status']})")
                continue
            print(f"[one_card] {key}: tracing on meta...", flush=True)
            knobs = dataclasses.replace(TRAIN_KNOBS.get(arch, CellKnobs()), fp8=True) if args.fp8 else None
            try:
                rec = run_cell(arch, shape_name, knobs)
            except Exception as e:  # a failure here is a fault of the port
                traceback.print_exc()
                rec = {"arch": arch, "shape": shape_name, "mesh": "one_card", "status": "error",
                       "error": f"{type(e).__name__}: {e}"}
            results[key] = rec
            save_results(results, out_dir)
            extra = f" trace={rec.get('trace_s')}s dom={rec.get('dominant')}" if rec["status"] == "run" else ""
            print(f"[one_card] {key}: {rec['status']}{extra}", flush=True)

    ok = sum(1 for r in results.values() if r["status"] == "run" and "error" not in r)
    skip = sum(1 for r in results.values() if r["status"].startswith("skip"))
    err = sum(1 for r in results.values() if r["status"] == "error")
    print(f"[one_card] {ok} costed, {skip} skipped (documented), {err} errors")


if __name__ == "__main__":
    main()
