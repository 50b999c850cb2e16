"""Roofline terms on one H100 and the report over the dry run's cells.

The counterpart of the JAX package's ``launch/roofline.py`` and of the
roofline terms of its ``launch/hlo_analysis.py`` (``peak_flops``,
``roofline_terms``, ``dominant_term``), at the H100 SXM's published peaks,
the constants ``chip_smoke.py`` uses.  Definitions, per (arch x shape) cell
on ``n_devices`` cards (1, or the 256 or 512 of a production mesh):

    compute_s     = FLOPs / (cards x 989e12), 1979e12 for fp8 cells  [launch.cost]
    memory_s      = HBM bytes / (cards x 3.35e12)                    [launch.cost]
    collective_s  = one rank's collective operand bytes / NVLINK_BW  [parallel.collectives]
    bound_s       = max of the three -> the dominant bottleneck
    model_time_s  = MODEL_FLOPS / (cards x peak), MODEL_FLOPS = 6·N·D
                    (2·N·D for inference kinds; N = active params for MoE)
    roofline_frac = model_time_s / bound_s

``useful_ratio`` = MODEL_FLOPS / FLOPs exposes the remat, attention and
dispatch work beyond the model's own products.

The JAX package takes its collective bytes from the partitioned HLO text
(``hlo_analysis.py``'s ``shape_bytes`` and ``collective_stats``): operand
bytes per device over one step.  The port's collectives count their own
operand bytes where they are issued (``parallel.collectives``), and the
dry run on a mesh traces one rank's step (``launch.dryrun``), so the term
is the same quantity; on one card it is 0.  ``NVLINK_BW`` is one card's
NVLink rate: a model axis wider than an NVLink domain (8 cards) crosses
the slower network, so on the 16-wide model axis the term is a lower
bound.

    python -m repro_torch.launch.roofline [--mesh one_card|single|multi] [--out-dir DIR] [--pick]

reads ``dryrun_h100.json`` (one card) or ``dryrun_<mesh>.json``
(``launch.dryrun``) and needs no card.
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path

PEAK_FLOPS = 989e12  # H100 SXM dense bf16 tensor cores, FLOP/s
PEAK_FLOPS_FP8 = 1979e12  # H100 SXM dense fp8 tensor cores
HBM_BW = 3.35e12  # H100 SXM device memory, bytes/s
NVLINK_BW = 450e9  # H100 SXM NVLink, bytes/s each way
HBM_LIMIT = 80e9  # H100 device memory, bytes

RESULTS_DIR = Path(__file__).resolve().parents[3] / "build" / "dryrun"
RESULTS_FILE = "dryrun_h100.json"  # the one-card run's
MESHES = ("one_card", "single", "multi")


def results_file(mesh: str = "one_card") -> str:
    """The results file of a mesh's dry run."""
    return RESULTS_FILE if mesh == "one_card" else f"dryrun_{mesh}.json"

# one-sentence improvement lever per dominant term, in the port's terms
NOTES = {
    ("memory_s", "train"): "cut HBM passes: fuse the fp32 elementwise chains (casts, AdamW), keep P in the flash kernel",
    ("memory_s", "prefill"): "run attention through K3 (no S x S scores in HBM); serve bf16 weights",
    ("memory_s", "decode"): "weights and KV reads dominate: bf16 or fp8 weights, quantized KV, larger decode batches",
    ("compute_s", "train"): "near the compute roofline: the dots remat policy sheds recompute; fp8 GEMMs through K4",
    ("compute_s", "prefill"): "attention FLOPs dominate at 32k: sliding-window or block-sparse attention, chunked prefill",
    ("compute_s", "decode"): "GEMM-bound decode: batch more requests per step (continuous batching)",
    ("collective_s", "train"): "overlap the gradient reduce-scatter with the backward; compress gradients",
    ("collective_s", "prefill"): "all-gather of sequence-parallel activations: overlap with per-layer compute",
    ("collective_s", "decode"): "per-layer tensor-parallel all-reduce gates latency: fewer, larger all-reduces",
}


def peak_flops(fp8: bool = False) -> float:
    """Per-card matmul peak for the run's GEMM precision (fp8 doubles it)."""
    return PEAK_FLOPS_FP8 if fp8 else PEAK_FLOPS


def roofline_terms(per_device_flops: float, per_device_bytes: float, collective_operand_bytes: float, *,
                   fp8: bool = False) -> dict:
    """The three terms, in seconds, per card.  ``fp8`` runs are costed
    against the doubled 8-bit matmul peak."""
    return {
        "compute_s": per_device_flops / peak_flops(fp8),
        "memory_s": per_device_bytes / HBM_BW,
        "collective_s": collective_operand_bytes / NVLINK_BW,
    }


def dominant_term(terms: dict) -> str:
    return max(("compute_s", "memory_s", "collective_s"), key=lambda k: terms[k])


def load(out_dir: Path = RESULTS_DIR, mesh: str = "one_card") -> dict:
    p = Path(out_dir) / results_file(mesh)
    return json.loads(p.read_text()) if p.exists() else {}


def cell_rows(results: dict) -> list[dict]:
    rows = []
    for key, r in sorted(results.items()):
        if r.get("status") != "run" or "roofline" not in r:
            rows.append({"arch": r["arch"], "shape": r["shape"], "status": r.get("status", "?")})
            continue
        t = r["roofline"]
        bound = max(t.values())
        cards = r["n_devices"]
        # fp8 cells are costed against the doubled 8-bit matmul peak
        model_time = r["model_flops"] / (cards * peak_flops(r.get("fp8", False)))
        kind = "train" if r["shape"].startswith("train") else ("prefill" if "prefill" in r["shape"] else "decode")
        rows.append(
            {
                "arch": r["arch"],
                "shape": r["shape"],
                "status": "ok",
                "kind": kind,
                "fp8": r.get("fp8", False),
                "params": r["params"],
                "active_params": r["active_params"],
                "compute_s": t["compute_s"],
                "memory_s": t["memory_s"],
                "collective_s": t["collective_s"],
                "dominant": r["dominant"],
                "model_flops": r["model_flops"],
                "useful_ratio": r["useful_ratio"],
                "roofline_frac": model_time / bound if bound > 0 else 0.0,
                "peak_gb": r["memory"]["peak_estimate_bytes"] / 1e9,
                "fits": r["memory"]["peak_estimate_bytes"] <= HBM_LIMIT,
                "note": NOTES.get((r["dominant"], kind), ""),
                "collectives": r.get("collectives", {}),
            }
        )
    return rows


def fmt_ms(s: float) -> str:
    return f"{s * 1e3:.2f}"


def markdown_table(rows: list[dict]) -> str:
    hdr = (
        "| arch | shape | N (act.) | compute ms | memory ms | coll. ms | dominant | "
        "6ND/FLOPs | roofline frac | peak GB | fits 80GB | improvement lever |\n"
        "|---|---|---|---|---|---|---|---|---|---|---|---|\n"
    )
    out = [hdr]
    for r in rows:
        if r.get("status") != "ok":
            out.append(f"| {r['arch']} | {r['shape']} | — | — | — | — | — | — | — | — | — | {r['status']} |\n")
            continue
        ap = r["active_params"]
        n_str = f"{r['params'] / 1e9:.1f}B" + (f" ({ap / 1e9:.1f}B)" if ap != r["params"] else "")
        out.append(
            f"| {r['arch']} | {r['shape']} | {n_str} | {fmt_ms(r['compute_s'])} | {fmt_ms(r['memory_s'])} "
            f"| {fmt_ms(r['collective_s'])} | {r['dominant'].replace('_s', '')} | {r['useful_ratio']:.2f} "
            f"| {r['roofline_frac']:.1%} | {r['peak_gb']:.1f} | {'yes' if r['fits'] else 'NO'} | {r['note']} |\n"
        )
    return "".join(out)


def pick_hillclimb(rows: list[dict]) -> dict:
    ok = [r for r in rows if r.get("status") == "ok"]
    worst = min(ok, key=lambda r: r["roofline_frac"])
    coll = max(ok, key=lambda r: r["collective_s"] / max(max(r["compute_s"], r["memory_s"]), 1e-12))
    # the paper's raison d'être is frontier LLM training: the large MoE
    # training cell where it was costed, else the largest model's
    rep = next(
        (r for r in ok if r["arch"] == "qwen3-moe-235b-a22b" and r["shape"] == "train_4k"),
        max(ok, key=lambda r: r["params"]),
    )
    return {"worst_fraction": worst, "most_collective_bound": coll, "most_representative": rep}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--mesh", default="one_card", choices=MESHES, help="whose dry run to read")
    ap.add_argument("--out-dir", default=str(RESULTS_DIR), help="directory of the dry run's results files")
    ap.add_argument("--pick", action="store_true", help="print hillclimb cell selection")
    args = ap.parse_args(argv)
    rows = cell_rows(load(Path(args.out_dir), args.mesh))
    print(markdown_table(rows))
    if args.pick and any(r.get("status") == "ok" for r in rows):
        sel = pick_hillclimb(rows)
        for why, r in sel.items():
            print(f"{why}: {r['arch']} x {r['shape']} (frac={r['roofline_frac']:.1%}, dom={r['dominant']})")


if __name__ == "__main__":
    main()
