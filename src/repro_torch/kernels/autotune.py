"""Paged-attention autotuner of the port: sweep K1/K2 layouts on the card, cache the winners.

The counterpart of the JAX package's ``kernels/autotune.py``.  K1 and K2
(``kernels/csrc/paged_attention.cu``) have layout knobs whose best setting
depends on the problem shape, not the code, and which the library
otherwise fixes by a rule of its own:

* ``decode_kernel`` — single-token rows run K1 (``"paged"``) or K2 at
  C = 1 with ``start = seq_lens - 1`` (``"prefill1"``), whose masks then
  degenerate to the decode masks exactly; K2 takes all of a kv head's query
  rows on its 64-row ``wgmma`` tiles, where K1 walks them on the CUDA
  cores.
* ``decode_split`` — K1's thread-block cluster: each (sequence, kv head)'s
  walk is split over 1, 2, 4 or 8 blocks (``DECODE_SPLITS``).
* ``prefill_split`` — K2's tensor-core cluster: 1 to 4 blocks share each
  64-row tile's keys (``PREFILL_SPLITS``; the tensor-core route of bf16
  pools only: fp32 pools run v1, which has no split).

0 means the library's own pick (``paged_decode_split`` and
``paged_prefill_tc_split`` in the CUDA source).  The JAX tuner's
``prefill_rows_per_tile`` has no counterpart: Hopper's K2 works on fixed
64-row ``wgmma`` tiles, and ``_sanitize`` ignores that knob in a table.

``autotune()`` times every candidate per case on the card with
``benchmarks.timing`` (the calls queued behind a device sleep, so device
time and not the host's issue decides), holds each candidate's output
against the plain version (``TOL``) before it may win, and records the
winner under a key of ``(head_dim, block_size, page_count, dtype)`` plus
the query heads per kv head, on which the best split also depends.
``benchmarks/paged_attention.py`` exposes the sweep as ``--autotune``.
Lookup order:

1. the user cache: ``$REPRO_TORCH_AUTOTUNE_CACHE`` or
   ``~/.cache/repro_torch/cuda_autotune.json`` (written by ``autotune()``;
   the port's own paths, so a JAX cache never steers it)
2. the in-repo defaults: ``src/repro_torch/kernels/autotune_defaults.json``
3. the entry for any page count (``pages0``) of either file
4. the ``"default"`` entry of either file, which reproduces the library's
   behaviour: ``"paged"``, split 0, split 0

``get_config`` is pure given the files (no timing at lookup).  The
wrappers of ``kernels.paged_attention`` read it on the host in their CUDA
branch, when a call is made or a CUDA graph is captured; a captured graph
bakes the choice in, as a jitted JAX graph does.  Their CPU branch takes
the plain versions and never reads the table.  A split out of range in a
table is not dropped: the launch raises on it.
"""

from __future__ import annotations

import itertools
import json
import os
from functools import lru_cache
from pathlib import Path

import torch

DEFAULTS_PATH = Path(__file__).with_name("autotune_defaults.json")
CACHE_ENV = "REPRO_TORCH_AUTOTUNE_CACHE"

DECODE_KERNELS = ("paged", "prefill1")
DECODE_SPLITS = (0, 1, 2, 4, 8)  # K1's cluster; 0 = the library's pick
PREFILL_SPLITS = (0, 1, 2, 3, 4)  # K2's tensor-core cluster; 0 = the library's pick
SPLIT_KNOBS = ("decode_split", "prefill_split")

DEFAULT_CONFIG = {"decode_kernel": "paged", "decode_split": 0, "prefill_split": 0}  # the library's own pick

# a candidate must agree with the plain version to win: the kernel phase's
# limits (fp32 queries: sums in another order; bf16 queries: the output's
# rounding to bf16)
TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}


def dtype_name(dtype) -> str:
    """``torch.bfloat16`` and ``"bfloat16"`` alike -> ``"bfloat16"``, the
    JAX key's spelling."""
    return str(dtype).replace("torch.", "")


def cache_key(head_dim: int, block_size: int, page_count: int, dtype, q_per_kv: int) -> str:
    return f"hd{head_dim}_bs{block_size}_pages{page_count}_{dtype_name(dtype)}_qpk{q_per_kv}"


def user_cache_path() -> Path:
    env = os.environ.get(CACHE_ENV)
    if env:
        return Path(env)
    return Path.home() / ".cache" / "repro_torch" / "cuda_autotune.json"


def _read_json(path: Path) -> dict:
    try:
        with open(path) as f:
            table = json.load(f)
    except (OSError, ValueError):
        return {}
    return table if isinstance(table, dict) else {}


@lru_cache(maxsize=None)
def _load_table(defaults: str, user: str) -> dict:
    table = _read_json(Path(defaults))
    table.update(_read_json(Path(user)))
    return table


def load_table(refresh: bool = False) -> dict:
    """Merged tuning table (user cache entries shadow in-repo defaults)."""
    if refresh:
        _load_table.cache_clear()
        _lookup.cache_clear()
    return _load_table(str(DEFAULTS_PATH), str(user_cache_path()))


def _sanitize(entry) -> dict:
    """The entry's knobs over the defaults.  An unknown ``decode_kernel``
    reads as ``"paged"``, as in the JAX tuner; a split must be an int (the
    launch checks its range); ``prefill_rows_per_tile``, the JAX tuner's
    knob, has no counterpart and is ignored."""
    cfg = dict(DEFAULT_CONFIG)
    if isinstance(entry, dict):
        dk = entry.get("decode_kernel", "paged")
        if dk in DECODE_KERNELS:
            cfg["decode_kernel"] = dk
        for knob in SPLIT_KNOBS:
            value = entry.get(knob, 0)
            if not isinstance(value, int) or isinstance(value, bool):
                raise ValueError(f"autotune table: {knob}={value!r} is not an int")
            cfg[knob] = value
    return cfg


@lru_cache(maxsize=None)
def _lookup(head_dim, block_size, page_count, dtype, q_per_kv, defaults, user) -> tuple:
    table = _load_table(defaults, user)
    entry = table.get(cache_key(head_dim, block_size, page_count, dtype, q_per_kv))
    if entry is None:
        entry = table.get(cache_key(head_dim, block_size, 0, dtype, q_per_kv))  # any page count
    if entry is None:
        entry = table.get("default")
    return tuple(_sanitize(entry).items())


def get_config(head_dim: int, block_size: int, page_count: int, dtype, q_per_kv: int) -> dict:
    """Tuned kernel config for one problem shape (falls back to defaults).

    Called on the host by ``kernels.paged_attention``'s CUDA branch at each
    call, so a captured graph bakes the choice in."""
    return dict(_lookup(head_dim, block_size, page_count, dtype_name(dtype), q_per_kv, str(DEFAULTS_PATH),
                        str(user_cache_path())))


# ---------------------------------------------------------------------------
# sweep
# ---------------------------------------------------------------------------


def build_case(kind: str, B: int, nb: int, bs: int, H: int, KV: int, hd: int, dtype, *, q_dtype=torch.float32,
               lens=None, chunk=(128, 192), layers: int = 8, device="cuda", seed: int = 0) -> dict:
    """Inputs of one case on ``device``: ``layers`` pools of ``dtype`` (a
    timing loop reads a different one each call, so they do not all sit in
    the L2 cache), random block tables with null padding past each
    sequence's live blocks.  Decode: one sequence per length of ``lens``
    (default: every table full), q (B, H, hd).  Prefill: one C-token chunk
    at ``start`` (``chunk``), q (1, C, H, hd)."""
    g = torch.Generator().manual_seed(seed)
    if kind == "decode":
        lens = list(lens) if lens is not None else [nb * bs] * B
        last = [n - 1 for n in lens]
    else:
        B = 1
        C, start = chunk
        last = [start + C - 1]
    N = 1 + B * nb + 2
    tbl = (torch.randperm(N - 1, generator=g)[: B * nb] + 1).reshape(B, nb).to(torch.int32)
    for b in range(B):
        tbl[b, last[b] // bs + 1 :] = 0
    dt = getattr(torch, dtype_name(dtype))
    pools = [torch.randn((layers, N, bs, KV, hd), generator=g).to(dt) for _ in range(2)]
    if kind == "decode":
        q = torch.randn((B, H, hd), generator=g)
        lens = torch.tensor(lens, dtype=torch.int32)
    else:
        q = torch.randn((B, C, H, hd), generator=g)
        lens = torch.tensor([start], dtype=torch.int32)
    to = lambda t: t.to(device)  # noqa: E731
    return dict(kind=kind, q=to(q.to(q_dtype)), k=to(pools[0]), v=to(pools[1]), tbl=to(tbl), lens=to(lens),
                layers=layers)


def _candidates(case: dict, kind: str, prefill_split: int = 0) -> list[tuple[str, dict]]:
    from repro_torch.kernels.paged_attention import prefill_route

    if kind == "prefill":
        tc = prefill_route(case["q"].dtype, case["k"].dtype) == "tensor_cores_bf16"
        splits = PREFILL_SPLITS if tc else (0,)  # v1 (fp32 pools) has no split
        return [(f"prefill/split{s}", {**DEFAULT_CONFIG, "prefill_split": s}) for s in splits]
    out = [(f"paged/split{s}", {**DEFAULT_CONFIG, "decode_split": s}) for s in DECODE_SPLITS]
    out.append((f"prefill1/split{prefill_split}",
                {**DEFAULT_CONFIG, "decode_kernel": "prefill1", "prefill_split": prefill_split}))
    return out


def _sweep(c: dict, kind: str, iters: int, *, window: int, prefill_split: int = 0) -> dict:
    """Time and check every candidate of one kind on the case ``c``."""
    from repro_torch.benchmarks.timing import time_per_call
    from repro_torch.kernels import paged_attention as K
    from repro_torch.kernels.paged_attention_ref import paged_attention_plain, paged_prefill_attention_plain

    launch = K.launch_decode if kind == "decode" else K.launch_prefill
    plain = paged_attention_plain if kind == "decode" else paged_prefill_attention_plain
    ref = plain(c["q"], c["k"][0], c["v"][0], c["tbl"], c["lens"], window=window).float()
    tol = TOL[c["q"].dtype]
    rows = {}
    for name, tuned in _candidates(c, kind, prefill_split):
        out = launch(c["q"], c["k"][0], c["v"][0], c["tbl"], c["lens"], window=window, tuned=tuned)
        err = float((out.float() - ref).abs().max())
        if not err < tol:  # a layout that disagrees never wins
            raise RuntimeError(f"autotune {kind} {name}: max error {err} against the plain version >= {tol}")

        def call(tuned=tuned, layers=itertools.cycle(range(c["layers"]))):
            i = next(layers)  # another layer's pools each call
            return launch(c["q"], c["k"][i], c["v"][i], c["tbl"], c["lens"], window=window, tuned=tuned)

        rows[name] = {"config": tuned, "s": time_per_call(call, iters, c["q"].device, queued=True),
                      "max_abs_err": err}
    return rows


def tune_case(B: int, nb: int, bs: int, H: int, KV: int, hd: int, dtype="bfloat16", iters: int = 20,
              device="cuda", *, lens=None, window: int = 0, chunk=(128, 192), inputs: dict | None = None) -> dict:
    """Time every candidate for one shape on the card; return the winning
    config, each candidate's time and error, and the library's own picks.

    K2's splits are swept first on a ``chunk`` = (C, start) prefill, then
    K1's splits and ``"prefill1"`` (at K2's winning split, as the table
    entry would run it) on a decode over ``lens``, fp32 queries, under
    ``window``.  ``inputs`` may hand in ``{"decode": case, "prefill": case}``
    built as ``build_case`` does.  There is no timing off the card: any
    other device raises."""
    from repro_torch.kernels import paged_attention as K

    device = torch.device(device)
    if device.type != "cuda":
        raise ValueError(f"tune_case times kernels on the card, not on {device}")
    if inputs is None:
        inputs = {"decode": build_case("decode", B, nb, bs, H, KV, hd, dtype, lens=lens, device=device),
                  "prefill": build_case("prefill", B, nb, bs, H, KV, hd, dtype, chunk=chunk, device=device)}
    prefill = _sweep(inputs["prefill"], "prefill", iters, window=window)
    best_prefill = min(prefill, key=lambda n: prefill[n]["s"])
    prefill_split = prefill[best_prefill]["config"]["prefill_split"]
    decode = _sweep(inputs["decode"], "decode", iters, window=window, prefill_split=prefill_split)
    best_decode = min(decode, key=lambda n: decode[n]["s"])
    d, p = inputs["decode"], inputs["prefill"]
    picked = {  # what split 0 resolves to on these shapes
        "decode_split": K._decode_split(d["q"], d["k"][0], d["tbl"], window=window),
        "prefill_split": K._prefill_split(p["q"], p["k"][0], p["tbl"], window=window),
    }
    won = decode[best_decode]["config"]
    return {
        "decode_kernel": won["decode_kernel"],
        "decode_split": won["decode_split"],
        "prefill_split": prefill_split,
        "decode_s": decode[best_decode]["s"],
        "prefill_s": prefill[best_prefill]["s"],
        "library": {"decode_s": decode["paged/split0"]["s"], "prefill_s": prefill["prefill/split0"]["s"],
                    **picked},
        "candidates": {"decode": decode, "prefill": prefill},
    }


def autotune(cases, dtype="bfloat16", iters: int = 20, out_path: Path | None = None, device="cuda") -> dict:
    """Sweep ``cases`` (tuples of (B, nb, block_size, H, KV, hd)) on the
    card and write the winners to the user cache (creating parent dirs)."""
    out_path = Path(out_path) if out_path else user_cache_path()
    table = _read_json(out_path)
    for B, nb, bs, H, KV, hd in cases:
        won = tune_case(B, nb, bs, H, KV, hd, dtype=dtype, iters=iters, device=device)
        key = cache_key(hd, bs, nb, dtype, H // KV)
        table[key] = {knob: won[knob] for knob in DEFAULT_CONFIG}
        lib = won["library"]
        print(f"{key}: {table[key]}  (decode {won['decode_s'] * 1e3:.5f} ms against the library's "
              f"{lib['decode_s'] * 1e3:.5f} at split {lib['decode_split']}; prefill {won['prefill_s'] * 1e3:.5f} "
              f"ms against {lib['prefill_s'] * 1e3:.5f} at split {lib['prefill_split']})", flush=True)
    out_path.parent.mkdir(parents=True, exist_ok=True)
    with open(out_path, "w") as f:
        json.dump(table, f, indent=2, sort_keys=True)
        f.write("\n")
    load_table(refresh=True)
    return table


def check_determinism() -> None:
    """Lookups are pure, every entry is valid and the cache round-trips
    byte-stably."""
    table = load_table(refresh=True)
    assert isinstance(table, dict) and "default" in table, "defaults file must define 'default'"
    for key, entry in table.items():
        cfg = _sanitize(entry)
        assert cfg["decode_kernel"] in DECODE_KERNELS, (key, cfg)
        assert cfg["decode_split"] in DECODE_SPLITS, (key, cfg)
        assert cfg["prefill_split"] in PREFILL_SPLITS, (key, cfg)
    a = get_config(128, 32, 16, "bfloat16", 1)
    b = get_config(128, 32, 16, "bfloat16", 1)
    assert a == b, "get_config must be deterministic"
    dumped = json.dumps(table, indent=2, sort_keys=True)
    assert json.dumps(json.loads(dumped), indent=2, sort_keys=True) == dumped
    print("autotune cache deterministic:", len(table), "entries")


def main(argv=None) -> None:
    import argparse

    ap = argparse.ArgumentParser(description="K1/K2 paged-attention autotuner (on the card)")
    ap.add_argument("--check", action="store_true", help="verify cache determinism, no sweep")
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--dtype", default="bfloat16")
    ap.add_argument("--out", default=None, help="cache path (default: user cache)")
    args = ap.parse_args(argv)
    if args.check:
        check_determinism()
        return
    from repro_torch.benchmarks.paged_attention import CASES  # the canonical sweep shapes

    autotune(CASES, dtype=args.dtype, iters=args.iters, out_path=args.out)


if __name__ == "__main__":
    main()
