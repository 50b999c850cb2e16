"""The port's dry run over the 256-device mesh (``launch.dryrun.run_cell(
mesh="single")``) held against the reference's (``repro.launch.dryrun.
run_cell`` on 256 forced host devices, run as its own process by
``tests/jax_dryrun_cells.py``), cell by cell, on the CPU.

The config is the smoke one widened so the heads split over the model
axis of 16 (d_model 256, 16 heads of 16, d_ff 1024, vocab 4096): olmo-1b
with 16 kv heads (its own ratio: every head splits) and qwen3-moe with 4
(as its 64 over 4: the query heads split while the kv heads do not divide
16, the ``"grouped"`` layout, so each rank attends over its GQA group's kv
head and the cache splits its sequence over the model axis, the
reference's ``kv_seq`` rule).  Each cell holds:

* ``n_devices`` exactly;
* ``per_device_flops`` within 3% and ``per_device_hbm_bytes`` within 1%
  (the two cost models count the same step each its own way: the moe
  dispatch's gathers and the router are where they part, 2.3% here);
* the collectives' operand bytes at most the reference's: the port's are
  its own explicit calls, the reference's what XLA's partitioner inserts
  for the same step (0.01-0.31 of them here);
* for train and decode, the rank's arguments (the resident state: its
  weights and optimizer slices and batch rows, or its weights and its
  share of the cache) within 20% of the reference's: this is what decides
  whether a full-width cell fits 80 GB;
* for decode, the rank's peak at most the reference's (XLA's temporaries
  hold copies of the cache; the port writes it in place);
* for train and prefill, the rank's peak at most ``PEAK_RATIO`` times the
  reference's: olmo-1b's at the ratios it had before the grouped layout
  (0.65419 and 2.20447, held at 0.6542 and 2.2045), qwen3-moe's within
  1.5 and 3.0 times (8.7 and 17.6 when every rank attended with every
  head and the moe routing's group one-hot spanned every group of the
  batch; 0.70 and 1.77 now).

Not held (PERF.md section 7): prefill's arguments, since the port's
serving layout keeps the weights whole over the data axis where the
reference's rules shard them.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from repro_torch.config import reduce_for_smoke
from repro_torch.configs import get_config
from repro_torch.launch import dryrun

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parents[1]
WIDTHS = dict(d_model=256, num_heads=16, head_dim=16, d_ff=1024, vocab_size=4096)
CELLS = [("olmo-1b", s, 16) for s in ("train_4k", "decode_32k", "prefill_32k")]
CELLS += [("qwen3-moe-235b-a22b", s, 4) for s in ("train_4k", "decode_32k", "prefill_32k")]
FLOPS_REL, BYTES_REL, ARGS_REL = 0.03, 0.01, 0.20
# the most the rank's peak may be, as a multiple of the reference's
PEAK_RATIO = {("olmo-1b", "train_4k"): 0.6542, ("olmo-1b", "prefill_32k"): 2.2045,
              ("qwen3-moe-235b-a22b", "train_4k"): 1.5, ("qwen3-moe-235b-a22b", "prefill_32k"): 3.0}


@pytest.fixture(scope="module")
def records(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("dryrun_reference")
    (tmp / "cases.json").write_text(json.dumps({"widths": WIDTHS, "cells": CELLS}))
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.Popen([sys.executable, str(ROOT / "tests" / "jax_dryrun_cells.py"), str(tmp / "cases.json"),
                             str(tmp / "jax.json")], env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
    ours = {}
    for arch, shape, kv in CELLS:
        cut = reduce_for_smoke(get_config(arch)).replace(num_kv_heads=kv, **WIDTHS)
        dryrun_get_config, dryrun.get_config = dryrun.get_config, lambda a, cut=cut: cut
        try:
            ours[f"{arch}|{shape}"] = dryrun.run_cell(arch, shape, verbose=False, mesh="single")
        finally:
            dryrun.get_config = dryrun_get_config
    out, _ = proc.communicate(timeout=300)
    assert proc.returncode == 0, out.decode()[-4000:]
    return ours, json.loads((tmp / "jax.json").read_text())


@pytest.mark.parametrize("arch,shape,kv", CELLS)
def test_mesh_cell_against_the_reference(records, arch, shape, kv):
    ours, theirs = (r[f"{arch}|{shape}"] for r in records)
    assert ours["status"] == theirs["status"] == "run"
    assert ours["n_devices"] == theirs["n_devices"] == 256
    assert ours["per_device_flops"] == pytest.approx(theirs["per_device_flops"], rel=FLOPS_REL)
    assert ours["per_device_hbm_bytes"] == pytest.approx(theirs["per_device_hbm_bytes"], rel=BYTES_REL)
    assert 0 < ours["collectives"]["total_operand_bytes"] <= theirs["collectives"]["total_operand_bytes"]
    mem, ref = ours["memory"], theirs["memory"]
    if not shape.startswith("prefill"):  # qwen3-moe's decode: 16x the reference's without the split ring
        assert mem["argument_bytes"] == pytest.approx(ref["argument_bytes"], rel=ARGS_REL)
    if shape.startswith("decode"):
        assert mem["peak_estimate_bytes"] <= ref["peak_estimate_bytes"]
    else:
        assert mem["peak_estimate_bytes"] <= PEAK_RATIO[arch, shape] * ref["peak_estimate_bytes"]
