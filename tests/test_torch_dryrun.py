"""The port's one-card dry run (``repro_torch.launch.specs``, ``dryrun``,
``roofline``) against the JAX package's, on the CPU.

* For every assigned arch and every shape: the input specs' shapes and
  dtypes (meta tensors against ``ShapeDtypeStruct``), ``cell_status`` and
  the fields of ``run_config_for`` equal the JAX package's.
* For every assigned arch: ``param_count``, ``active_param_count``,
  ``fp8_peak_applies`` and every shape's ``model_flops`` are exactly the
  JAX package's.
* ``run_cell`` on the meta device completes for one arch of each family
  and each kind it runs (``CELLS``; depth cut to one layer group: the
  record's fields do not depend on it), with the JAX record's keys; an
  encoder-only decode cell and a full-attention 500k cell are skipped with
  the JAX reasons.
* The CLI resumes from its cached cells, and the roofline report reads
  what it wrote; the Fig. 9 harness's 12B roofline row comes from it.
"""

import dataclasses
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config import SHAPES as JAX_SHAPES
from repro.config import MeshConfig as JaxMeshConfig
from repro.configs import ASSIGNED as JAX_ASSIGNED
from repro.configs import get_config as jax_get_config
from repro.fp8 import fp8_peak_applies as jax_fp8_peak_applies
from repro.launch import specs as jax_specs
from repro_torch.config import SHAPES
from repro_torch.configs import ASSIGNED, get_config
from repro_torch.fp8 import fp8_peak_applies
from repro_torch.launch import dryrun, roofline, specs

torch.set_num_threads(2)


def _jax_model_flops():
    """The JAX dry run's ``model_flops``; its module sets ``XLA_FLAGS`` for
    512 host devices when imported, so the variable is restored at once
    (before any backend reads it)."""
    old = os.environ.get("XLA_FLAGS")
    try:
        from repro.launch.dryrun import model_flops
    finally:
        if old is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = old
    return model_flops


def test_shapes_and_archs_are_the_jax_package_s():
    assert ASSIGNED == JAX_ASSIGNED
    assert {k: dataclasses.astuple(v) for k, v in SHAPES.items()} == {
        k: dataclasses.astuple(v) for k, v in JAX_SHAPES.items()}


def _spec(t):
    return tuple(t.shape), str(t.dtype).replace("torch.", "")


def _jax_spec(s):
    return tuple(s.shape), jnp.dtype(s.dtype).name


@pytest.mark.parametrize("arch", ASSIGNED)
def test_specs_status_and_knobs_match_jax(arch):
    cfg, jcfg = get_config(arch), jax_get_config(arch)
    for name, shape in SHAPES.items():
        jshape = JAX_SHAPES[name]
        for fn in ("train_input_specs", "prefill_input_specs", "decode_input_specs"):
            ours, theirs = getattr(specs, fn)(cfg, shape), getattr(jax_specs, fn)(jcfg, jshape)
            assert all(t.device.type == "meta" for t in ours.values())
            assert {k: _spec(t) for k, t in ours.items()} == {k: _jax_spec(s) for k, s in theirs.items()}, fn
        assert specs.cell_status(cfg, name) == jax_specs.cell_status(jcfg, name)
        for fp8 in (False, True):
            knobs = dataclasses.replace(specs.TRAIN_KNOBS.get(arch, specs.CellKnobs()), fp8=fp8)
            jknobs = dataclasses.replace(jax_specs.TRAIN_KNOBS.get(arch, jax_specs.CellKnobs()), fp8=fp8)
            assert dataclasses.asdict(knobs) == dataclasses.asdict(jknobs)
            for k, jk in ((None, None), (knobs, jknobs)):
                run = specs.run_config_for(arch, shape, knobs=k)
                jrun = jax_specs.run_config_for(arch, jshape, JaxMeshConfig(), jk)
                assert run.arch == jrun.arch and run.mesh.shape == jrun.mesh.shape
                assert dataclasses.asdict(run.parallel) == dataclasses.asdict(jrun.parallel)
                assert dataclasses.asdict(run.train) == dataclasses.asdict(jrun.train)
                prec = {k: v for k, v in dataclasses.asdict(run.precision).items() if k != "fp8_gemm"}
                assert prec == {k: v for k, v in dataclasses.asdict(jrun.precision).items() if k != "fp8_gemm"}
    assert specs.PREFILL_Q_CHUNK == jax_specs.PREFILL_Q_CHUNK
    assert specs.enumerate_cells([arch]) == jax_specs.enumerate_cells([arch])


@pytest.mark.parametrize("arch", ASSIGNED)
def test_counts_match_jax(arch):
    cfg, jcfg = get_config(arch), jax_get_config(arch)
    assert cfg.param_count() == jcfg.param_count()
    assert cfg.active_param_count() == jcfg.active_param_count()
    assert fp8_peak_applies(cfg) == jax_fp8_peak_applies(jcfg)
    jax_model_flops = _jax_model_flops()
    for name in SHAPES:
        assert dryrun.model_flops(cfg, SHAPES[name]) == jax_model_flops(jcfg, JAX_SHAPES[name])


RECORD_KEYS = {"arch", "shape", "mesh", "n_devices", "status", "trace_s", "fp8", "per_device_flops",
               "per_device_hbm_bytes", "collectives", "memory", "roofline", "dominant", "params", "active_params",
               "model_flops", "useful_ratio", "knobs"}
# every kind of every family but rwkv6-7b's train and prefill (its chunked WKV loop runs 64 and 512
# chunks a layer: 8 and 5 s here) and llama-3.2-vision's train step (8 microbatches of a 5-layer group:
# 7 s), which the CLI's full sweep costs
CELLS = [("olmo-1b", s) for s in ("train_4k", "prefill_32k", "decode_32k")]
CELLS += [("qwen3-moe-235b-a22b", s) for s in ("train_4k", "prefill_32k", "decode_32k")]
CELLS += [("rwkv6-7b", s) for s in ("decode_32k", "long_500k")]
CELLS += [("hymba-1.5b", s) for s in ("train_4k", "prefill_32k", "decode_32k", "long_500k")]
CELLS += [("hubert-xlarge", s) for s in ("train_4k", "prefill_32k")]
CELLS += [("llama-3.2-vision-90b", s) for s in ("prefill_32k", "decode_32k")]


def _depth_cut(arch):
    cfg = get_config(arch)
    return cfg.replace(num_layers=cfg.vision.cross_attn_every if cfg.family == "vlm" else 1)


@pytest.mark.parametrize("arch,shape", CELLS)
def test_run_cell_on_meta(arch, shape, monkeypatch):
    monkeypatch.setattr(dryrun, "get_config", _depth_cut)
    rec = dryrun.run_cell(arch, shape, verbose=False)
    cfg = _depth_cut(arch)
    assert set(rec) == RECORD_KEYS and rec["status"] == "run" and rec["n_devices"] == 1
    assert rec["per_device_flops"] > 0 and rec["per_device_hbm_bytes"] > 0 and rec["collectives"] == {}
    assert rec["roofline"]["collective_s"] == 0.0 and rec["dominant"] in ("compute_s", "memory_s")
    assert rec["params"] == cfg.param_count() and rec["model_flops"] == dryrun.model_flops(cfg, SHAPES[shape])
    assert rec["useful_ratio"] == rec["model_flops"] / rec["per_device_flops"]
    mem = rec["memory"]
    # every parameter is an argument of the step, live throughout
    assert mem["argument_bytes"] >= cfg.param_count() * (4 if SHAPES[shape].kind == "train" else 2)
    assert mem["peak_estimate_bytes"] == mem["argument_bytes"] + mem["temp_bytes"] > mem["argument_bytes"]
    assert np.isfinite(rec["useful_ratio"]) and not rec["fp8"]


def test_skipped_cells():
    assert dryrun.run_cell("hubert-xlarge", "decode_32k", verbose=False)["status"].startswith("skip: encoder-only")
    assert dryrun.run_cell("olmo-1b", "long_500k", verbose=False)["status"].startswith("skip: pure full-attention")


def test_cli_resumes_and_feeds_the_roofline(tmp_path, monkeypatch, capsys):
    monkeypatch.setattr(dryrun, "get_config", _depth_cut)
    argv = ["--arch", "olmo-1b", "--shape", "decode_32k,long_500k", "--out-dir", str(tmp_path)]
    dryrun.main(argv)
    assert "1 costed, 1 skipped" in capsys.readouterr().out
    dryrun.main(argv)
    assert capsys.readouterr().out.count(": cached") == 2
    dryrun.main(argv[:4] + ["--fp8", "--out-dir", str(tmp_path)])  # fp8 cells get rows of their own
    results = roofline.load(tmp_path)
    assert set(results) == {"olmo-1b|decode_32k", "olmo-1b|long_500k", "olmo-1b|decode_32k|fp8",
                            "olmo-1b|long_500k|fp8"}
    rows = roofline.cell_rows(results)
    ok = [r for r in rows if r["status"] == "ok"]
    assert len(ok) == 2 and all(r["fits"] is (r["peak_gb"] <= 80) for r in ok)
    roofline.main(["--out-dir", str(tmp_path), "--pick"])
    out = capsys.readouterr().out
    assert "| olmo-1b | decode_32k |" in out and "worst_fraction: olmo-1b x decode_32k" in out
    assert "VMEM" not in out and "TPU" not in out


def test_fig9_roofline_row_reads_the_dry_run(tmp_path, monkeypatch):
    from repro_torch.benchmarks import llm_inference

    monkeypatch.setattr(roofline, "RESULTS_DIR", tmp_path)
    assert llm_inference.roofline_row() is None  # no dry run yet
    terms = {"compute_s": 0.002, "memory_s": 0.5, "collective_s": 0.0}
    dryrun.save_results({"mistral-nemo-12b|decode_32k": {"status": "run", "roofline": terms, "dominant": "memory_s"}},
                        tmp_path)
    row = llm_inference.roofline_row()
    assert row["name"] == "llm_inference_12b_decode32k_roofline" and row["us_per_call"] == 0.5e6
    assert row["derived"] == "batch128 -> 256 tok/s/card, dominant=memory_s"
