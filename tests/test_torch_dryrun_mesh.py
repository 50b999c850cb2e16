"""The dry run over a production mesh (``launch.dryrun`` with ``mesh=``): one
rank's real sharded step traced on the meta device in a fake world of
``n_devices`` ranks, on the CPU.

* Its collectives are the step's: smoke olmo-1b on a ``(2, 2)`` mesh (fp32
  with remat; fp8 with sequence parallelism and two microbatches), the
  calls and operand bytes the meta trace counts
  (``parallel.collectives``' ``TRAIN_COLLECTIVES`` and ``COLLECTIVES``)
  equal, exactly, those of one real step on four gloo ranks from the same
  state layout (``torch_sharded_ranks.step_collectives``, one spawn), and
  every c10d op the trace dispatched is one counted call.
* A cell on the 256-device mesh: ``per_device_flops`` x 256 is the
  one-card trace's FLOPs exactly (the reference's definition: the global
  step over the devices), and the rank's peak lies below the one card's.
* Full-width olmo-1b and qwen3-moe cells (depth cut to one layer for
  train, two for decode: the per-layer fields repeat) cost on both meshes with the
  reference's ``n_devices`` (256, 512) and axis sizes, non-zero
  collectives and ``collective_s``; qwen3-moe's train cell routes groups
  that span the data ranks (``exchange_counts`` on meta).
* ``multi`` runs ``("pod", "data")`` as one data axis of 32: under the
  training table every parameter's spec on the 3-axis multi-pod mesh is
  its spec on a ``(data 32, model 16)`` mesh with the pair named
  ``"data"``.
* ``--mesh both`` writes one results file a mesh, which the roofline
  reads with ``--mesh``.

Counts and bytes are integers and compared exactly; FLOPs x 256 exactly
(a power of two).
"""

import pytest
import torch

from repro_torch.config import (
    SHAPES,
    MeshConfig,
    ParallelConfig,
    PrecisionConfig,
    RunConfig,
    ShapeConfig,
    TrainConfig,
    reduce_for_smoke,
)
from repro_torch.configs import get_config
from repro_torch.launch import dryrun, roofline
from repro_torch.launch.mesh import make_production_mesh, run_ranks
from repro_torch.parallel.sharding import make_rules, training_rules
from repro_torch.utils.tree import tree_map

import torch_sharded_ranks

torch.set_num_threads(2)

B, S = 8, 16
SMOKE_RUNS = {
    "fp32": dict(precision=PrecisionConfig(compute_dtype="float32"), parallel=ParallelConfig(remat="full")),
    "fp8-sp-mb2": dict(precision=PrecisionConfig(fp8=True),
                       parallel=ParallelConfig(remat="full", sequence_parallel=True, num_microbatches=2)),
}


def _run(name) -> RunConfig:
    return RunConfig(arch="olmo-1b", train=TrainConfig(global_batch=B, seq_len=S), **SMOKE_RUNS[name])


# the kv_seq case: one kv head over a model axis of 2, so the dense ring splits its slots (and the
# 4 query heads split over the axis: the "grouped" layout)
SPLIT_CFG = reduce_for_smoke(get_config("olmo-1b")).replace(num_kv_heads=1)
DECODE = dict(cfg=SPLIT_CFG, B=2, seq_len=16, steps=12)  # 12 steps: rank 1's slots are empty for the first 8


@pytest.fixture(scope="module")
def world():
    """One spawn of four gloo ranks at (2, 2): the train cases' collectives
    and the split ring's decode (``torch_sharded_ranks.mesh_checks``)."""
    cfg = reduce_for_smoke(get_config("olmo-1b"))
    g = torch.Generator().manual_seed(0)
    tok = torch.randint(0, cfg.vocab_size, (B, S), generator=g, dtype=torch.int32)
    batch = {"tokens": tok, "labels": torch.roll(tok, -1, dims=1)}
    cases = [{"cfg": cfg, "run": _run(name), "batch": batch} for name in SMOKE_RUNS]
    return cfg, run_ranks(torch_sharded_ranks.mesh_checks, (2, 2), device="cpu", args=(cases, DECODE), timeout_s=300)


@pytest.fixture(scope="module")
def real_steps(world):
    cfg, ranks = world
    return cfg, dict(zip(SMOKE_RUNS, ranks[0]["steps"]))


@pytest.mark.parametrize("name", list(SMOKE_RUNS))
def test_meta_collectives_equal_a_real_step(real_steps, name):
    cfg, real = real_steps
    rec = dryrun.cost_rank(cfg, _run(name), ShapeConfig("smoke", S, B, "train"), 2, 2)
    colls = rec["collectives"]
    assert colls["count"] == {k: v for k, v in real[name].items() if not k.endswith("_bytes")}
    assert colls["operand_bytes"] == {k[: -len("_bytes")]: v for k, v in real[name].items() if k.endswith("_bytes")}
    assert sum(colls["ops"].values()) == sum(colls["count"].values()) > 0
    assert rec["executed_mesh"] == {"data": 2, "model": 2}


def test_split_ring_decodes_as_the_whole_ring(world):
    """The reference's ``kv_seq`` rule, executed: with one kv head over a
    model axis of 2 each rank's ring holds half the slots, the new K/V
    lands on the rank that holds its slot, and the two partial softmaxes
    combine to the whole ring's logits (fp32, relative to the largest
    logit, within 1e-5: the same sums in another order) at every step,
    the first eight with rank 1's slots all empty.  Its 4 query heads
    split over the ranks (the ``"grouped"`` layout), so each layer's
    split decode gathers the queries before its parts.  One split step's
    collectives equal the meta trace's exactly, and ``prefill``'s split
    cache is the rank's share of the whole one."""
    _, ranks = world
    for r in ranks:
        d = r["decode"]
        assert d["shards"] == 2 and d["prefill_equal"]
        for whole, split in zip(d["logits"][False], d["logits"][True]):
            assert abs(split - whole).max() <= 1e-5 * abs(whole).max()
    rec = dryrun.cost_rank(SPLIT_CFG, _run("fp32"), ShapeConfig("smoke", DECODE["seq_len"], 2 * DECODE["B"], "decode"),
                           2, 2)
    real = ranks[0]["decode"]["collectives"]
    colls = rec["collectives"]
    assert colls["count"] == {k: v for k, v in real.items() if not k.endswith("_bytes")}
    assert colls["operand_bytes"] == {k[: -len("_bytes")]: v for k, v in real.items() if k.endswith("_bytes")}
    # a layer's queries and parts (its 4 query heads split over the 2 ranks: the "grouped" layout), the logits
    assert colls["count"]["all_gather"] == 2 * SPLIT_CFG.num_layers + 1


def _cut(arch, layers=2):
    cfg = get_config(arch)
    return cfg.replace(num_layers=layers)


def test_per_device_flops_and_the_rank_peak(monkeypatch):
    monkeypatch.setattr(dryrun, "get_config", _cut)
    one = dryrun.run_cell("olmo-1b", "train_4k", verbose=False)
    rank = dryrun.run_cell("olmo-1b", "train_4k", verbose=False, mesh="single")
    assert rank["n_devices"] == 256 and one["n_devices"] == 1
    assert rank["per_device_flops"] * 256 == one["per_device_flops"]
    assert rank["per_device_hbm_bytes"] * 256 == one["per_device_hbm_bytes"]
    assert rank["model_flops"] == one["model_flops"] and rank["useful_ratio"] == one["useful_ratio"]
    assert rank["memory"]["peak_estimate_bytes"] < one["memory"]["peak_estimate_bytes"]
    assert one["collectives"] == {} and one["roofline"]["collective_s"] == 0.0


CELLS = [("olmo-1b", "train_4k", "multi"), ("olmo-1b", "decode_32k", "single"),
         ("qwen3-moe-235b-a22b", "train_4k", "multi"), ("qwen3-moe-235b-a22b", "decode_32k", "single")]


@pytest.mark.parametrize("arch,shape,mesh", CELLS)
def test_full_width_cells_on_both_meshes(arch, shape, mesh, monkeypatch):
    monkeypatch.setattr(dryrun, "get_config", lambda a: _cut(a, 1 if SHAPES[shape].kind == "train" else 2))
    rec = dryrun.run_cell(arch, shape, verbose=False, mesh=mesh)
    mesh_cfg = MeshConfig(multi_pod=mesh == "multi")
    assert rec["status"] == "run" and rec["mesh"] == mesh and rec["n_devices"] == mesh_cfg.num_devices
    assert rec["mesh_shape"] == dict(zip(mesh_cfg.axis_names, mesh_cfg.shape))
    assert rec["executed_mesh"] == {"data": mesh_cfg.num_devices // 16, "model": 16}
    colls = rec["collectives"]
    assert colls["total_operand_bytes"] > 0 and rec["roofline"]["collective_s"] > 0
    assert rec["roofline"]["collective_s"] == colls["total_operand_bytes"] / roofline.NVLINK_BW
    assert sum(colls["ops"].values()) == sum(colls["count"].values())
    mem = rec["memory"]
    assert mem["peak_estimate_bytes"] == mem["argument_bytes"] + mem["temp_bytes"] > mem["argument_bytes"] > 0
    if arch.startswith("qwen3") and shape == "train_4k":
        assert colls["count"]["exchange_counts"] > 0  # routed groups span the data ranks


def test_multi_pod_runs_pod_and_data_as_one_axis():
    for arch in ("olmo-1b", "qwen3-moe-235b-a22b", "hymba-1.5b"):
        cfg = get_config(arch)
        for par in (ParallelConfig(), ParallelConfig(fsdp=False)):
            multi = make_rules(MeshConfig(multi_pod=True), par).param_shardings(cfg, make_production_mesh(multi_pod=True))
            merged = training_rules(par).param_shardings(cfg, type("Stub", (), {"shape": {"data": 32, "model": 16}})())
            rename = lambda spec: tuple("data" if e == ("pod", "data") else e for e in spec)  # noqa: E731
            assert tree_map(rename, multi) == merged, arch


def test_cli_writes_a_file_a_mesh(tmp_path, monkeypatch, capsys):
    monkeypatch.setattr(dryrun, "get_config", _cut)
    dryrun.main(["--mesh", "both", "--arch", "olmo-1b", "--shape", "decode_32k,long_500k", "--out-dir", str(tmp_path)])
    out = capsys.readouterr().out
    assert "[single] 1 costed, 1 skipped" in out and "[multi] 1 costed, 1 skipped" in out
    assert sorted(p.name for p in tmp_path.iterdir()) == ["dryrun_multi.json", "dryrun_single.json"]
    for mesh, n in (("single", 256), ("multi", 512)):
        rec = roofline.load(tmp_path, mesh)["olmo-1b|decode_32k"]
        assert rec["n_devices"] == n and rec["collectives"]["total_operand_bytes"] > 0
        roofline.main(["--mesh", mesh, "--out-dir", str(tmp_path)])
        assert "| olmo-1b | decode_32k |" in capsys.readouterr().out
    assert roofline.load(tmp_path) == {}  # the one-card file is another
