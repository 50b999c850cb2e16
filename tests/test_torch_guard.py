"""Boundaries of the PyTorch port: no JAX, no ``repro``, the card by default.

* No file of ``src/repro_torch/`` and not ``chip_smoke.py`` imports ``jax``
  or ``repro`` (checked on each file's syntax tree).
* ``repro_torch`` and every submodule import with ``jax`` and ``repro``
  made unimportable.
* Entry points called without ``device="cpu"`` raise on a host without
  CUDA instead of falling back to the CPU, and kernel wrappers never hand a
  tensor that is not on the CPU to their plain versions.
"""

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
FORBIDDEN = ("jax", "jaxlib", "repro")


def _port_files() -> list[Path]:
    return sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _imported_modules(path: Path) -> list[str]:
    mods = []
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            mods += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            mods.append(node.module)
    return mods


def test_port_files_import_neither_jax_nor_repro():
    files = _port_files()
    assert len(files) > 20
    assert PORT / "models" / "ssm.py" in files
    for tool in ("kernels/autotune.py", "launch/specs.py", "launch/cost.py", "launch/roofline.py",
                 "launch/dryrun.py",  # the tools are held to the same rule, and so is tensor parallelism
                 "parallel/__init__.py", "parallel/sharding.py", "parallel/collectives.py", "launch/mesh.py"):
        assert PORT / tool in files, tool
    bad = [
        (str(f.relative_to(ROOT)), m)
        for f in files
        for m in _imported_modules(f)
        if m.split(".")[0] in FORBIDDEN
    ]
    assert not bad, bad


def test_port_imports_without_jax():
    code = (
        "import sys, importlib, pkgutil\n"
        "for name in ('jax', 'jaxlib', 'repro'):\n"
        "    sys.modules[name] = None  # any import of them now fails\n"
        "import repro_torch\n"
        "for m in pkgutil.walk_packages(repro_torch.__path__, 'repro_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "assert not any(k.split('.')[0] in ('jax', 'jaxlib') and sys.modules[k] is not None for k in sys.modules)\n"
        "print('ok')\n"
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, env=env, cwd=ROOT, timeout=120)
    assert proc.returncode == 0 and proc.stdout.strip() == "ok", proc.stderr


def test_entry_points_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is valid here")
    from repro_torch.bridge import params_from_jax
    from repro_torch.config import reduce_for_smoke
    from repro_torch.configs import get_config
    from repro_torch.models import init_paged_cache, init_params
    from repro_torch.serving import InferenceEngine
    from repro_torch.serving.kvcache import make_engine_cache

    cfg = reduce_for_smoke(get_config("olmo-1b"))
    with pytest.raises(RuntimeError, match="CUDA"):
        init_params(cfg, 0)
    with pytest.raises(RuntimeError, match="CUDA"):
        init_params(reduce_for_smoke(get_config("qwen3-moe-235b-a22b")), 0)
    for arch in ("hymba-1.5b", "rwkv6-7b"):  # the recurrent families' entry points
        rcfg = reduce_for_smoke(get_config(arch))
        with pytest.raises(RuntimeError, match="CUDA"):
            init_params(rcfg, 0)
        with pytest.raises(RuntimeError, match="CUDA"):
            InferenceEngine(rcfg, init_params(rcfg, 0, device="cpu"))
        with pytest.raises(RuntimeError, match="CUDA"):
            make_engine_cache(rcfg, 2, 16)
    with pytest.raises(RuntimeError, match="CUDA"):
        init_paged_cache(cfg, 5, 16, 2, 2, torch.bfloat16)
    params = init_params(cfg, 0, device="cpu")
    with pytest.raises(RuntimeError, match="CUDA"):
        InferenceEngine(cfg, params)
    with pytest.raises(RuntimeError, match="CUDA"):
        InferenceEngine(cfg, params, cache_kind="dense")
    with pytest.raises(RuntimeError, match="CUDA"):
        make_engine_cache(cfg, 2, 16)
    with pytest.raises(RuntimeError, match="CUDA"):
        params_from_jax(cfg, {"embed": {}, "blocks": {}, "final_norm": {}})
    from repro_torch.benchmarks.llm_inference import run_router
    from repro_torch.launch.serve import main as serve_main

    with pytest.raises(RuntimeError, match="CUDA"):
        serve_main(["--arch", "olmo-1b", "--requests", "1"])
    from repro_torch.launch.mesh import make_replica_meshes, make_serving_mesh, run_ranks

    # the ranks' device: the card unless the CPU is asked for, checked before any rank starts
    with pytest.raises(RuntimeError, match="CUDA"):
        serve_main(["--arch", "olmo-1b", "--requests", "1", "--tp", "2"])
    with pytest.raises(RuntimeError, match="CUDA"):
        run_ranks(print, 2)
    with pytest.raises(RuntimeError, match="CUDA"):
        make_serving_mesh(2, backend="gloo")
    with pytest.raises(RuntimeError, match="CUDA"):
        make_replica_meshes(2, 1)
    with pytest.raises(RuntimeError, match="CUDA"):
        run_router(cfg, params)
    InferenceEngine(cfg, params, device="cpu")  # asked for by name: fine


def test_training_entry_points_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is valid here")
    from repro_torch.config import RunConfig, reduce_for_smoke
    from repro_torch.configs import get_config
    from repro_torch.data import make_batch_fn, synthetic_batch
    from repro_torch.fp8 import init_fp8_state, make_fp8_state
    from repro_torch.launch.train import main
    from repro_torch.train import init_train_state

    cfg = reduce_for_smoke(get_config("olmo-1b"))
    run = RunConfig(arch="olmo-1b")
    with pytest.raises(RuntimeError, match="CUDA"):
        init_train_state(cfg, run)
    with pytest.raises(RuntimeError, match="CUDA"):
        main(["--steps", "1"])
    with pytest.raises(RuntimeError, match="CUDA"):
        main(["--steps", "2", "--ckpt-every", "1", "--fail-at", "1"])
    from repro_torch.benchmarks import mlperf_train
    from repro_torch.data import ShardedLoader

    with pytest.raises(RuntimeError, match="CUDA"):
        mlperf_train.run()
    with pytest.raises(RuntimeError, match="CUDA"):
        ShardedLoader(lambda step: {"tokens": torch.zeros((2, 8), dtype=torch.int32)})
    ShardedLoader(make_batch_fn(cfg, global_batch=2, seq_len=8, device="cpu"), device="cpu").get(0)
    with pytest.raises(RuntimeError, match="CUDA"):
        synthetic_batch(cfg, step=0, global_batch=2, seq_len=8)
    with pytest.raises(RuntimeError, match="CUDA"):
        make_batch_fn(cfg, global_batch=2, seq_len=8)
    with pytest.raises(RuntimeError, match="CUDA"):
        make_fp8_state(cfg, run.precision)
    with pytest.raises(RuntimeError, match="CUDA"):
        init_fp8_state(["s/x"], window=2)
    init_train_state(cfg, run, device="cpu")  # asked for by name: fine
    make_fp8_state(cfg, run.precision, device="cpu")


def test_kernel_wrappers_never_fall_back():
    """Off the CPU a wrapper launches its kernel or raises: a tensor on a
    device that is neither the CPU nor a card is refused, not handed to the
    plain version."""
    from repro_torch.fp8 import E4M3, fp8_gemm
    from repro_torch.kernels.flash_attention import flash_attention, flash_attention_bhsd

    a = torch.empty((8, 16), dtype=E4M3, device="meta")
    s = torch.empty((), device="meta")
    with pytest.raises(ValueError, match="cuda or cpu"):
        fp8_gemm(a, a.T, s, s)
    q = torch.empty((1, 2, 16, 16), device="meta")
    with pytest.raises(ValueError, match="cuda or cpu"):
        flash_attention_bhsd(q, q, q)
    with pytest.raises(ValueError, match="cuda or cpu"):
        flash_attention(q, q, q)
    # the paged kernels too: the dry run reaches the plain versions on meta by name, never through a wrapper
    from repro_torch.kernels.paged_attention import paged_attention, paged_prefill_attention

    kp = torch.empty((3, 16, 2, 16), device="meta")
    tbl = torch.zeros((1, 2), dtype=torch.int32, device="meta")
    lens = torch.ones((1,), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="cuda or cpu"):
        paged_attention(torch.empty((1, 4, 16), device="meta"), kp, kp, tbl, lens)
    with pytest.raises(ValueError, match="cuda or cpu"):
        paged_prefill_attention(torch.empty((1, 3, 4, 16), device="meta"), kp, kp, tbl, lens)


def test_tools_need_no_card_but_the_tuner_does():
    """The dry run and the roofline run on the meta device with no card;
    the autotuner times on the card only and refuses any other device."""
    from repro_torch.kernels.autotune import tune_case
    from repro_torch.launch.dryrun import run_cell

    assert run_cell("olmo-1b", "long_500k", verbose=False)["status"].startswith("skip")
    with pytest.raises(ValueError, match="on the card"):
        tune_case(4, 16, 32, 16, 16, 128, device="cpu")


@pytest.mark.parametrize(
    "option,value,error",
    [("spec_decode", "bogus", ValueError), ("spec_k", 0, ValueError), ("spill_dtype", "fp4", ValueError),
     ("restore_budget", 0, ValueError),
     # the mesh is ported: an object that is no ("data", "model") serving
     # mesh raises the JAX engine's ValueError (the case keeps its name)
     pytest.param("mesh", object(), ValueError, id="mesh-value4-NotImplementedError"),
     ("cache_kind", "bogus", ValueError)],
)
def test_options_outside_the_slice_raise(option, value, error):
    """Invalid speculative, spill-tier, cache-layout and mesh settings raise
    the JAX engine's own ``ValueError``, naming the option."""
    from repro_torch.config import reduce_for_smoke
    from repro_torch.configs import get_config
    from repro_torch.models import init_params
    from repro_torch.serving import InferenceEngine

    cfg = reduce_for_smoke(get_config("olmo-1b"))
    params = init_params(cfg, 0, device="cpu")
    extra = {"spec_decode": "ngram"} if option == "spec_k" else {}
    with pytest.raises(error, match=option):
        InferenceEngine(cfg, params, device="cpu", **{option: value}, **extra)


def test_engine_refuses_the_families_it_does_not_serve():
    """The engine serves the dense, moe, hybrid, ssm and vlm families, as the
    JAX engine does; an encoder-only config (bert-large) raises the JAX
    engine's ``ValueError``, and a family the port does not know raises
    ``NotImplementedError`` naming it, as the model's serving steps do."""
    from repro_torch.config import reduce_for_smoke
    from repro_torch.configs import get_config
    from repro_torch.models import decode_step, init_params
    from repro_torch.serving import InferenceEngine

    base = reduce_for_smoke(get_config("olmo-1b"))
    params = init_params(base, 0, device="cpu")
    encoder = reduce_for_smoke(get_config("bert-large"))
    with pytest.raises(ValueError, match="encoder-only"):
        InferenceEngine(encoder, init_params(encoder, 0, device="cpu"), device="cpu")
    cfg = base.replace(name="unknown-smoke", family="unknown")
    with pytest.raises(NotImplementedError, match=cfg.family):
        InferenceEngine(cfg, params, device="cpu")
    with pytest.raises(NotImplementedError, match=cfg.family):
        decode_step(cfg, params, {}, torch.zeros((1, 1), dtype=torch.int32), torch.zeros(1, dtype=torch.int32))
