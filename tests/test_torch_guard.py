"""Boundaries of the PyTorch port: no JAX, no ``repro``, the card by default.

* No file of ``src/repro_torch/`` and not ``chip_smoke.py`` imports ``jax``
  or ``repro`` (checked on each file's syntax tree).
* ``repro_torch`` and every submodule import with ``jax`` and ``repro``
  made unimportable.
* Entry points called without ``device="cpu"`` raise on a host without
  CUDA instead of falling back to the CPU.
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

    cfg = reduce_for_smoke(get_config("olmo-1b"))
    with pytest.raises(RuntimeError, match="CUDA"):
        init_params(cfg, 0)
    with pytest.raises(RuntimeError, match="CUDA"):
        init_paged_cache(cfg, 5, 16, 2, 2, torch.bfloat16)
    params = init_params(cfg, 0, device="cpu")
    with pytest.raises(RuntimeError, match="CUDA"):
        InferenceEngine(cfg, params)
    with pytest.raises(RuntimeError, match="CUDA"):
        params_from_jax(cfg, {"embed": {}, "blocks": {}, "final_norm": {}})
    InferenceEngine(cfg, params, device="cpu")  # asked for by name: fine


@pytest.mark.parametrize(
    "option,value",
    [("spec_decode", "ngram"), ("fused", True), ("spill_bytes", 1 << 20), ("quantize_kv", "int8"),
     ("mesh", object()), ("cache_kind", "dense")],
)
def test_options_outside_the_slice_raise(option, value):
    from repro_torch.config import reduce_for_smoke
    from repro_torch.configs import get_config
    from repro_torch.models import init_params
    from repro_torch.serving import InferenceEngine

    cfg = reduce_for_smoke(get_config("olmo-1b"))
    params = init_params(cfg, 0, device="cpu")
    with pytest.raises(NotImplementedError, match=option):
        InferenceEngine(cfg, params, device="cpu", **{option: value})
