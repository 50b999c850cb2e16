"""The port's last figure scripts on the CPU: Fig. 11 (CloverLeaf), the §1
FP8 GEMM sweep, the §IV.F paged-attention sweep and the harness over all
six figures.

* The CloverLeaf step against the reference's ``make_step`` on a
  one-device JAX mesh, on the same random grid: bit for bit, over several
  chained steps.  On one device the reference's halo rows wrap around (its
  ``ppermute`` pairs are (0 -> 0)); a step that edge-pads the rows, as it
  pads the columns, must differ from it on the first and last rows (and
  only there).  The float64 check of ``run`` rejects that step too.
* Each port figure's ``run()`` on the CPU: every row named as the
  reference names it, K4 and K1 rows held against their plain versions
  with their controls.
* ``benchmarks.run``: every figure's rows in CSV, and a figure that fails
  makes it exit non-zero after the others ran.
"""

import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from repro_torch.benchmarks import cloverleaf, fp8_gemm, paged_attention
from repro_torch.benchmarks import run as harness

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parents[1]


def _reference_cloverleaf():
    spec = importlib.util.spec_from_file_location("reference_cloverleaf", ROOT / "benchmarks" / "cloverleaf.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _edge_rows_step(u):
    """The wrong halo: rows edge-padded like the columns."""
    rows = torch.cat([u[:1], u, u[-1:]], dim=0)
    return cloverleaf.stencil(torch.cat([rows[:, :1], rows, rows[:, -1:]], dim=1))


def test_cloverleaf_step_matches_the_reference_bit_for_bit():
    ref = _reference_cloverleaf()
    mesh = Mesh(np.array(jax.devices()[:1]), ("x",))
    jstep = jax.jit(ref.make_step(mesh))
    u = np.random.default_rng(0).standard_normal((48, 40)).astype(np.float32)
    ju, tu = jnp.asarray(u), torch.from_numpy(u)
    for _ in range(3):
        ju, tu = jstep(ju), cloverleaf.step(tu)
        assert np.array_equal(tu.numpy(), np.asarray(ju))
    ju1 = np.asarray(jstep(jnp.asarray(u)))
    wrong = _edge_rows_step(torch.from_numpy(u)).numpy()
    bad = np.abs(wrong - ju1).max(axis=1) > 1e-3
    assert bad[0] and bad[-1] and not bad[1:-1].any()  # the halo rows, and only they
    assert cloverleaf.check_step(torch.from_numpy(u), torch.from_numpy(wrong)) > cloverleaf.CHECK_RTOL
    assert cloverleaf.check_step(torch.from_numpy(u), cloverleaf.step(torch.from_numpy(u))) <= cloverleaf.CHECK_RTOL


def test_cloverleaf_run_on_cpu():
    rows = cloverleaf.run(sizes=(64, 128), iters=2, device="cpu")
    names = [r["name"] for r in rows]
    assert names == ["cloverleaf_64x64", "cloverleaf_128x128"] + [
        f"cloverleaf_weakscale_{c}chips" for c in (16, 64, 160, 256)]
    r = rows[1]
    assert r["bytes"] == 2 * 128 * 128 * 4 and r["bound_us"] == pytest.approx(r["bytes"] / 3.35e12 * 1e6)
    assert r["achieved_gbps"] is None and r["device"] == "cpu"  # no device rate from the host
    assert r["max_rel_err_vs_float64"] <= cloverleaf.CHECK_RTOL and r["us_per_call"] > 0


def test_fp8_gemm_run_on_cpu():
    rows = fp8_gemm.run(sizes=(64, 96), iters=2, device="cpu")
    assert [r["name"] for r in rows] == [f"fp8_gemm_{k}_{n}" for n in (64, 96) for k in ("bf16", "plain", "kernel")]
    for r in rows:
        peak = fp8_gemm.BF16_FLOPS_PER_S if "bf16" in r["name"] else fp8_gemm.FP8_FLOPS_PER_S
        assert r["bound_us"] == pytest.approx(r["flops"] / peak * 1e6) and r["tflop_s"] is None
    kernel = [r for r in rows if "kernel" in r["name"]]
    assert all(r["max_abs_err"] <= r["tol"] < r["control_err"] for r in kernel)


def test_fp8_gemm_check_rejects_a_wrong_gemm(monkeypatch):
    """The check the kernel rows pass is the one a GEMM that drops a k-tile
    fails."""
    def wrong(a, b, sa, sb):
        return fp8_gemm.fp8_gemm_plain(a[:, :-16], b[:-16], sa, sb)

    monkeypatch.setattr(fp8_gemm, "fp8_gemm", wrong)
    with pytest.raises(AssertionError, match="K4 against the plain GEMM"):
        fp8_gemm.run(sizes=(64,), iters=1, device="cpu")


def test_paged_attention_run_on_cpu():
    rows = paged_attention.run(iters=2, device="cpu")
    assert len(rows) == 2 * len(paged_attention.CASES)
    for (B, nb, bs, H, KV, hd), plain, kernel in zip(paged_attention.CASES, rows[::2], rows[1::2]):
        name = f"paged_attn_b{B}_ctx{nb * bs}_kv{KV}x{hd}"
        assert plain["name"] == f"{name}_plain" and kernel["name"] == f"{name}_kernel"
        assert kernel["kv_bytes"] == 2 * B * nb * bs * KV * hd * 4
        assert kernel["max_abs_err"] <= paged_attention.TOL < kernel["control_err"]


def test_harness_prints_every_figure_and_fails_on_one(capsys):
    device = torch.device("cpu")
    figures = {"cloverleaf": lambda device: cloverleaf.run(sizes=(32,), iters=1, device=device),
               "fp8_gemm": lambda device: fp8_gemm.run(sizes=(32,), iters=1, device=device)}
    assert harness.run_figures(figures, device) == 0
    out = capsys.readouterr().out.splitlines()
    assert out[0] == "name,us_per_call,derived" and len(out) == 1 + 5 + 3

    def broken(device):
        raise RuntimeError("figure failed")

    assert harness.run_figures({"broken": broken, **figures}, device) == 1
    assert len(capsys.readouterr().out.splitlines()) == 1 + 5 + 3  # the others still ran
    assert set(harness.FIGURES) == {"mlperf_train", "llm_inference", "babelstream", "cloverleaf", "fp8_gemm",
                                    "paged_attention"}


def test_harness_exits_non_zero_when_a_figure_fails(monkeypatch):
    monkeypatch.setattr(harness, "FIGURES", {"broken": lambda device: 1 / 0})
    assert harness.main(["--device", "cpu"]) == 1
    monkeypatch.setattr(harness, "FIGURES", {"paged_attention": lambda device: paged_attention.run(iters=1,
                                                                                                  device=device)})
    assert harness.main(["--device", "cpu"]) == 0


def test_figures_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is valid here")
    for fn in (cloverleaf.run, fp8_gemm.run, paged_attention.run):
        with pytest.raises(RuntimeError, match="CUDA"):
            fn()
    with pytest.raises(RuntimeError, match="CUDA"):
        harness.main([])
