"""CloverLeaf's halo exchange over ranks (Fig. 11, ``benchmarks.cloverleaf``
``make_step``) on gloo ranks on the CPU.

* Over 2 and 4 ranks (one spawn of four; ``torch_tp_ranks.cloverleaf_blocks``,
  the ranks import no JAX), each rank's block after each of three chained
  steps, the blocks in rank order, equals the one-device step on the whole
  grid (``cloverleaf.step``) and the reference's ``make_step`` sharded over
  four forced host devices (``tests/jax_cloverleaf_ranks.py``, a process of
  its own), bit for bit: every cell sums the same five terms in the same
  order.  The tolerance is exact equality.
* The control, each rank wrapping its own rows (no exchange), differs from
  the one-device step on the rows next to every block boundary, and only
  there after one step.
* ``run(ranks=2)`` on the CPU: rows named by size and ranks, the
  reference's ``halo_bytes_per_step`` (``2 * n * 4 * ranks``), every rank's
  time, and its bit-exact check and control inside.
"""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.benchmarks import cloverleaf
from repro_torch.launch.mesh import run_ranks

import torch_tp_ranks

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parents[1]
STEPS = 3
RANKS = (2, 4)


@pytest.fixture(scope="module")
def blocks(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("cloverleaf")
    grid = np.random.default_rng(0).standard_normal((48, 40)).astype(np.float32)
    np.save(tmp / "grid.npy", grid)
    env = dict(os.environ, XLA_FLAGS="--xla_force_host_platform_device_count=4", JAX_PLATFORMS="cpu",
               PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.Popen([sys.executable, str(ROOT / "tests" / "jax_cloverleaf_ranks.py"), str(tmp / "grid.npy"),
                             str(STEPS), str(tmp / "jax.npz")], env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT)
    ranks = run_ranks(torch_tp_ranks.cloverleaf_blocks, 4, device="cpu", args=(grid, STEPS, RANKS), timeout_s=120)
    out, _ = proc.communicate(timeout=120)
    assert proc.returncode == 0, out.decode()[-4000:]
    jax_steps = np.load(tmp / "jax.npz")
    one, u = [], torch.from_numpy(grid)
    for _ in range(STEPS):
        u = cloverleaf.step(u)
        one.append(u.numpy())
    return ranks, one, [jax_steps[f"step_{i}"] for i in range(STEPS)]


@pytest.mark.parametrize("n", RANKS)
def test_step_over_ranks_is_the_one_device_and_jax_step(blocks, n):
    ranks, one, jx = blocks
    for i in range(STEPS):
        got = np.concatenate([ranks[r][n]["steps"][i] for r in range(n)])
        assert np.array_equal(got, one[i]), f"{n} ranks, step {i}"
        assert np.array_equal(got, jx[i]), f"{n} ranks, step {i} against the JAX step on 4 devices"
    assert all(n not in ranks[r] for r in range(n, 4))  # the ranks past the mesh idle


@pytest.mark.parametrize("n", RANKS)
def test_control_wrapping_each_block_fails(blocks, n):
    ranks, one, _ = blocks
    got = np.concatenate([ranks[r][n]["control"][0] for r in range(n)])
    bad = np.abs(got - one[0]).max(axis=1) > 0
    rows = 48 // n
    edges = {r * rows for r in range(n)} | {r * rows + rows - 1 for r in range(n)}
    assert set(np.flatnonzero(bad)) == edges


def test_run_over_two_ranks_on_the_cpu():
    rows = cloverleaf.run(sizes=(64,), iters=2, device="cpu", ranks=2)
    assert [r["name"] for r in rows] == ["cloverleaf_64x64_2ranks"] + [
        f"cloverleaf_weakscale_{c}chips" for c in (16, 64, 160, 256)]
    r = rows[0]
    assert r["ranks"] == 2 and r["backend"] == "gloo" and r["bit_exact"] and not any(r["control_bit_exact"])
    assert r["halo_bytes_per_step"] == 2 * 64 * 4 * 2 and r["bytes"] == 2 * 64 * 64 * 4
    assert len(r["rank_us"]) == 2 and r["us_per_call"] == max(r["rank_us"]) > 0
    assert r["achieved_gbps"] is None and r["device"] == "cpu"
