"""The reference's CloverLeaf step (``benchmarks/cloverleaf.py`` ``make_step``)
on a mesh of four forced host devices, run as its own process by
``test_torch_cloverleaf_ranks.py`` (the device count is fixed when JAX
starts):

    XLA_FLAGS=--xla_force_host_platform_device_count=4 JAX_PLATFORMS=cpu \\
        python tests/jax_cloverleaf_ranks.py GRID.npy STEPS OUT.npz

It shards the grid's rows over the mesh axis ``"x"`` of the four devices
and writes the whole grid after each of ``STEPS`` chained steps
(``step_i``).
"""

import importlib.util
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh

ROOT = Path(__file__).resolve().parents[1]


def main(grid_path: str, steps: int, out_path: str) -> None:
    spec = importlib.util.spec_from_file_location("reference_cloverleaf", ROOT / "benchmarks" / "cloverleaf.py")
    ref = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(ref)
    mesh = Mesh(np.array(jax.devices()[:4]), ("x",))
    step = jax.jit(ref.make_step(mesh))
    u = jnp.asarray(np.load(grid_path))
    out = {}
    for i in range(steps):
        u = step(u)
        out[f"step_{i}"] = np.asarray(u)
    np.savez(out_path, **out)


if __name__ == "__main__":
    main(sys.argv[1], int(sys.argv[2]), sys.argv[3])
