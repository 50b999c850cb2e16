"""The reference's dry run (``repro.launch.dryrun.run_cell``) of a few cells
on the 256-device single-pod mesh of forced host devices, at a smoke
config widened so the heads split over the model axis, run as its own
process by ``test_torch_dryrun_reference.py`` (the dry run's module forces
512 host devices when JAX starts):

    JAX_PLATFORMS=cpu python tests/jax_dryrun_cells.py CASES.json OUT.json

``CASES.json`` holds ``widths`` (fields of the model config set on
``reduce_for_smoke``'s) and ``cells``, each ``[arch, shape, num_kv_heads]``.
The mesh is ``make_production_mesh``'s ``(data 16, model 16)`` built with
auto axes (this JAX's ``jax.make_mesh`` makes them explicit, which the
reference's sharding constraints do not take).  ``OUT.json`` gets each
cell's record (``"arch|shape"``): ``n_devices``, the per-device FLOPs and
bytes, ``collectives`` and ``memory``.
"""

import json
import sys

import numpy as np

import repro.launch.dryrun as dryrun  # noqa: I001 (first: it sets XLA_FLAGS before JAX starts)
import jax
from jax.sharding import Mesh

from repro.config import MeshConfig
from repro.config.model import reduce_for_smoke
from repro.configs import get_config


def main(cases_path: str, out_path: str) -> None:
    spec = json.loads(open(cases_path).read())
    mesh_cfg = MeshConfig()
    mesh = Mesh(np.array(jax.devices()[: mesh_cfg.num_devices]).reshape(mesh_cfg.shape), mesh_cfg.axis_names)
    out = {}
    for arch, shape, kv in spec["cells"]:
        dryrun.get_config = lambda a, kv=kv: reduce_for_smoke(get_config(a)).replace(num_kv_heads=kv, **spec["widths"])
        rec = dryrun.run_cell(arch, shape, mesh_cfg, mesh, verbose=False)
        out[f"{arch}|{shape}"] = {k: rec[k] for k in ("status", "n_devices", "per_device_flops", "per_device_hbm_bytes",
                                                        "collectives", "memory")}
    open(out_path, "w").write(json.dumps(out))


if __name__ == "__main__":
    main(sys.argv[1], sys.argv[2])
