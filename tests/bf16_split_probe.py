"""How the tensor-parallel split of rwkv6-7b's channel mix moves its
gradient norm in bf16, in the port and in the JAX package.

The ``(1, 2)`` split rounds each rank's part of the channel mix's ``w_v``
product to the compute dtype before ``sum_over_model`` adds the parts.
Two probes of the step-1 gradient norm at the seed's weights:

* ``port_rows`` (torch only, on the card at full width, 4 of 32 layers,
  4 x 2048; ``--smoke`` on the CPU): the port's gradient (``train.step.grads_of``)
  in fp32 and in bf16, each unsplit and with the channel mix's product
  summed from two halves of the hidden dim (``split_channel_mix``), and in
  bf16 from the even and odd halves, a rounding of the same size at
  other places.  The fp32 rows must agree: the split computes the same
  function.  ``tests/test_torch_sharded_ssm.py`` holds the smoke rows to
  that and to ``LOOSE_GRAD_NORM``::

      PYTHONPATH=src python tests/bf16_split_probe.py [--device cpu --smoke]

* ``jax_rows`` (``--jax``, the CPU): the JAX package's own sharded step
  of the smoke model on (1, 2), (2, 1), (2, 2) and (1, 4) meshes of
  forced host devices (GSPMD splits the same products) against its
  unsharded step, fp32 and bf16, on four batches::

      PYTHONPATH=src JAX_PLATFORMS=cpu python tests/bf16_split_probe.py --jax

One JSON line a row.
"""

from __future__ import annotations

import argparse
import json
import os
from contextlib import contextmanager

import torch
import torch.nn.functional as F

ARCH = "rwkv6-7b"
LAYERS, BATCH, SEQ = 4, 4, 2048  # the card's shape: chip_smoke.py's sharded rwkv6-7b arm
SMOKE_BATCH, SMOKE_SEQ = 4, 32
JAX_MESHES = ((1, 2), (2, 1), (2, 2), (1, 4))


def split_channel_mix(halves):
    """``models.rwkv.channel_mix`` with its product summed from the parts of
    the hidden dim that ``halves`` picks (two index tensors), each rounded
    to x's dtype first: what a ``(1, 2)`` mesh computes, in one process."""
    from repro_torch.models.rwkv import token_shift

    def mix(cfg, p, x, *, prev_x=None, mesh=None, sp=False):  # one process: no mesh, no sequence split
        dt = x.dtype
        sx = token_shift(x, prev_x) - x
        xk = x + sx * p["maa_k"].to(dt)
        xr = x + sx * p["maa_r"].to(dt)
        parts = [torch.square(F.relu(xk @ p["w_k"][:, h].to(dt))) @ p["w_v"][h].to(dt) for h in halves]
        return torch.sigmoid(xr @ p["w_r"].to(dt)) * (parts[0] + parts[1]), x[:, -1]

    return mix


@contextmanager
def channel_mix_as(mix):
    """``models.rwkv.channel_mix`` replaced by ``mix`` (None: kept) while
    the block runs."""
    from repro_torch.models import rwkv

    kept = rwkv.channel_mix
    rwkv.channel_mix = mix or kept
    try:
        yield
    finally:
        rwkv.channel_mix = kept


def port_rows(device="cuda", smoke=False, top=6) -> list[dict]:
    """One row a run: ``run`` (fp32, fp32_split, bf16, bf16_split,
    bf16_split_interleaved), the gradient norm and the ``top`` largest
    leaves' norms."""
    from repro_torch.config import ParallelConfig, PrecisionConfig, RunConfig, TrainConfig, reduce_for_smoke
    from repro_torch.configs import get_config
    from repro_torch.data import make_batch_fn
    from repro_torch.device import resolve_device
    from repro_torch.train import init_train_state
    from repro_torch.train.step import grads_of
    from repro_torch.utils.tree import tree_leaves, tree_paths

    device = resolve_device(device)
    cfg = get_config(ARCH)
    cfg, (B, S) = (reduce_for_smoke(cfg), (SMOKE_BATCH, SMOKE_SEQ)) if smoke else (cfg.replace(num_layers=LAYERS),
                                                                                  (BATCH, SEQ))
    data = make_batch_fn(cfg, global_batch=B, seq_len=S, seed=0, device=device)(0)
    idx = torch.arange(cfg.d_ff, device=device)
    halves = split_channel_mix((idx[: cfg.d_ff // 2], idx[cfg.d_ff // 2 :]))
    interleaved = split_channel_mix((idx[0::2], idx[1::2]))
    state, rows = None, []
    for name, dtype, mix in (("fp32", "float32", None), ("fp32_split", "float32", halves), ("bf16", "bfloat16", None),
                             ("bf16_split", "bfloat16", halves), ("bf16_split_interleaved", "bfloat16", interleaved)):
        run = RunConfig(arch=cfg.name, train=TrainConfig(warmup_steps=0), parallel=ParallelConfig(remat="full"),
                        precision=PrecisionConfig(compute_dtype=dtype))
        state = state or init_train_state(cfg, run, 0, device)
        with channel_mix_as(mix):
            grads = grads_of(cfg, run, state, data)[0]
        norms = {"/".join(map(str, p)): float(t.float().norm()) for p, t in zip(tree_paths(grads), tree_leaves(grads))}
        rows.append({"run": name, "grad_norm": sum(v * v for v in norms.values()) ** 0.5,
                     "largest_leaves": sorted(norms.items(), key=lambda kv: -kv[1])[:top]})
        del grads
    return rows


def jax_rows(seeds=4) -> list[dict]:
    """One row a dtype and batch: the JAX package's step-1 gradient norm
    unsharded (``"1x1"``) and on each of ``JAX_MESHES``, from
    ``PRNGKey(0)``'s smoke state, batches of 8 x 16 (``torch_parity.batches``)."""
    os.environ.setdefault("XLA_FLAGS", "--xla_force_host_platform_device_count=4")
    import jax
    import jax.numpy as jnp
    import numpy as np
    from jax.sharding import Mesh, NamedSharding, PartitionSpec

    from repro.config import MeshConfig, ParallelConfig, PrecisionConfig, RunConfig, TrainConfig
    from repro.config.model import reduce_for_smoke
    from repro.configs import get_config
    from repro.parallel import make_rules
    from repro.train.step import abstract_train_state, init_train_state, make_train_step, state_shardings
    from torch_parity import batches

    cfg = reduce_for_smoke(get_config(ARCH))
    B, S = 8, 16
    rows = []
    for dtype in ("float32", "bfloat16"):
        run = RunConfig(arch=ARCH, train=TrainConfig(global_batch=B, seq_len=S, learning_rate=1e-3, warmup_steps=2,
                                                     total_steps=10),
                        parallel=ParallelConfig(remat="full"), precision=PrecisionConfig(compute_dtype=dtype))
        state = init_train_state(cfg, run, jax.random.PRNGKey(0))
        for seed in range(seeds):
            b = {k: jnp.asarray(v) for k, v in batches(cfg, 1, seed=seed, batch=B, seq=S)[0].items()}
            row = {"dtype": dtype, "seed": seed, "1x1": float(jax.jit(make_train_step(cfg, run))(state, b)[1]["grad_norm"])}
            for shape in JAX_MESHES:
                mesh = Mesh(np.array(jax.devices()[: shape[0] * shape[1]]).reshape(shape), ("data", "model"))
                sh = state_shardings(cfg, run, make_rules(MeshConfig(), run.parallel), mesh, abstract_train_state(cfg, run))
                rep = NamedSharding(mesh, PartitionSpec())
                b_sh = {k: NamedSharding(mesh, PartitionSpec("data", *([None] * (v.ndim - 1)))) for k, v in b.items()}
                step = make_train_step(cfg, run, make_rules(MeshConfig(), run.parallel), mesh, param_shardings=sh.params)
                with mesh:
                    j = jax.jit(step, in_shardings=(sh, b_sh),
                                out_shardings=(sh, {"loss": rep, "aux_loss": rep, "lr": rep, "grad_norm": rep}))
                    row[f"{shape[0]}x{shape[1]}"] = float(j(jax.device_put(state, sh), b)[1]["grad_norm"])
            rows.append(row)
    return rows


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--jax", action="store_true", help="the JAX package's sharded steps on the CPU instead")
    a = ap.parse_args(argv)
    for row in jax_rows() if a.jax else port_rows(a.device, a.smoke):
        print(json.dumps(row), flush=True)


if __name__ == "__main__":
    main()
