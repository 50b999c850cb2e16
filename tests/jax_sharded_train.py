"""The JAX package's sharded train step on a (data=2, model=2) mesh of four
forced host devices (``--mesh DxM``: another shape of four), run as its own
process by ``test_torch_sharded_train.py`` and the other sharded tests
(the device count is fixed when JAX starts):

    XLA_FLAGS=--xla_force_host_platform_device_count=4 JAX_PLATFORMS=cpu \\
        python tests/jax_sharded_train.py BATCHES.npz OUT.npz [--arch ARCH] [--open-gates G] \\
            [--sequence-parallel] [--mesh 1x4]

It initialises the smoke state of ``ARCH`` (default olmo-1b; the sharded
tests of the other families pass theirs) from ``PRNGKey(0)`` (fp32
compute, remat full, the default ``fsdp`` and ``tensor_parallel``);
``--open-gates G`` then sets every vlm cross layer's ``gate`` and
``gate_mlp`` to G (random init leaves them at 0, which makes the cross
layers the identity); ``--sequence-parallel`` sets
``ParallelConfig(sequence_parallel=True)``, so the rule engine splits the
residual stream's ``"seq"`` over ``"model"`` between the blocks.  It jits
``make_train_step(cfg, run, rules, mesh, param_shardings=...)`` with the
``state_shardings`` of ``make_rules(MeshConfig(), run.parallel)``, as the
dry run lowers it, takes one step per batch of ``BATCHES.npz`` (``tokens_i``,
``labels_i``, and every other key ``<name>_i`` of a batch, such as
``vision_tokens_i``) and writes each step's metrics, the final parameters (by
their ``/``-joined path) and the executed specs of ``wq`` and ``w_down`` to ``OUT.npz``.
"""

import argparse

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from repro.config import MeshConfig, ParallelConfig, PrecisionConfig, RunConfig, TrainConfig
from repro.config.model import reduce_for_smoke
from repro.configs import get_config
from repro.parallel import make_rules
from repro.train.step import abstract_train_state, init_train_state, make_train_step, state_shardings

STEPS_TRAIN = dict(learning_rate=1e-3, warmup_steps=2, total_steps=10)


def open_gates(state, value: float):
    """``state`` with every cross layer's ``gate`` and ``gate_mlp`` set to
    ``value``."""
    cross = state.params["blocks"]["cross"]
    cross = dict(cross, attn=dict(cross["attn"], gate=jnp.full_like(cross["attn"]["gate"], value)),
                 gate_mlp=jnp.full_like(cross["gate_mlp"], value))
    return state._replace(params=dict(state.params, blocks=dict(state.params["blocks"], cross=cross)))


def main(batches_path: str, out_path: str, arch: str = "olmo-1b", gates: float | None = None,
         sequence_parallel: bool = False, mesh_shape: tuple = (2, 2)) -> None:
    data = np.load(batches_path)
    n = len([k for k in data if k.startswith("labels_")])
    keys = sorted({k.rsplit("_", 1)[0] for k in data})
    batches = [{k: data[f"{k}_{i}"] for k in keys} for i in range(n)]
    B, S = batches[0]["labels"].shape
    cfg = reduce_for_smoke(get_config(arch))
    run = RunConfig(arch=arch, train=TrainConfig(global_batch=B, seq_len=S, **STEPS_TRAIN),
                    parallel=ParallelConfig(remat="full", sequence_parallel=sequence_parallel),
                    precision=PrecisionConfig(compute_dtype="float32"))
    mesh = Mesh(np.array(jax.devices()[:4]).reshape(mesh_shape), ("data", "model"))
    rules = make_rules(MeshConfig(), run.parallel)
    st_sh = state_shardings(cfg, run, rules, mesh, abstract_train_state(cfg, run))
    rep = NamedSharding(mesh, P())
    b_sh = {k: NamedSharding(mesh, P("data", *([None] * (v.ndim - 1)))) for k, v in batches[0].items()}
    step = make_train_step(cfg, run, rules, mesh, param_shardings=st_sh.params)
    metrics_sh = {"loss": rep, "aux_loss": rep, "lr": rep, "grad_norm": rep}
    with mesh:
        jstep = jax.jit(step, in_shardings=(st_sh, b_sh), out_shardings=(st_sh, metrics_sh))
        state = init_train_state(cfg, run, jax.random.PRNGKey(0))
        if gates is not None:
            state = open_gates(state, gates)
        state = jax.device_put(state, st_sh)
        out = {}
        for i, b in enumerate(batches):
            state, m = jstep(state, {k: jnp.asarray(v) for k, v in b.items()})
            for k in ("loss", "aux_loss", "grad_norm", "lr"):
                out[f"{k}_{i}"] = np.asarray(m[k])
    for path, leaf in jax.tree_util.tree_leaves_with_path(state.params):
        out["param/" + "/".join(str(p.key) for p in path)] = np.asarray(leaf)
    for path, sh in jax.tree_util.tree_leaves_with_path(st_sh.params):
        out["spec/" + "/".join(str(p.key) for p in path)] = np.array(repr(tuple(sh.spec)))
    blocks = st_sh.params["blocks"]
    if "attn" in blocks and "mlp" in blocks:
        out["spec_wq"] = np.array(repr(tuple(blocks["attn"]["wq"].spec)))
        out["spec_w_down"] = np.array(repr(tuple(blocks["mlp"]["w_down"].spec)))
    np.savez(out_path, **out)


if __name__ == "__main__":
    parser = argparse.ArgumentParser()
    parser.add_argument("batches")
    parser.add_argument("out")
    parser.add_argument("--arch", default="olmo-1b")
    parser.add_argument("--open-gates", type=float, default=None)
    parser.add_argument("--sequence-parallel", action="store_true")
    parser.add_argument("--mesh", default="2x2", help="(data)x(model), four devices in all")
    a = parser.parse_args()
    main(a.batches, a.out, a.arch, a.open_gates, a.sequence_parallel, tuple(int(n) for n in a.mesh.split("x")))
