"""The JAX package's sharded train step on a (data=2, model=2) mesh of four
forced host devices, run as its own process by
``test_torch_sharded_train.py`` (the device count is fixed when JAX
starts):

    XLA_FLAGS=--xla_force_host_platform_device_count=4 JAX_PLATFORMS=cpu \\
        python tests/jax_sharded_train.py BATCHES.npz OUT.npz

It initialises the smoke olmo-1b state from ``PRNGKey(0)`` (fp32 compute,
remat full, the default ``fsdp`` and ``tensor_parallel``), jits
``make_train_step(cfg, run, rules, mesh, param_shardings=...)`` with the
``state_shardings`` of ``make_rules(MeshConfig(), run.parallel)``, as the
dry run lowers it, takes one step per batch of ``BATCHES.npz`` (``tokens_i``,
``labels_i``) and writes each step's metrics, the final parameters (by
their ``/``-joined path) and the executed specs of ``wq`` and ``w_down`` to ``OUT.npz``.
"""

import sys

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


def main(batches_path: str, out_path: str) -> None:
    data = np.load(batches_path)
    n = len([k for k in data if k.startswith("tokens_")])
    batches = [{"tokens": data[f"tokens_{i}"], "labels": data[f"labels_{i}"]} for i in range(n)]
    B, S = batches[0]["tokens"].shape
    cfg = reduce_for_smoke(get_config("olmo-1b"))
    run = RunConfig(arch="olmo-1b", train=TrainConfig(global_batch=B, seq_len=S, **STEPS_TRAIN),
                    parallel=ParallelConfig(remat="full"), precision=PrecisionConfig(compute_dtype="float32"))
    mesh = Mesh(np.array(jax.devices()[:4]).reshape(2, 2), ("data", "model"))
    rules = make_rules(MeshConfig(), run.parallel)
    st_sh = state_shardings(cfg, run, rules, mesh, abstract_train_state(cfg, run))
    rep = NamedSharding(mesh, P())
    b_sh = {"tokens": NamedSharding(mesh, P("data", None)), "labels": NamedSharding(mesh, P("data", None))}
    step = make_train_step(cfg, run, rules, mesh, param_shardings=st_sh.params)
    metrics_sh = {"loss": rep, "aux_loss": rep, "lr": rep, "grad_norm": rep}
    with mesh:
        jstep = jax.jit(step, in_shardings=(st_sh, b_sh), out_shardings=(st_sh, metrics_sh))
        state = jax.device_put(init_train_state(cfg, run, jax.random.PRNGKey(0)), st_sh)
        out = {}
        for i, b in enumerate(batches):
            state, m = jstep(state, {k: jnp.asarray(v) for k, v in b.items()})
            for k in ("loss", "grad_norm", "lr"):
                out[f"{k}_{i}"] = np.asarray(m[k])
    for path, leaf in jax.tree_util.tree_leaves_with_path(state.params):
        out["param/" + "/".join(str(p.key) for p in path)] = np.asarray(leaf)
    blocks = st_sh.params["blocks"]
    out["spec_wq"] = np.array(repr(tuple(blocks["attn"]["wq"].spec)))
    out["spec_w_down"] = np.array(repr(tuple(blocks["mlp"]["w_down"].spec)))
    np.savez(out_path, **out)


if __name__ == "__main__":
    main(*sys.argv[1:3])
