"""The JAX launcher's fleet: two replicas of tensor-parallel engines, each
on its own (1, 2) slice of four forced host devices
(``repro.launch.mesh.make_replica_meshes(2, 2)``), behind the JAX
``Router``, run as its own process by ``test_torch_replicas_tp.py`` (the
device count is fixed when JAX starts):

    XLA_FLAGS=--xla_force_host_platform_device_count=4 JAX_PLATFORMS=cpu \\
        python tests/jax_replica_fleet.py CASES.json OUT.json

``CASES.json`` holds the engines' options (``engine``: ``max_batch``,
``max_seq``, ``block_size``, ``prefill_budget``, ``eos_token``), the prompts,
``max_new`` and the scenarios, each a name and its fault plans
(``{"replica id": {"crash_at_step": k}}``).  The smoke olmo-1b's weights
come from ``PRNGKey(0)`` in fp32, the pools are fp32, the prefix cache is
on, and the router and every replica read one ``ManualClock`` ticking 1e-4
s a read.  ``OUT.json`` gets each scenario's tokens, the replica each
request was placed on and the one it finished on, and the router's counts
of requests done and failed and of failovers.
"""

import json
import sys

import jax
import jax.numpy as jnp

from repro.config.model import reduce_for_smoke
from repro.configs import get_config
from repro.launch.mesh import make_replica_meshes
from repro.models import init_params
from repro.serving import FaultPlan, InferenceEngine, ManualClock, Replica, Router


def main(cases_path: str, out_path: str) -> None:
    spec = json.loads(open(cases_path).read())
    cfg = reduce_for_smoke(get_config("olmo-1b"))
    params = init_params(cfg, jax.random.PRNGKey(0), jnp.float32)
    meshes = make_replica_meshes(2, 2)
    out = {}
    for name, plans in spec["scenarios"].items():
        clock = ManualClock(tick=1e-4)
        replicas = [
            Replica(i, InferenceEngine(cfg, params, mesh=meshes[i], cache_kind="paged", prefix_cache=True,
                                       cache_dtype=jnp.float32, clock=clock, **spec["engine"]),
                    clock=clock, fault_plan=FaultPlan(**plans[str(i)]) if str(i) in plans else None)
            for i in range(2)
        ]
        router = Router(replicas, clock=clock, backoff_base_s=1e-4)
        reqs = [router.submit(p, max_new_tokens=spec["max_new"]) for p in spec["prompts"]]
        placed = [r.replica_id for r in reqs]
        router.run_until_drained()
        s = router.stats()
        out[name] = {"tokens": [list(map(int, r.generated)) for r in reqs], "placed": placed,
                     "finished_on": [r.replica_id for r in reqs], "requests_done": s["requests_done"],
                     "requests_failed": s["requests_failed"], "failovers": int(s["failovers"])}
    open(out_path, "w").write(json.dumps(out))


if __name__ == "__main__":
    main(sys.argv[1], sys.argv[2])
