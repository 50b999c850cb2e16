"""Replicas of tensor-parallel engines behind the router: two replicas of
TP=2 engines on four gloo ranks on the CPU (``serving.remote``), against
the port's router over two TP=1 replicas and the JAX launcher's fleet.

Four spawned ranks run every scenario in one spawn
(``torch_tp_ranks.run_fleet_cases``; the ranks import no JAX): the router
on rank 0 leads replica 0 (ranks 0 and 1) and drives replica 1's lead
(rank 2, followed by rank 3) through a ``RemoteEngine``.  The same
prompts (four families sharing an 8-token system prompt, two requests
each, interleaved) go, in the same scenarios, through

* the port's ``Router`` over two TP=1 engines in this process, on the same
  weights (the JAX initialisation, bridged);
* the JAX launcher's fleet: ``repro.launch.mesh.make_replica_meshes(2, 2)``
  over four forced host devices, two TP=2 JAX engines behind the JAX
  ``Router`` (``tests/jax_replica_fleet.py``, a process of its own,
  started first so it runs beside the spawn).

Every router and replica reads a ``ManualClock`` ticking 1e-4 s a read, so
no heartbeat ages with the host's load.  The scenarios: affinity; replica
0 crashed at its 4th step (its requests fail over to the remote replica:
the failover resume's seed crosses to the lead); replica 1 crashed at its
4th step (they fail over to rank 0's own TP engine: the seed rides in the
submission its follower takes).  Each must give every request the same
placement, final replica and greedy tokens in all three fleets (fp32
pools and an ``eos_token`` outside the vocab: no near-tie can flip an
argmax, so the tolerance is exact equality), lose no request, and leave
the crashed replica dead.  The control, replica 0 crashed under a
stand-in that never sends the seed to the lead (the lead's request starts
over, so the router forwards its tokens again), must change the tokens.
The launcher's ``--replicas 2 --tp 2 --http`` serves two streams and
drains on SIGTERM with the TP=1 engine's tokens.
"""

import json
import os
import signal
import subprocess
import sys
import time
import urllib.request
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config.model import reduce_for_smoke as jax_reduce
from repro.configs import get_config as jax_get_config
from repro.models import init_params as jax_init_params
from repro_torch.bridge import params_from_jax
from repro_torch.config import reduce_for_smoke
from repro_torch.configs import get_config
from repro_torch.launch.mesh import free_port, run_ranks
from repro_torch.models import init_params
from repro_torch.serving import InferenceEngine

import torch_tp_ranks

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parents[1]
EOS_OUT = 1 << 30  # outside the vocab: every request runs to its length
ENGINE = dict(max_batch=4, max_seq=64, block_size=4, prefill_budget=8, eos_token=EOS_OUT)
MAX_NEW = 6
CRASH_AT = 4
PROMPTS = [[(13 * t + 5 * j + 7) % 197 + 2 for j in range(8)] + [200 + 4 * t + i, 210 + t, 220 + i]
           for i in range(2) for t in range(4)]
SCENARIOS = {"affinity": {}, "crash_0": {0: {"crash_at_step": CRASH_AT}}, "crash_1": {1: {"crash_at_step": CRASH_AT}}}
CONTROL = {"name": "control", "plans": SCENARIOS["crash_0"], "remote": "drop_seeds"}
OBSERVED = ("tokens", "placed", "finished_on", "requests_done", "requests_failed", "failovers")


@pytest.fixture(scope="module")
def fleets(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("fleet")
    spec = {"engine": ENGINE, "prompts": PROMPTS, "max_new": MAX_NEW,
            "scenarios": {name: {str(i): p for i, p in plans.items()} for name, plans in SCENARIOS.items()}}
    (tmp / "cases.json").write_text(json.dumps(spec))
    env = dict(os.environ, XLA_FLAGS="--xla_force_host_platform_device_count=4", JAX_PLATFORMS="cpu",
               PYTHONPATH=str(ROOT / "src"))
    jax_proc = subprocess.Popen([sys.executable, str(ROOT / "tests" / "jax_replica_fleet.py"), str(tmp / "cases.json"),
                                 str(tmp / "out.json")], env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
    jcfg, tcfg = jax_reduce(jax_get_config("olmo-1b")), reduce_for_smoke(get_config("olmo-1b"))
    jparams = jax_init_params(jcfg, jax.random.PRNGKey(0), jnp.float32)
    params = params_from_jax(tcfg, jax.tree.map(np.asarray, jparams), device="cpu")
    scenarios = [{"name": name, "plans": plans} for name, plans in SCENARIOS.items()] + [CONTROL]
    engine = dict(ENGINE, cache_kind="paged", prefix_cache=True, cache_dtype=torch.float32, device="cpu")
    port = {"engine": engine, "prompts": PROMPTS, "max_new": MAX_NEW, "scenarios": scenarios}
    ranks = run_ranks(torch_tp_ranks.run_fleet_cases, (2, 2), device="cpu", timeout_s=300, args=(tcfg, params, port))
    tp1 = {name: torch_tp_ranks.tp1_fleet(tcfg, params, port, plans) for name, plans in SCENARIOS.items()}
    out, _ = jax_proc.communicate(timeout=300)
    assert jax_proc.returncode == 0, out.decode()[-4000:]
    jax_fleet = json.loads((tmp / "out.json").read_text())
    return {"ranks": ranks, "tp1": tp1, "jax": jax_fleet, "names": [s["name"] for s in scenarios]}


@pytest.mark.parametrize("name", list(SCENARIOS))
def test_replicas_of_tp2_engines_equal_the_tp1_and_jax_fleets(fleets, name):
    i = fleets["names"].index(name)
    port, tp1, jx = fleets["ranks"][0][i], fleets["tp1"][name], fleets["jax"][name]
    assert {k: port[k] for k in OBSERVED} == {k: tp1[k] for k in OBSERVED}, name
    assert {k: jx[k] for k in OBSERVED} == {k: tp1[k] for k in OBSERVED}, name
    assert port["requests_done"] == len(PROMPTS) and port["requests_failed"] == 0
    assert set(port["placed"]) == {0, 1}, "both replicas take requests"
    assert port["states"] == tp1["states"]
    crashed = [rid for rid in (0, 1) if rid in SCENARIOS[name]]
    for rid, state in port["states"].items():
        assert state == ("dead" if rid in crashed else "healthy")
        if rid not in crashed:
            stats = port["per_replica"][rid]
            assert stats["tp"] == 2 and stats["alloc_blocks_in_use"] == 0
    if crashed:
        assert port["failovers"] >= 1
        assert all(f != crashed[0] for f in port["finished_on"])


def test_each_rank_serves_its_replica(fleets):
    """The followers of both replicas step with their leads; no rank
    loaded JAX."""
    ranks = fleets["ranks"]
    for r in ranks:
        assert r[-1] == {"jax_loaded": False}
    i = fleets["names"].index("affinity")
    for rank in (1, 2, 3):
        s = ranks[rank][i]["stats"]
        assert s["tp"] == 2 and s["requests_done"] > 0 and s["alloc_blocks_in_use"] == 0
    lead0, lead1 = ranks[0][i]["per_replica"]
    assert ranks[1][i]["stats"]["tokens_out"] == ranks[0][i]["per_replica"][lead0]["tokens_out"]
    assert ranks[3][i]["stats"]["tokens_out"] == ranks[2][i]["stats"]["tokens_out"]
    assert ranks[2][i]["stats"]["tokens_out"] == ranks[0][i]["per_replica"][lead1]["tokens_out"]


def test_control_dropping_the_resume_seed_fails(fleets):
    """Replica 0 crashed, its requests resumed on the remote replica by a
    stand-in that never sends the delivered tokens to the lead: the lead's
    request starts over, the router forwards its tokens as fresh, and the
    tokens part from the no-failure run's."""
    port = fleets["ranks"][0][fleets["names"].index("control")]
    ref = fleets["tp1"]["crash_0"]
    assert port["failovers"] >= 1 and port["requests_done"] == len(PROMPTS)
    assert port["tokens"] != ref["tokens"]
    moved = [j for j, (a, b) in enumerate(zip(port["placed"], port["finished_on"])) if a != b]
    assert any(port["tokens"][j] != ref["tokens"][j] for j in moved)


def _get(url: str, data: bytes | None = None) -> str:
    req = urllib.request.Request(url, data=data, headers={"Content-Type": "application/json"} if data else {})
    with urllib.request.urlopen(req, timeout=30) as resp:
        return resp.read().decode()


def test_serve_launcher_fleet_http():
    """``--replicas 2 --tp 2 --http`` serves two requests over the fleet
    from rank 0 and drains on SIGTERM; each stream's tokens are the TP=1
    engine's on the same seed."""
    port = free_port()
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.serve", "--device", "cpu", "--arch", "olmo-1b", "--replicas", "2",
         "--tp", "2", "--http", "--port", str(port)],
        cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
    )
    prompts = [[5, 9, 12, 7], [40, 41, 42]]
    try:
        base = f"http://127.0.0.1:{port}"
        for _ in range(600):
            try:
                if _get(base + "/healthz"):
                    break
            except OSError:
                time.sleep(0.1)
        raws = [_get(base + "/v1/generate", json.dumps({"prompt": p, "max_new_tokens": 5}).encode()) for p in prompts]
        stats = json.loads(_get(base + "/stats"))
        proc.send_signal(signal.SIGTERM)
        out, _ = proc.communicate(timeout=120)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    assert proc.returncode == 0, out
    assert "drain complete" in out and "tp=2 over gloo" in out, out
    assert stats["replicas"] == 2 and stats["requests_done"] == 2
    cfg = reduce_for_smoke(get_config("olmo-1b"))
    eng = InferenceEngine(cfg, init_params(cfg, 0, device="cpu"), max_batch=4, max_seq=256, block_size=16,
                          device="cpu")
    reqs = [eng.submit(p, max_new_tokens=5) for p in prompts]
    eng.run_until_drained()
    for raw, req in zip(raws, reqs):
        events = [json.loads(line[len("data: "):]) for line in raw.splitlines() if line.startswith("data: ")]
        assert [t for e in events for t in e.get("tokens", [])] == req.generated, raw
