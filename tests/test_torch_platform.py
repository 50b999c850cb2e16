"""The port's platform runtime against the JAX package's, on the CPU.

Each scenario runs on both packages' ``core`` (cluster, QoS scheduler,
federation, tenancy, stragglers) and returns what it saw as plain values:
job states, node assignments, progress, the scheduler's event log, node
states, tenants' nodes, straggler actions.  The two must be equal, and the
reference's own assertions must hold on the port.  The cases of
``tests/test_scheduler.py`` run here as parametrised cases, its two
property tests over seeded job streams (``hypothesis`` is not installed
here, so the reference's module skips).  ``make_tenant_mesh`` needs a
process group (``test_torch_elastic.py`` carves it on four gloo ranks); the
whole ``tests/test_system.py`` scenario runs on the port.
"""

import numpy as np
import pytest
import torch

import repro.core as jax_core
import repro_torch.core as core
from repro_torch.checkpoint import CheckpointManager
from repro_torch.config import RunConfig, TrainConfig, reduce_for_smoke
from repro_torch.configs import get_config
from repro_torch.data import make_batch_fn
from repro_torch.serving import InferenceEngine
from repro_torch.train import init_train_state, make_train_step
from repro_torch.utils.tree import flatten_with_paths

torch.set_num_threads(2)

def make_sched(c, nodes=8, pods=1):
    cluster = c.Cluster(c.ClusterSpec("test", nodes_per_pod=nodes, num_pods=pods))
    return c.Scheduler(cluster), cluster


def observe(sched, cluster, *jobs) -> dict:
    return {
        "jobs": [(j.job_id, j.state.value, list(j.nodes), j.progress, j.chips, j.restarts) for j in jobs],
        "running": sorted(sched.running),
        "log": list(sched.log),
        "nodes": [(n.node_id, n.state.value, n.job) for n in cluster.nodes.values()],
    }


# ---------------------------------------------------------------------------
# tests/test_scheduler.py, case by case
# ---------------------------------------------------------------------------


def priority_order_inference_first(c):
    sched, cluster = make_sched(c, nodes=2)
    train = sched.submit(c.Job("t", "acme", c.QoS.TRAINING, chips=8, duration=100))
    infer = sched.submit(c.Job("i", "acme", c.QoS.INFERENCE, chips=8, duration=100))
    sched.tick(1)
    assert infer.state == c.JobState.RUNNING
    assert train.state == c.JobState.PENDING  # inference claimed the capacity
    return observe(sched, cluster, train, infer)


def flex_start_preemption_and_guaranteed_completion(c):
    sched, cluster = make_sched(c, nodes=2)
    train = sched.submit(c.Job("t", "acme", c.QoS.TRAINING, chips=8, duration=50, checkpoint_interval=10))
    sched.tick(1)
    assert train.state == c.JobState.RUNNING
    sched.tick(26)  # progress 25, checkpoints at 10 and 20
    infer = sched.submit(c.Job("i", "acme", c.QoS.INFERENCE, chips=8, duration=10))
    sched.tick(27)
    assert infer.state == c.JobState.RUNNING
    assert train.state == c.JobState.PENDING and train.progress == 20  # rolled back to its checkpoint
    sched.tick(40)
    assert train.state == c.JobState.RUNNING
    sched.tick(100)
    assert train.state == c.JobState.COMPLETED  # guaranteed completion
    return observe(sched, cluster, train, infer)


def calendar_reservation_auto_start_stop(c):
    sched, cluster = make_sched(c, nodes=4)
    sched.reserve(c.Reservation("r1", "uob", chips=8, start=10, end=30))
    filler = sched.submit(c.Job("f", "acme", c.QoS.TRAINING, chips=16, duration=100))
    sched.tick(1)
    assert filler.state == c.JobState.RUNNING
    sched.tick(10)  # window opens: the reservation starts, preempting flex work
    res_job = sched.running.get("res:r1")
    assert res_job is not None and res_job.state == c.JobState.RUNNING
    seen = observe(sched, cluster, filler, res_job)
    sched.tick(31)  # window closed
    assert "res:r1" not in sched.running
    return [seen, observe(sched, cluster, filler)]


def node_failure_requeues_with_rollback(c):
    sched, cluster = make_sched(c, nodes=2)
    j = sched.submit(c.Job("t", "acme", c.QoS.TRAINING, chips=8, duration=100, checkpoint_interval=7))
    sched.tick(1)
    sched.tick(17)  # progress 16, checkpoints at 7, 14
    nid = j.nodes[0]
    cluster.fail_node(nid)
    assert j.state == c.JobState.PENDING and j.progress == 14 and j.restarts == 1
    cluster.repair_node(nid)
    sched.tick(18)
    assert j.state == c.JobState.RUNNING
    return observe(sched, cluster, j)


def elastic_shrink_start(c):
    sched, cluster = make_sched(c, nodes=4)
    blocker = sched.submit(c.Job("b", "acme", c.QoS.TRAINING, chips=8, duration=1000))
    sched.tick(1)
    elastic = sched.submit(c.Job("e", "acme", c.QoS.TRAINING, chips=16, duration=10, min_chips=4))
    sched.tick(2)
    assert elastic.state == c.JobState.RUNNING and elastic.chips == 8  # shrunk to the free capacity
    return observe(sched, cluster, blocker, elastic)


def pod_local_placement_preferred(c):
    sched, cluster = make_sched(c, nodes=4, pods=2)
    j = sched.submit(c.Job("j", "acme", c.QoS.TRAINING, chips=16, duration=10))
    sched.tick(1)
    assert len({cluster.nodes[n].pod for n in j.nodes}) == 1  # fits in one pod -> stays in one pod
    return observe(sched, cluster, j)


SCHEDULER_CASES = [
    priority_order_inference_first,
    flex_start_preemption_and_guaranteed_completion,
    calendar_reservation_auto_start_stop,
    node_failure_requeues_with_rollback,
    elastic_shrink_start,
    pod_local_placement_preferred,
]


@pytest.mark.parametrize("case", SCHEDULER_CASES, ids=lambda f: f.__name__)
def test_scheduler_case_matches_jax(case):
    assert case(core) == case(jax_core)


def job_stream(c, seed):
    """The property test's random job stream: 1-12 jobs of 1-4 nodes, any
    QoS, 1-40 time units, from a seed."""
    rng = np.random.default_rng(seed)
    ids = rng.choice(10**6, size=int(rng.integers(1, 13)), replace=False)
    qos = list(c.QoS)
    return [c.Job(f"j{i}", "t", qos[int(rng.integers(len(qos)))], chips=int(rng.integers(1, 5)) * c.CHIPS_PER_NODE,
                  duration=float(rng.integers(1, 41))) for i in ids]


def no_double_booking_and_completion(c, seed):
    sched, cluster = make_sched(c, nodes=6)
    jobs = job_stream(c, seed)
    for j in jobs:
        sched.submit(j)
    for t in range(1, 400):
        sched.tick(float(t))
        owners = [n.job for n in cluster.nodes.values() if n.job is not None]
        assert all(owners.count(o) == len(sched.running[o].nodes) for o in set(owners))  # a node serves one job
        assert sum(len(j.nodes) for j in sched.running.values()) <= len(cluster.nodes)
    for j in jobs:  # every job that fits the cluster completes
        if j.nodes_needed <= 6:
            assert j.state == c.JobState.COMPLETED, f"{j.job_id} ended {j.state}"
    return observe(sched, cluster, *jobs)


def rollback_never_exceeds_checkpoint_interval(c, seed):
    rng = np.random.default_rng(seed)
    ckpt_interval = int(rng.integers(5, 26))
    preempt_times = [int(x) for x in rng.integers(10, 121, size=int(rng.integers(1, 5)))]
    sched, cluster = make_sched(c, nodes=2)
    j = sched.submit(c.Job("t", "acme", c.QoS.TRAINING, chips=8, duration=1e9, checkpoint_interval=float(ckpt_interval)))
    clock, lost_seen = 0.0, []
    for pt in sorted(set(preempt_times)):
        if float(pt) <= clock:
            continue
        t = float(pt)
        clock = t + 2.5
        sched.tick(t)
        if j.state != c.JobState.RUNNING:
            continue
        before = j.progress
        sched.submit(c.Job(f"i{pt}", "x", c.QoS.INFERENCE, chips=8, duration=1.0))
        sched.tick(t + 0.5)
        if j.state == c.JobState.PENDING:
            lost = (before + 0.5) - j.progress  # work lost <= one interval
            assert -1e-9 <= lost <= ckpt_interval + 0.5, f"lost {lost} vs interval {ckpt_interval}"
            lost_seen.append(lost)
        sched.tick(t + 2.5)
    return [lost_seen, observe(sched, cluster, j)]


@pytest.mark.parametrize("seed", range(6))
@pytest.mark.parametrize("prop", [no_double_booking_and_completion, rollback_never_exceeds_checkpoint_interval],
                         ids=lambda f: f.__name__)
def test_scheduler_property_matches_jax(prop, seed):
    assert prop(core, seed) == prop(jax_core, seed)


# ---------------------------------------------------------------------------
# cluster, federation, tenancy, stragglers
# ---------------------------------------------------------------------------


def cluster_heartbeats_and_events(c):
    cluster = c.Cluster(c.PHASE1)
    events = []
    cluster.on_event(lambda e, n: events.append((e, n.node_id)))
    cluster.allocate([0, 1, 2], "job", tenant="t")
    for nid in range(6):
        cluster.heartbeat(nid, 10.0)
    cluster.heartbeat(0, 12.5)
    failed = [n.node_id for n in cluster.sweep_heartbeats(13.0, suspect_after=2.0, fail_after=4.0)]
    failed += [n.node_id for n in cluster.sweep_heartbeats(14.5, suspect_after=2.0, fail_after=4.0)]
    cluster.heartbeat(0, 15.0)  # a suspect recovers
    cluster.fail_node(2)
    cluster.repair_node(2, 16.0)
    cluster.drain_node(3)
    freed = cluster.release("job")
    return {"events": events, "failed": failed, "freed": freed, "free_chips": cluster.free_chips(),
            "specs": [(s.name, s.total_nodes, s.total_chips) for s in (c.PHASE1, c.PHASE2, c.DRYRUN_SINGLE, c.DRYRUN_MULTI)],
            "nodes": [(n.node_id, n.state.value, n.job, n.tenant, n.last_heartbeat) for n in cluster.nodes.values()][:8]}


def federation_roles_and_tokens(c):
    now = [0.0]
    iam = c.IAM(token_ttl=10.0, clock=lambda: now[0])
    out = []
    tok = iam.federated_login("a@b", "idp")
    out.append((tok, iam.resolve(tok).subject))
    iam.grant("a@b", c.Role.TENANT_ADMIN, scope="t1")
    for role, scope in ((c.Role.USER, "*"), (c.Role.TENANT_ADMIN, "t1"), (c.Role.TENANT_ADMIN, "t2"), (c.Role.INFRA_ADMIN, "*")):
        try:
            out.append((role.value, scope, iam.require(tok, role, scope).subject))
        except PermissionError as e:
            out.append((role.value, scope, str(e)))
    now[0] = 11.0
    with pytest.raises(PermissionError, match="expired"):
        iam.resolve(tok)
    with pytest.raises(PermissionError, match="unknown"):
        iam.resolve("forged")
    return out


def tenancy_lifecycle(c):
    cluster = c.Cluster(c.ClusterSpec("t", nodes_per_pod=8, num_pods=2))
    iam = c.IAM(token_ttl=100.0, clock=lambda: 0.0)
    mgr = c.TenantManager(cluster, iam)
    tok = iam.federated_login("admin@bristol.ac.uk", "uob-idp")
    iam.grant("admin@bristol.ac.uk", c.Role.INFRA_ADMIN)
    t = mgr.create_tenant("ai-safety", quota_nodes=4, admin="alice@inst.ac.uk", token=tok)
    mgr.create_tenant("small", quota_nodes=2, admin="bob@x", token=tok)
    mgr.grow_tenant("ai-safety", 3, token=tok)
    mgr.grow_tenant("small", 2, token=tok)
    assert len(t.nodes) == 3 and t.rcn == t.nodes[0] and t.chips == 12
    with pytest.raises(PermissionError):
        mgr.grow_tenant("small", 1, token=tok)  # quota
    user = iam.federated_login("mallory@other", "idp")
    with pytest.raises(PermissionError):
        mgr.create_tenant("evil", quota_nodes=1, admin="mallory@other", token=user)
    cluster.allocate([t.nodes[1]], "job-a", tenant="ai-safety")
    with pytest.raises(RuntimeError):
        mgr.shrink_tenant("ai-safety", 2, token=tok)  # one node busy, one the rCN
    mgr.shrink_tenant("small", 1, token=tok)
    assert mgr.check_isolation() == []
    with pytest.raises(ValueError):
        mgr.tenant_submesh_shape("ai-safety", model_parallel=5)
    return {"tenants": {k: (v.nodes, v.rcn, v.chips, v.admins) for k, v in mgr.tenants.items()},
            "submesh": [mgr.tenant_submesh_shape("ai-safety", m) for m in (1, 2, 4)],
            "owners": [(n.node_id, n.tenant, n.job) for n in cluster.nodes.values()]}


def straggler_ladder(c):
    det = c.StragglerDetector(min_samples=3)
    early = None
    for step in range(6):
        for node in range(8):
            det.observe(node, {6: 1.8, 7: 4.0}.get(node, 1.0 + 0.01 * node))
        if step == 1:
            early = det.stragglers()  # too few samples to judge
    actions = det.stragglers()
    assert early == {} and actions.get(6) == "drain" and actions.get(7) == "evict" and 5 not in actions
    return {"actions": actions, "slowdown": det.step_slowdown(), "ewma": det.ewma}


@pytest.mark.parametrize("scenario", [cluster_heartbeats_and_events, federation_roles_and_tokens, tenancy_lifecycle,
                                      straggler_ladder], ids=lambda f: f.__name__)
def test_platform_scenario_matches_jax(scenario):
    assert scenario(core) == scenario(jax_core)


def test_make_tenant_mesh_raises():
    """Without a process group ``make_tenant_mesh`` raises, naming it (its
    meshes on four ranks: ``test_torch_elastic.py``); the submesh shape
    needs no ranks."""
    cluster = core.Cluster(core.ClusterSpec("t", nodes_per_pod=4, num_pods=1))
    iam = core.IAM(clock=lambda: 0.0)
    tok = iam.federated_login("ops", "uob")
    iam.grant("ops", core.Role.INFRA_ADMIN)
    mgr = core.TenantManager(cluster, iam)
    mgr.create_tenant("t1", quota_nodes=2, admin="a", token=tok)
    mgr.grow_tenant("t1", 2, token=tok)
    with pytest.raises(RuntimeError, match="process group"):
        mgr.make_tenant_mesh("t1", model_parallel=2)
    assert mgr.tenant_submesh_shape("t1", model_parallel=2) == (4, 2)


# ---------------------------------------------------------------------------
# tests/test_system.py on the port
# ---------------------------------------------------------------------------


def test_full_facility_scenario(tmp_path):
    c = core
    cluster = c.Cluster(c.ClusterSpec("phase1-mini", nodes_per_pod=6, num_pods=1))
    iam = c.IAM(clock=lambda: 0.0)
    admin = iam.federated_login("ops@bristol.ac.uk", "uob")
    iam.grant("ops@bristol.ac.uk", c.Role.INFRA_ADMIN)
    tenants = c.TenantManager(cluster, iam)
    tenants.create_tenant("research", quota_nodes=4, admin="alice@inst", token=admin)
    tenants.create_tenant("serving", quota_nodes=2, admin="bob@inst", token=admin)
    tenants.grow_tenant("research", 3, token=admin)
    tenants.grow_tenant("serving", 1, token=admin)
    assert tenants.check_isolation() == []

    sched = c.Scheduler(cluster)
    train_job = sched.submit(c.Job("llm-train", "research", c.QoS.TRAINING, chips=8, duration=30, checkpoint_interval=5))
    sched.tick(1)
    assert train_job.state == c.JobState.RUNNING

    cfg = reduce_for_smoke(get_config("olmo-1b"))
    run = RunConfig(arch="olmo-1b", train=TrainConfig(global_batch=4, seq_len=16))
    runner = c.FaultTolerantRunner(
        step_fn=make_train_step(cfg, run),
        init_state=init_train_state(cfg, run, 0, device="cpu"),
        batch_fn=make_batch_fn(cfg, global_batch=4, seq_len=16, device="cpu"),
        cluster=cluster,
        ckpt=CheckpointManager(tmp_path, keep=2, async_save=False),
        job_id="llm-train",
        checkpoint_every=4,
    )
    report = runner.run(10, failure_schedule={6: train_job.nodes[0]})
    assert report.failures == 1 and report.restores == 1
    assert max(report.losses) == 10
    assert np.isfinite(list(report.losses.values())).all()
    assert all(torch.isfinite(x.float()).all() for _, x in flatten_with_paths(runner.state))

    # the port's random weights (torch's generator, not jax.random) may pick
    # token 1, the default eos, first: no eos, so both requests run to length
    eng = InferenceEngine(cfg, runner.state.params, max_batch=2, max_seq=64, eos_token=-1, device="cpu")
    r1 = eng.submit([3, 1, 4], max_new_tokens=4)
    r2 = eng.submit([1, 5, 9], max_new_tokens=4, online=False)
    eng.run_until_drained()
    assert len(r1.generated) == 4 and len(r2.generated) == 4
    assert r1.finish_reason == r2.finish_reason == "length"

    rep = runner.ledger.report()
    assert rep["effective_pue"] < 1.1
    assert rep["facility_kwh"] >= 0 and runner.ledger.facility_joules > 0
