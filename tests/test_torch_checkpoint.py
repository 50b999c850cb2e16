"""The port's checkpoint layer against the JAX package's, on the CPU.

The eight cases of ``tests/test_checkpoint.py`` run on torch trees, with the
modelled seconds, tier choices and Young/Daly advice equal to the JAX
package's; checkpoints cross between the packages bit for bit, both ways
(f32, bf16, e4m3, e5m2 and int32 leaves in nested dicts); an asynchronous
save keeps the values its tree had when ``save`` returned; a restore builds
new tensors and leaves ``like``'s as they were; a whole ``TrainState``
(NamedTuples, ``None``) round-trips.
"""

import json
import threading

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.checkpoint import CheckpointManager as JaxManager
from repro.checkpoint import TIERS as JAX_TIERS
from repro.checkpoint import restore_pytree as jax_restore
from repro.checkpoint import save_pytree as jax_save
from repro.checkpoint.storage import DataMover as JaxDataMover
from repro_torch.checkpoint import (
    QOS_TIER,
    TIERS,
    CheckpointManager,
    available_steps,
    checkpoint_bytes,
    restore_pytree,
    save_pytree,
)
from repro_torch.checkpoint.storage import DataMover
from repro_torch.config import PrecisionConfig, RunConfig, reduce_for_smoke
from repro_torch.configs import get_config
from repro_torch.train import init_train_state
from repro_torch.utils.tree import flatten_with_paths

torch.set_num_threads(2)


def tree(seed=0):
    g = torch.Generator().manual_seed(seed)
    return {
        "a": torch.randn((16, 8), generator=g),
        "nested": {"b": torch.arange(10, dtype=torch.int32), "c": torch.randn((3,), generator=g).bfloat16()},
    }


def leaves_equal(a, b) -> bool:
    pa, pb = flatten_with_paths(a), flatten_with_paths(b)
    return [p for p, _ in pa] == [p for p, _ in pb] and all(
        x.dtype == y.dtype and torch.equal(x, y) for (_, x), (_, y) in zip(pa, pb)
    )


def test_roundtrip(tmp_path):
    t = tree()
    save_pytree(t, tmp_path, step=7)
    out, extra = restore_pytree(tree(seed=1), tmp_path)
    assert leaves_equal(t, out) and extra == {}
    manifest = json.loads((tmp_path / "step_00000007" / "manifest.json").read_text())
    assert manifest["leaves"]["nested/c"] == {"shape": [3], "dtype": "bfloat16"}
    assert np.load(tmp_path / "step_00000007" / "nested__c.npy").dtype == np.uint16  # raw bits, as the reference


def test_restore_validates_shapes(tmp_path):
    save_pytree(tree(), tmp_path, step=1)
    bad = {"a": torch.zeros((2, 2)), "nested": {"b": torch.zeros(10, dtype=torch.int32),
                                                "c": torch.zeros(3, dtype=torch.bfloat16)}}
    with pytest.raises(ValueError):
        restore_pytree(bad, tmp_path)
    with pytest.raises(KeyError):
        restore_pytree({"missing": torch.zeros(1)}, tmp_path)


def test_atomic_commit_never_exposes_partial(tmp_path):
    """A directory only becomes a restore point at the atomic rename."""
    save_pytree(tree(), tmp_path, step=1)
    crashed = tmp_path / ".tmp_ckpt_crashed"
    crashed.mkdir()
    (crashed / "manifest.json").write_text("{corrupt")
    assert available_steps(tmp_path) == [1]
    with pytest.raises(TypeError):  # a leaf with no format leaves no directory behind
        save_pytree({"x": torch.zeros(2, dtype=torch.complex64)}, tmp_path, step=2)
    assert available_steps(tmp_path) == [1]
    assert sorted(p.name for p in tmp_path.iterdir()) == [".tmp_ckpt_crashed", "step_00000001"]


def test_manager_keep_k_and_async(tmp_path):
    mgr = CheckpointManager(tmp_path, keep=2, async_save=True)
    t = tree()
    for s in (1, 2, 3, 4):
        mgr.save(t, step=s)
    mgr.wait()
    assert available_steps(tmp_path) == [3, 4]
    out, extra = mgr.restore(tree(seed=1))
    assert leaves_equal(t, out)
    # synchronous managers of both packages on the same bytes: the same
    # records (bytes, tier, modelled seconds) and the same modelled restore
    ours = CheckpointManager(tmp_path / "ours", keep=2, async_save=False)
    ref = JaxManager(tmp_path / "ref", keep=2, async_save=False)
    for s in (1, 2, 3, 4):
        ours.save(t, step=s)
        ref.save(_to_numpy_tree(t), step=s)
    assert [(r.step, r.nbytes, r.tier, r.modeled_seconds) for r in ours.records] == [
        (r.step, r.nbytes, r.tier, r.modeled_seconds) for r in ref.records]
    _, jextra = ref.restore(jax.tree.map(lambda a: jax.ShapeDtypeStruct(a.shape, a.dtype), _to_numpy_tree(t)))
    assert extra["modeled_restore_seconds"] == jextra["modeled_restore_seconds"] > 0
    mgr.close()


@pytest.mark.parametrize("qos", ["training", "inference", "experimentation", "fine_tuning", "unknown"])
def test_tier_selection_by_qos(tmp_path, qos):
    got = CheckpointManager(tmp_path, qos=qos, async_save=False).tier_name
    assert got == JaxManager(tmp_path / "j", qos=qos, async_save=False).tier_name
    assert got == {"training": "lustre", "inference": "vast", "experimentation": "local"}.get(qos, got)
    assert QOS_TIER.get(qos, "lustre") == got


def test_arctic_checkpoint_fits_paper_lustre_envelope():
    """480B params in bf16 (+bf16 moments) ~ 2.9 TB -> < 2 s at the paper's
    1,980 GB/s ClusterStor write bandwidth; the same model as the JAX package's."""
    nbytes = 480e9 * 2 * 3
    t = TIERS["lustre"].write_seconds(nbytes)
    assert t < 2.0 and TIERS["tape"].write_seconds(nbytes) > 9 * 3600 * 0.06
    for name, tier in TIERS.items():
        for files in (1, 7):
            assert tier.write_seconds(nbytes, files) == JAX_TIERS[name].write_seconds(nbytes, files)
            assert tier.read_seconds(nbytes, files) == JAX_TIERS[name].read_seconds(nbytes, files)


@pytest.mark.parametrize("nodes,step_seconds,nbytes", [(1320, 10.0, 2.9e12), (2, 0.3, 4.46e9), (1, 1e-12, 1.0)])
def test_young_daly_cadence(tmp_path, nodes, step_seconds, nbytes):
    mgr = CheckpointManager(tmp_path, qos="training", nodes=nodes)
    advice = mgr.cadence_advice(step_seconds=step_seconds, nbytes=nbytes)
    ref = JaxManager(tmp_path / "j", qos="training", nodes=nodes, async_save=False).cadence_advice(
        step_seconds=step_seconds, nbytes=nbytes)
    assert advice == ref
    if nodes == 1320:  # 1,320 nodes at 50k h node-MTBF -> job MTBF ~ 37.9 h
        assert 30 < advice["job_mtbf_hours"] < 45
        assert advice["optimal_interval_seconds"] > 60
        assert advice["overhead_fraction"] < 0.05
    mgr.close()


def test_data_mover_policy():
    mover, ref = DataMover(), JaxDataMover()
    for src, dst in (("lustre", "vast"), ("vast", "tape"), ("local", "cloud")):
        assert mover.move_seconds(1e12, src, dst, files=3) == ref.move_seconds(1e12, src, dst, files=3) > 0
    assert mover.log == ref.log
    for age, accessed in ((400, 200), (40, 35), (1, 1)):
        assert mover.archive_policy(age, accessed) == ref.archive_policy(age, accessed)
    assert [mover.archive_policy(400, 200), mover.archive_policy(40, 35), mover.archive_policy(1, 1)] == ["tape", "vast", None]


# ---------------------------------------------------------------------------
# across the packages
# ---------------------------------------------------------------------------

KINDS = {  # name -> (numpy dtype the JAX tree holds, torch dtype)
    "f32": (np.float32, torch.float32),
    "bf16": (ml_dtypes.bfloat16, torch.bfloat16),
    "e4m3": (ml_dtypes.float8_e4m3fn, torch.float8_e4m3fn),
    "e5m2": (ml_dtypes.float8_e5m2, torch.float8_e5m2),
    "i32": (np.int32, torch.int32),
}


def _bits(x) -> np.ndarray:
    """The raw bits of a numpy array or tensor, as unsigned integers."""
    if isinstance(x, torch.Tensor):
        if x.dtype in (torch.float8_e4m3fn, torch.float8_e5m2):
            x = x.view(torch.uint8)
        elif x.dtype == torch.bfloat16:
            x = x.view(torch.uint16)
        x = x.numpy()
    x = np.asarray(x)
    return x.view(np.dtype(f"u{x.dtype.itemsize}"))


def _to_numpy_tree(t):
    """A torch tree of float32, int32 and bf16 leaves as the JAX package holds it."""
    return {k: _to_numpy_tree(v) if isinstance(v, dict) else
            (_bits(v).view(ml_dtypes.bfloat16) if v.dtype == torch.bfloat16 else v.numpy()) for k, v in t.items()}


def _mixed_tree(seed=0):
    """The same values as a JAX tree (numpy leaves) and a torch tree, nested dicts."""
    rng = np.random.default_rng(seed)
    np_tree = {"params": {}, "state": {"inner": {}}}
    for i, (name, (np_dt, _)) in enumerate(KINDS.items()):
        if name == "i32":
            a = rng.integers(-(2**31), 2**31 - 1, (5, 3), dtype=np.int64).astype(np.int32)
        else:
            a = (rng.standard_normal((4, 6)) * 40).astype(np.float32).astype(np_dt)  # e4m3 saturates past 448
        (np_tree["params"] if i % 2 else np_tree["state"]["inner"])[name] = a
    torch_tree = jax.tree.map(lambda a: torch.from_numpy(_bits(a).copy()).view(KINDS[_kind(a)][1]), np_tree)
    return np_tree, torch_tree


def _kind(a) -> str:
    return next(k for k, (np_dt, _) in KINDS.items() if np.dtype(np_dt) == a.dtype)


@pytest.mark.parametrize("direction", ["jax_to_torch", "torch_to_jax"])
def test_checkpoints_cross_between_packages_bit_for_bit(tmp_path, direction):
    np_tree, torch_tree = _mixed_tree()
    if direction == "jax_to_torch":
        jax_save(jax.tree.map(jnp.asarray, np_tree), tmp_path, step=3, extra={"by": "jax"})
        like = jax.tree.map(lambda t: torch.zeros_like(t), torch_tree, is_leaf=lambda x: isinstance(x, torch.Tensor))
        out, extra = restore_pytree(like, tmp_path)
        assert extra == {"by": "jax"}
        for (p, got), (_, want) in zip(flatten_with_paths(out), flatten_with_paths(torch_tree)):
            assert got.dtype == want.dtype, p
            np.testing.assert_array_equal(_bits(got), _bits(want), err_msg=p)
    else:
        save_pytree(torch_tree, tmp_path, step=3, extra={"by": "torch"})
        like = jax.tree.map(lambda a: jax.ShapeDtypeStruct(a.shape, a.dtype), np_tree)
        out, extra = jax_restore(like, tmp_path)
        assert extra == {"by": "torch"}
        for want, got in zip(jax.tree.leaves(np_tree), jax.tree.leaves(out)):
            assert np.asarray(got).dtype == want.dtype
            np.testing.assert_array_equal(_bits(got), _bits(want))
    # the two packages write the same files and the same manifest entries
    other = tmp_path / "other"
    (save_pytree(torch_tree, other, step=3) if direction == "jax_to_torch"
     else jax_save(jax.tree.map(jnp.asarray, np_tree), other, step=3))
    a = json.loads((tmp_path / "step_00000003" / "manifest.json").read_text())["leaves"]
    b = json.loads((other / "step_00000003" / "manifest.json").read_text())["leaves"]
    assert a == b and len(a) == len(KINDS)
    for path in a:
        fa = np.load(tmp_path / "step_00000003" / (path.replace("/", "__") + ".npy"))
        fb = np.load(other / "step_00000003" / (path.replace("/", "__") + ".npy"))
        assert fa.dtype == fb.dtype and np.array_equal(fa, fb), path


# ---------------------------------------------------------------------------
# the port's own: snapshots, restore targets, whole train states
# ---------------------------------------------------------------------------


def test_async_save_snapshots_before_returning(tmp_path):
    """CPU tensors changed in place after ``save`` returned (as the train
    step changes parameters and moments) are saved with the values they had
    when it returned.  The worker is held until the change is made, so a
    save that kept references instead of a copy would write the new values."""
    mgr = CheckpointManager(tmp_path, keep=3, async_save=True)
    go = threading.Event()
    save_now = mgr._save_now

    def held(*args):
        assert go.wait(timeout=30)
        return save_now(*args)

    mgr._save_now = held
    t = tree()
    before = {p: x.clone() for p, x in flatten_with_paths(t)}
    mgr.save(t, step=5, block=False)
    for _, x in flatten_with_paths(t):
        x.add_(1)  # the next step, in place
    go.set()
    mgr.wait()
    out, _ = mgr.restore(tree(seed=1))
    for p, x in flatten_with_paths(out):
        assert torch.equal(x, before[p]) and not torch.equal(x, dict(flatten_with_paths(t))[p]), p
    mgr.close()


def test_restore_target(tmp_path):
    """A restore builds new tensors, each of ``like``'s dtype, and leaves
    ``like`` as it was; two restores of one checkpoint share no tensor."""
    t = tree()
    save_pytree(t, tmp_path, step=2)
    like = {"a": torch.full((16, 8), 7.0, dtype=torch.float64),
            "nested": {"b": torch.zeros(10, dtype=torch.int32), "c": torch.zeros(3, dtype=torch.bfloat16)}}
    old = {p: x.clone() for p, x in flatten_with_paths(like)}
    out, _ = restore_pytree(like, tmp_path)
    again, _ = restore_pytree(like, tmp_path)
    for (p, got), (_, want), (_, target), (_, other) in zip(flatten_with_paths(out), flatten_with_paths(t),
                                                             flatten_with_paths(like), flatten_with_paths(again)):
        assert got.dtype == target.dtype and torch.equal(got, want.to(target.dtype)), p
        assert got.data_ptr() not in (target.data_ptr(), other.data_ptr()), p
        assert torch.equal(target, old[p]) and torch.equal(other, got), p


def test_train_state_round_trip(tmp_path):
    """A whole fp8 ``TrainState``: the NamedTuples' fields name the paths,
    ``compress_residual`` (None) holds no leaf, and the restore rebuilds
    the same NamedTuples."""
    cfg = reduce_for_smoke(get_config("olmo-1b"))
    run = RunConfig(arch="olmo-1b", precision=PrecisionConfig(fp8=True))
    state = init_train_state(cfg, run, 0, device="cpu")
    save_pytree(state, tmp_path, step=0)
    paths = [p for p, _ in flatten_with_paths(state)]
    assert "opt/step" in paths and "fp8/scale/attn_q/x" in paths and "params/blocks/1/mlp/w_down" in paths
    assert not any(p.startswith("compress_residual") for p in paths)
    fresh = init_train_state(cfg, run, 1, device="cpu")
    out, _ = restore_pytree(fresh, tmp_path)
    assert type(out) is type(state) and type(out.opt) is type(state.opt) and type(out.fp8) is type(state.fp8)
    assert out.compress_residual is None and leaves_equal(out, state)
    assert checkpoint_bytes(state) == sum(x.numel() * x.element_size() for _, x in flatten_with_paths(state))
