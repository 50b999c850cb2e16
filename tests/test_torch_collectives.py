"""The port's collectives module against the JAX package's
``parallel/collectives.py``.

* ``compress_gradients``: bf16 truncation and int8 with error feedback,
  chained over three rounds on the same seeded trees (the residual of one
  round feeds the next): the port's compressed gradients and residuals
  equal the JAX package's bit for bit (``_quantize_int8`` divides by the
  scale and rounds half to even, as ``jnp.round`` does; a tie case checks
  the rounding).
* ``init_compression_state``, ``compression_ratio`` and
  ``CollectiveModel`` equal the JAX package's.
* The smoke olmo-1b train step with ``grad_compression`` ``"bf16"`` and
  ``"int8"`` against the JAX train step from one bridged state, the
  residual bridged with it (``torch_parity.compare_train_steps``: bf16
  compute, so the train tests' bf16 tolerances), and the residual after
  the steps close to the JAX package's.
* The serving primitives ``all_reduce`` / ``all_gather`` on a two-rank gloo
  mesh, with their counters; the data-axis pair of sharded moe training,
  ``sum_over_data`` (a sum both ways) and ``exchange_counts`` (int32
  counts in data-rank order), on a ``(2, 1)`` mesh, with theirs.
* ``run_ranks`` returns a large state: 200 fp32 tensors of (256, 1024)
  from each of two ranks, exactly, in three calls in a row (a rank's
  result crosses by value, so the parent reads it after the rank exits).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.parallel import collectives as J
from repro_torch.launch.mesh import run_ranks
from repro_torch.parallel import collectives as T
from repro_torch.utils.tree import tree_leaves

import torch_parity
import torch_sharded_ranks
import torch_tp_ranks

torch.set_num_threads(2)


def _trees(seed, scale=1.0):
    rng = np.random.default_rng(seed)
    shapes = {"a": (7, 5), "b": {"c": (64,), "d": (3, 4, 2)}, "e": (1,)}

    def make(s):
        if isinstance(s, dict):
            return {k: make(v) for k, v in s.items()}
        return (rng.standard_normal(s) * scale).astype(np.float32)

    return make(shapes)


def _np_leaves(tree):
    return [np.asarray(x) for x in jax.tree.leaves(tree)]


@pytest.mark.parametrize("method", ["none", "bf16", "int8"])
def test_compress_gradients_equals_jax(method):
    grads = [_trees(s, scale=10.0 ** (s - 1)) for s in range(3)]
    jres = J.init_compression_state(grads[0], method)
    tres = T.init_compression_state({k: v for k, v in jax.tree.map(torch.from_numpy, grads[0]).items()}, method)
    if method == "none":
        assert jres is None and tres is None
    for g in grads:
        jg, jres = J.compress_gradients(jax.tree.map(jnp.asarray, g), jres, method)
        tg, tres = T.compress_gradients(jax.tree.map(torch.from_numpy, g), tres, method)
        for a, b in zip(_np_leaves(jg), [t.numpy() for t in tree_leaves(tg)]):
            np.testing.assert_array_equal(a, b)
        if method != "none":
            for a, b in zip(_np_leaves(jres), [t.numpy() for t in tree_leaves(tres)]):
                np.testing.assert_array_equal(a, b)
            assert any(np.abs(x).max() > 0 for x in _np_leaves(jres))


def test_int8_rounds_half_to_even():
    # max |g| = 127 makes the scale 1: 0.5 and 2.5 are ties
    g = np.array([127.0, 0.5, 1.5, 2.5, -0.5, -2.5, 3.0], np.float32)
    jq, js = J._quantize_int8(jnp.asarray(g))
    tq, ts = T._quantize_int8(torch.from_numpy(g))
    np.testing.assert_array_equal(np.asarray(jq), tq.numpy())
    assert tq.tolist() == [127, 0, 2, 2, 0, -2, 3] and float(ts) == float(js) == 1.0
    with pytest.raises(ValueError, match="grad_compression"):
        T.compress_gradients({"a": torch.ones(2)}, {"a": torch.zeros(2)}, "fp4")


def test_cost_model_and_ratio_equal_jax():
    for m in ("none", "bf16", "int8"):
        assert T.compression_ratio(m) == J.compression_ratio(m)
    jm, tm = J.CollectiveModel(), T.CollectiveModel()
    assert tm.link_bw == jm.link_bw
    for n in (1, 2, 4, 16, 256):
        for b in (0.0, 1.0, 3.5e9):
            for op in ("all_reduce", "all_gather", "reduce_scatter", "all_to_all"):
                assert getattr(tm, op)(b, n) == getattr(jm, op)(b, n), (op, b, n)
    assert tm.time(1e9) == jm.time(1e9)


@pytest.mark.parametrize("method", ["bf16", "int8"])
def test_compressed_train_steps_match_jax(method):
    jcfg, tcfg = torch_parity.configs("olmo-1b")
    tstate, jstate = torch_parity.compare_train_steps("olmo-1b", jcfg, tcfg, {}, False, grad_compression=method)
    got = torch.cat([t.flatten() for t in tree_leaves(tstate.compress_residual)])
    ref = torch.from_numpy(np.concatenate([np.asarray(x).ravel() for x in jax.tree.leaves(jstate.compress_residual)]))
    assert got.shape == ref.shape and float(got.abs().max()) > 0
    # the residuals of bf16-compute gradients: equal norms within 10%
    assert float(got.norm()) == pytest.approx(float(ref.norm()), rel=0.1)


def test_serving_primitives_on_two_ranks():
    """The primitives and the meshes of ``launch.mesh`` on two gloo ranks:
    the serving mesh (1, 2), a local (2, 1) mesh, two one-rank replica
    meshes, each rank in its own."""
    results = run_ranks(torch_tp_ranks.primitives, 2, device="cpu", timeout_s=120)
    for rank, (same, summed, gathered, counts, shapes) in enumerate(results):
        assert same and summed == [[0.0, 3.0, 6.0], [9.0, 12.0, 15.0]]
        assert gathered == [[0.0, 1.0], [0.0, 1.0]]
        assert counts == {"all_reduce": 1, "all_reduce_bytes": 24, "all_gather": 1, "all_gather_bytes": 8}
        assert shapes["serving"] == (("data", "model"), (1, 2)) and shapes["local_2x1"] == (2, 1)
        assert [r for r, _ in shapes["replicas"]] == [[0], [1]]
        assert [c is not None for _, c in shapes["replicas"]] == [rank == 0, rank == 1]


def test_data_axis_pair_on_two_ranks():
    """On a (2, 1) mesh: ``sum_over_data`` of rank r's (r + 1) * x is 3 x on
    both ranks and its backward sums the ranks' upstream gradients (rank r
    sends r + 1: 3 on both); ``exchange_counts`` stacks both ranks' counts
    in rank order; one count a call, the backward's too."""
    results = run_ranks(torch_sharded_ranks.data_primitives, (2, 1), device="cpu", timeout_s=120)
    for rank, r in enumerate(results):
        assert r["sum"] == [3.0, 6.0] and r["grad"] == [3.0, 3.0]
        assert r["counts"] == [[[1, 0], [0, 1]], [[2, 0], [0, 2]]] and r["counts_dtype"] == "torch.int32"
        assert r["collectives"] == {"sum_over_data": 2, "sum_over_data_bytes": 16, "exchange_counts": 1,
                                    "exchange_counts_bytes": 16}


def test_run_ranks_returns_a_large_state():
    n, shape = 200, (256, 1024)
    expected = {r: torch_sharded_ranks.large_state(r, None, n, shape) for r in range(2)}
    for _ in range(3):
        got = run_ranks(torch_sharded_ranks.large_state, 2, device="cpu", timeout_s=300, args=(n, shape))
        for rank, tensors in enumerate(got):
            assert len(tensors) == n
            assert all(t.dtype == torch.float32 and torch.equal(t, e) for t, e in zip(tensors, expected[rank]))


def test_backend_rules():
    """gloo on the CPU; NCCL named for the CPU, an unknown backend, a bad
    degree or a replica count below 1 raise before any rank starts."""
    from repro_torch.launch.mesh import make_replica_meshes, make_serving_mesh, pick_backend

    assert pick_backend(2, device="cpu") == pick_backend(2, "gloo", device="cpu") == "gloo"
    with pytest.raises(ValueError, match="nccl"):
        pick_backend(2, "nccl", device="cpu")
    with pytest.raises(ValueError, match="backend"):
        pick_backend(2, "mpi", device="cpu")
    with pytest.raises(ValueError, match="tp=0"):
        make_serving_mesh(0, device="cpu")
    with pytest.raises(ValueError, match="replicas=0"):
        make_replica_meshes(0, 1, device="cpu")
    with pytest.raises(RuntimeError, match="process group"):
        make_serving_mesh(2, device="cpu")
