"""The port's data loader and sequence packing against the JAX package's, on the CPU.

One numpy batch function (global step -> global batch) feeds both
packages' ``ShardedLoader``: every host's shard, ``get`` and the
prefetching ``iterate`` (steps in order, shards equal) must agree, and the
port's shards land on the loader's device.  ``pack_sequences`` and
``packing_efficiency`` must return the JAX package's arrays.
"""

import numpy as np
import pytest
import torch

from repro.data import ShardedLoader as JaxLoader
from repro.data import pack_sequences as jax_pack
from repro.data.packing import packing_efficiency as jax_efficiency
from repro_torch.config import reduce_for_smoke
from repro_torch.configs import get_config
from repro_torch.data import ShardedLoader, make_batch_fn, pack_sequences
from repro_torch.data.packing import packing_efficiency

torch.set_num_threads(2)


def numpy_batches(step: int) -> dict:
    rng = np.random.default_rng([7, step])
    tok = rng.integers(0, 256, (8, 16)).astype(np.int32)
    return {"tokens": tok, "labels": np.roll(tok, -1, axis=1), "mask": rng.random((8, 16)).astype(np.float32)}


def as_numpy(batch: dict) -> dict:
    return {k: np.asarray(v) for k, v in batch.items()}


@pytest.mark.parametrize("num_hosts", [1, 2, 4])
def test_host_shards_match_jax(num_hosts):
    for host in range(num_hosts):
        ours = ShardedLoader(numpy_batches, host_id=host, num_hosts=num_hosts, device="cpu")
        ref = JaxLoader(numpy_batches, host_id=host, num_hosts=num_hosts)
        for step in (0, 3):
            got, want = ours.get(step), as_numpy(ref.get(step))
            assert sorted(got) == sorted(want)
            for k in want:
                assert isinstance(got[k], torch.Tensor) and got[k].device.type == "cpu"
                np.testing.assert_array_equal(got[k].numpy(), want[k])
                assert got[k].shape[0] == 8 // num_hosts


def test_iterate_order_matches_jax():
    ours = ShardedLoader(numpy_batches, host_id=1, num_hosts=2, prefetch=2, device="cpu")
    ref = JaxLoader(numpy_batches, host_id=1, num_hosts=2, prefetch=2)
    got = list(ours.iterate(5, 6))
    want = list(ref.iterate(5, 6))
    assert [s for s, _ in got] == [s for s, _ in want] == list(range(5, 11))
    for (_, g), (_, w) in zip(got, want):
        for k, v in as_numpy(w).items():
            np.testing.assert_array_equal(g[k].numpy(), v)
    ours._thread.join(timeout=10)  # the producer ends with the range
    assert not ours._thread.is_alive()


def test_loader_takes_the_batch_functions_tensors():
    """The port's own batch function (tensors already on the device) shards
    without a copy of what stays."""
    cfg = reduce_for_smoke(get_config("olmo-1b"))
    fn = make_batch_fn(cfg, global_batch=4, seq_len=8, seed=1, device="cpu")
    shard = ShardedLoader(fn, host_id=1, num_hosts=2, device="cpu").get(3)
    assert torch.equal(shard["tokens"], fn(3)["tokens"][2:]) and shard["tokens"].dtype == torch.int32


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("seq_len", [16, 64])
def test_pack_sequences_matches_jax(seed, seq_len):
    rng = np.random.default_rng(seed)
    docs = [rng.integers(1, 100, int(n)).astype(np.int32) for n in rng.integers(1, 80, 12)]
    got, want = pack_sequences(docs, seq_len, pad_id=0), jax_pack(docs, seq_len, pad_id=0)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype == np.int32
        np.testing.assert_array_equal(g, w)
    tokens, positions, segments = got
    assert (segments > 0).sum() == sum(min(len(d), seq_len) for d in docs)  # packing conserves tokens
    assert packing_efficiency(segments) == jax_efficiency(segments)
    assert 0 < packing_efficiency(segments) <= 1.0
