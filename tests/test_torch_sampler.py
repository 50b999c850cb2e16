"""The port's sampler: greedy as ``jnp.argmax`` (first index on ties),
temperature and top-k sampling by distribution (a ``torch.Generator``
cannot reproduce ``jax.random``'s bits)."""

import numpy as np
import torch

from repro_torch.serving.sampler import sample_token, sample_tokens

torch.set_num_threads(2)


def test_greedy_rows_take_the_first_maximum():
    logits = torch.tensor([[0.0, 3.0, 3.0, 1.0], [5.0, 5.0, 0.0, 0.0], [1e30, 0.0, 0.0, 0.0]])
    temps = torch.tensor([0.0, 0.0, 0.0])
    out = sample_tokens(logits, temps, torch.zeros(3, dtype=torch.int64), torch.Generator().manual_seed(0))
    assert out.tolist() == np.argmax(logits.numpy(), axis=-1).tolist() == [1, 0, 0]
    assert sample_token(logits[0], 0.0) == 1


def test_top_k_one_is_greedy_and_top_k_masks_the_rest():
    g = torch.Generator().manual_seed(1)
    logits = torch.randn(64, 50, generator=g)
    temps = torch.full((64,), 0.7)
    out = sample_tokens(logits, temps, torch.ones(64, dtype=torch.int64), g)
    assert torch.equal(out, torch.argmax(logits, dim=-1))
    top2 = torch.topk(logits, 2, dim=-1).indices
    out2 = sample_tokens(logits, temps, torch.full((64,), 2, dtype=torch.int64), g)
    assert bool((out2[:, None] == top2).any(dim=-1).all())


def test_temperature_sampling_follows_the_softmax():
    g = torch.Generator().manual_seed(2)
    n = 4000
    logits = torch.tensor([[0.0, float(np.log(3.0)), -1e9]]).expand(n, 3)
    out = sample_tokens(logits, torch.ones(n), torch.zeros(n, dtype=torch.int64), g)
    freq = np.bincount(out.numpy(), minlength=3) / n
    assert freq[2] == 0
    assert abs(freq[1] - 0.75) < 0.03  # 5 standard errors of a 4000-draw mean
    # mixed batch: greedy rows stay greedy beside sampled ones
    mixed = sample_tokens(logits[:4], torch.tensor([0.0, 1.0, 0.0, 1.0]), torch.zeros(4, dtype=torch.int64), g)
    assert mixed[0] == 1 and mixed[2] == 1
