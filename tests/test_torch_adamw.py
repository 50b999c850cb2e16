"""The port's AdamW runs each leaf in slices along its first dimension.

The slices must not change the arithmetic: a run with a slice of a few
elements equals, bit for bit, a run with one slice per leaf, under a clip
that binds, with bf16 gradients, block leaves under weight decay and a
leaf that is not contiguous.  On the card (``-m gpu``) the same holds at
the size of a qwen3-moe expert stack, which spans two slices of the
default ``CHUNK``.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from repro_torch.optim import adamw
from repro_torch.optim.adamw import adamw_init, adamw_update

torch.set_num_threads(2)


def _tree(rng, transposed: bool):
    def t(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(np.float32))

    w = t(9, 13)
    return {
        "embed": t(11, 7),
        "blocks": [{"w": w.t() if transposed else w, "scale": t(13), "e": t(3, 5, 6)} for _ in range(2)],
        "final_norm": t(7),
        "bias": t(),
    }


def _grads(rng, params, dtype):
    from repro_torch.utils.tree import tree_map

    return tree_map(lambda p: torch.from_numpy(rng.standard_normal(p.shape).astype(np.float32)).to(dtype), params)


def _run(monkeypatch, chunk: int, transposed: bool, grad_dtype, grad_clip: float):
    monkeypatch.setattr(adamw, "CHUNK", chunk)
    rng = np.random.default_rng(7)
    params = _tree(rng, transposed)
    state = adamw_init(params)
    metrics = {}
    for _ in range(3):
        grads = _grads(rng, params, grad_dtype)
        params, state, metrics = adamw_update(params, grads, state, lr=1e-2, weight_decay=0.1, grad_clip=grad_clip)
    return params, state, metrics


@pytest.mark.parametrize("transposed", [False, True], ids=["contiguous", "transposed"])
@pytest.mark.parametrize("grad_dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("chunk", [1, 37])
def test_sliced_update_equals_one_pass(monkeypatch, chunk, grad_dtype, transposed):
    from repro_torch.utils.tree import tree_leaves

    one = _run(monkeypatch, 1 << 26, transposed, grad_dtype, grad_clip=1.0)
    sliced = _run(monkeypatch, chunk, transposed, grad_dtype, grad_clip=1.0)
    assert float(one[2]["grad_norm"]) > 1.0  # the clip binds
    assert float(one[2]["grad_norm"]) == float(sliced[2]["grad_norm"])
    for a_tree, b_tree in [(one[0], sliced[0]), (one[1].m, sliced[1].m), (one[1].v, sliced[1].v)]:
        for a, b in zip(tree_leaves(a_tree), tree_leaves(b_tree)):
            assert torch.equal(a, b)
    assert sliced[0]["blocks"][0]["w"].is_contiguous() is not transposed  # updated where it lies


def test_slices_cover_each_leaf_once(monkeypatch):
    monkeypatch.setattr(adamw, "CHUNK", 37)
    for shape in [(), (5,), (100,), (9, 13), (3, 5, 6), (2, 50)]:
        t = torch.arange(int(np.prod(shape)), dtype=torch.float32).reshape(shape)
        parts = adamw.row_slices(t)
        assert torch.equal(torch.cat([p.reshape(-1) for p in parts]), t.reshape(-1))
        assert all(p.numel() <= max(37, t[0].numel() if t.dim() else 1) for p in parts)
        assert len(parts) > 1 or t.numel() <= 37 or (t.dim() and t[0].numel() > 18)


@pytest.mark.gpu
def test_sliced_update_equals_one_pass_on_the_card(monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    g = torch.Generator(device="cuda").manual_seed(0)

    def run(chunk):
        monkeypatch.setattr(adamw, "CHUNK", chunk)
        g.manual_seed(0)
        experts = torch.randn(16, 4096, 1536, generator=g, device="cuda")  # 100.7 M elements: 10 + 6 experts
        params = {"embed": torch.randn(1536, 4096, generator=g, device="cuda").t(),  # not contiguous
                  "blocks": [{"moe": {"w_up": experts}, "norm": torch.randn(4096, generator=g, device="cuda")}]}
        state = adamw_init(params)
        for _ in range(2):
            grads = {"embed": torch.randn(4096, 1536, generator=g, device="cuda").bfloat16(),
                     "blocks": [{"moe": {"w_up": torch.randn(16, 4096, 1536, generator=g, device="cuda").bfloat16()},
                                 "norm": torch.randn(4096, generator=g, device="cuda").bfloat16()}]}
            params, state, metrics = adamw_update(params, grads, state, lr=1e-2, weight_decay=0.1, grad_clip=1.0)
        return params, state, metrics

    from repro_torch.utils.tree import tree_leaves

    sliced = run(1 << 26)
    assert len(adamw.row_slices(sliced[0]["blocks"][0]["moe"]["w_up"])) == 2
    one = run(1 << 40)
    assert float(one[2]["grad_norm"]) > 1.0
    for a_tree, b_tree in [(one[0], sliced[0]), (one[1].m, sliced[1].m), (one[1].v, sliced[1].v)]:
        for a, b in zip(tree_leaves(a_tree), tree_leaves(b_tree)):
            assert torch.equal(a, b)
