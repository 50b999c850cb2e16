"""``chip_smoke.py``'s train-path gate reads a train step without taking it.

``step_readings`` goes through the train step's own ``grads_of`` and
``lr_schedule`` and AdamW's clip and update, applied to clones of the
picked tensors only.  On the CPU, at smoke size, its readings equal the
step that ``make_train_step`` takes from the same state bit for bit, for
each family the gate runs on, and it leaves the state as it was.
"""

from __future__ import annotations

import importlib.util
import pathlib

import pytest
import torch

from repro_torch.config import reduce_for_smoke
from repro_torch.configs import get_config
from repro_torch.data import make_batch_fn
from repro_torch.train import init_train_state, make_train_step
from repro_torch.utils.tree import tree_leaves

torch.set_num_threads(2)

ROOT = pathlib.Path(__file__).resolve().parents[1]


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("arch", ["olmo-1b", "qwen3-moe-235b-a22b", "hymba-1.5b", "hubert-xlarge"])
def test_step_readings_equal_the_train_step(arch):
    cs = _chip_smoke()
    cfg = reduce_for_smoke(get_config(arch))
    run = cs.train_run_config("kernel", arch, 2)
    state = init_train_state(cfg, run, 0, "cpu")
    batch_fn = make_batch_fn(cfg, global_batch=2, seq_len=64, seed=0, device="cpu")
    step = make_train_step(cfg, run)
    for i in range(3):  # past the warmup's first step, so the update moves the parameters
        state, _ = step(state, batch_fn(i))
    batch = batch_fn(3)
    held = lambda: [t for tree in (state.params, state.opt.m, state.opt.v) for t in tree_leaves(tree)]  # noqa: E731
    before = [t.clone() for t in held()]
    picks = cs.gate_picks(cfg)

    r = cs.step_readings(cfg, run, state, batch, picks)

    assert all(torch.equal(a, b) for a, b in zip(before, held()))
    new, m = step(state, batch)
    assert r["lr"] > 0
    for key in ("loss", "aux_loss", "grad_norm", "lr"):
        assert r[key] == float(m[key]), key
    for name, path in picks.items():
        assert torch.equal(r["params"][name], cs.leaf_at(new.params, path)), name
