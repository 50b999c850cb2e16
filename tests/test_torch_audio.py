"""The port's audio family (hubert-xlarge) against the JAX package's, on the
CPU at smoke size.

* The embedding: ``frames @ frame_proj`` plus the learned ``pos[:S]``
  against the JAX ``embed_input`` on bridged weights, whatever positions
  the batch holds, fp32 to 1e-6.
* ``forward``'s logits, fp32 compute, to 1e-4: the port's ``"torch"`` and
  ``"flash"`` (K3's plain version here) attention against the JAX
  package's ``"xla"``, bidirectional.
* The label rule on shared frames: ``data.audio_labels`` of the frames of a
  JAX synthetic batch equals that batch's labels exactly; the port's own
  batches are deterministic in (seed, step) and follow the rule.
* Three train steps from one bridged mid-training state
  (``torch_parity.compare_train_steps``): fp32 (tight), bf16 and fp8.
* The launcher trains smoke hubert-xlarge with fp8.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import batches, bridged, compare_train_steps, configs, to_jax, to_torch

from repro.data.synthetic import synthetic_batch as jax_synthetic_batch
from repro.models import forward as jax_forward
from repro.models.model import embed_input as jax_embed_input
from repro_torch.data import audio_labels, synthetic_batch
from repro_torch.models import embed_input, forward

torch.set_num_threads(2)

ARCH = "hubert-xlarge"


def test_config_and_parameters():
    from repro.configs import get_config as jax_get_config
    from repro_torch.configs import get_config
    from repro_torch.models import param_specs

    assert dataclasses.asdict(get_config(ARCH)) == dataclasses.asdict(jax_get_config(ARCH))  # a copy
    jcfg, tcfg = configs(ARCH)
    _, tparams = bridged(jcfg, tcfg)
    specs = param_specs(tcfg)
    assert set(specs["embed"]) == {"frame_proj", "pos"} and "lm_head" in specs  # no token table, untied head
    assert tparams["embed"]["frame_proj"].shape == (tcfg.d_model, tcfg.d_model)
    assert tparams["embed"]["pos"].shape == (tcfg.max_position, tcfg.d_model)


def test_embedding_matches_jax():
    jcfg, tcfg = configs(ARCH)
    jparams, tparams = bridged(jcfg, tcfg)
    frames = np.random.default_rng(3).standard_normal((2, 24, jcfg.d_model)).astype(np.float32)
    shifted = np.broadcast_to(np.arange(24, dtype=np.int32) + 5, (2, 24))  # positions do not move pos[:S]
    ref, _ = jax_embed_input(jcfg, jparams, {"frames": jnp.asarray(frames), "positions": jnp.asarray(shifted)})
    got = embed_input(tcfg, tparams, torch.from_numpy(frames), torch.from_numpy(np.array(shifted)))
    assert float(np.abs(got.numpy() - np.asarray(ref)).max()) < 1e-6


@pytest.mark.parametrize("impl", ["torch", "flash"])
def test_forward_logits_match_jax(impl):
    jcfg, tcfg = configs(ARCH)
    assert not tcfg.causal
    jparams, tparams = bridged(jcfg, tcfg)
    batch = batches(jcfg, 1, seed=2, batch=2)[0]
    ref, raux = jax_forward(jcfg, jparams, to_jax({"frames": batch["frames"]}), attn_impl="xla",
                            compute_dtype=jnp.float32)
    with torch.no_grad():
        got, aux = forward(tcfg, tparams, to_torch(batch), attn_impl=impl, compute_dtype=torch.float32)
    assert got.shape == ref.shape == (2, 32, tcfg.padded_vocab) and float(aux) == float(raux) == 0.0
    assert float(np.abs(got.numpy() - np.asarray(ref)).max()) < 1e-4  # fp32: sums in another order


def test_label_rule_on_shared_frames():
    jcfg, tcfg = configs(ARCH)
    jb = jax_synthetic_batch(jcfg, step=3, global_batch=2, seq_len=40, seed=1)
    frames = torch.from_numpy(np.array(jb["frames"]))
    labels = audio_labels(frames, tcfg.vocab_size)
    assert labels.dtype == torch.int32 and np.array_equal(labels.numpy(), np.asarray(jb["labels"]))
    a = synthetic_batch(tcfg, step=3, global_batch=2, seq_len=40, seed=1, device="cpu")
    b = synthetic_batch(tcfg, step=3, global_batch=2, seq_len=40, seed=1, device="cpu")
    c = synthetic_batch(tcfg, step=4, global_batch=2, seq_len=40, seed=1, device="cpu")
    assert set(a) == {"frames", "labels"} and a["frames"].shape == (2, 40, tcfg.d_model)
    assert torch.equal(a["frames"], b["frames"]) and not torch.equal(a["frames"], c["frames"])
    assert torch.equal(a["labels"], audio_labels(a["frames"], tcfg.vocab_size))
    assert abs(float(a["frames"].mean())) < 0.05 and abs(float(a["frames"].std()) - 1.0) < 0.05


@pytest.mark.parametrize(
    "prec,tight",
    [({"compute_dtype": "float32"}, True), ({}, False), ({"fp8": True, "fp8_gemm": "pallas"}, False)],
    ids=["fp32", "bf16", "fp8"],
)
def test_train_steps_match_jax(prec, tight):
    jcfg, tcfg = configs(ARCH)
    compare_train_steps(ARCH, jcfg, tcfg, prec, tight)


def test_launcher_trains_hubert(capsys, tmp_path):
    from repro_torch.launch.train import main

    records = main(["--device", "cpu", "--arch", ARCH, "--steps", "2", "--batch", "2", "--seq", "16", "--fp8",
                    "--microbatches", "2", "--ckpt-dir", str(tmp_path)])
    assert [r["step"] for r in records] == [0, 1]
    assert all(np.isfinite(r["loss"]) and r["aux_loss"] == 0.0 for r in records)
    out = capsys.readouterr().out
    assert "family=audio" in out and "fp8: ON" in out and "aux_loss 0" in out
