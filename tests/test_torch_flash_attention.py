"""The port's flash-attention forward (K3) against the JAX package's, on the
CPU.

``flash_attention_plain`` and the port's model-layout wrapper (which takes
the plain version for CPU tensors) against the Pallas ``flash_attention``
in interpret mode, over the cases of ``tests/test_kernels.py``'s
``FLASH_CASES``, with that test's tolerances: 2e-5 in fp32 (the same
softmax, sums in another order) and 2e-2 in bf16 (both round the output
to bf16, one ulp of 2^-7 relative on outputs below 4).  K3 has no
gradient in the JAX package; the wrapper refuses to differentiate.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import flash_attention as jax_flash_attention
from repro.kernels.flash_attention_ref import attention_ref
from repro_torch.kernels.flash_attention import flash_attention, flash_attention_bhsd
from repro_torch.kernels.flash_attention_ref import flash_attention_plain

torch.set_num_threads(2)

FLASH_CASES = [  # the cases of tests/test_kernels.py
    # B, Sq, Skv, H, KV, hd, causal, window, softcap, dtype
    (2, 256, 256, 4, 2, 64, True, 0, 0.0, "float32"),
    (1, 128, 128, 4, 4, 32, True, 0, 0.0, "bfloat16"),
    (2, 256, 256, 8, 2, 64, True, 64, 0.0, "float32"),  # sliding window
    (1, 256, 256, 2, 2, 128, True, 0, 30.0, "float32"),  # gemma softcap
    (1, 128, 128, 4, 2, 256, False, 0, 0.0, "float32"),  # encoder, hd=256
    (1, 384, 384, 2, 1, 64, True, 0, 0.0, "float32"),  # MQA, 3 blocks
]


def _inputs(case, seed=0):
    B, Sq, Skv, H, KV, hd, *_ = case
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32) for s in ((B, Sq, H, hd), (B, Skv, KV, hd), (B, Skv, KV, hd))]


@pytest.mark.parametrize("case", FLASH_CASES)
def test_flash_plain_matches_pallas(case):
    causal, win, cap, dt = case[6:]
    q, k, v = _inputs(case)
    kw = dict(causal=causal, window=win, softcap=cap)
    ref = np.asarray(jax_flash_attention(*(jnp.asarray(x, getattr(jnp, dt)) for x in (q, k, v)), **kw), np.float32)
    tq, tk, tv = (torch.from_numpy(x).to(getattr(torch, dt)) for x in (q, k, v))
    got = flash_attention_plain(tq.transpose(1, 2), tk.transpose(1, 2), tv.transpose(1, 2), **kw).transpose(1, 2)
    wrapped = flash_attention(tq, tk, tv, **kw)  # model layout, plain on the CPU
    assert got.dtype == tq.dtype and got.shape == tq.shape
    tol = 2e-2 if dt == "bfloat16" else 2e-5
    assert float(np.abs(got.float().numpy() - ref).max()) < tol
    assert torch.equal(wrapped, got)
    if dt == "float32":  # and the plain version is the JAX oracle's function
        oracle = attention_ref(*(jnp.asarray(x).transpose(0, 2, 1, 3) for x in (q, k, v)), **kw)
        np.testing.assert_allclose(got.numpy(), np.asarray(oracle).transpose(0, 2, 1, 3), rtol=0, atol=2e-5)


def test_flash_refuses_gradients():
    q, k, v = (torch.from_numpy(x).transpose(1, 2) for x in _inputs(FLASH_CASES[0]))
    q.requires_grad_(True)
    with pytest.raises(RuntimeError, match="forward only"):
        flash_attention_bhsd(q, k, v)
    with pytest.raises(RuntimeError, match="forward only"):
        flash_attention(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2))
    with torch.no_grad():
        out = flash_attention_bhsd(q, k, v)
    assert not out.requires_grad and bool(torch.isfinite(out).all())
