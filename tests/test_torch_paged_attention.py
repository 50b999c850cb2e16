"""Paged attention of the PyTorch port against the JAX package.

The port's plain K1/K2 versions (``repro_torch.kernels.paged_attention_ref``)
are held against the JAX oracle (``repro.kernels.paged_attention_ref``) and
the Pallas kernels in interpret mode, on the same inputs made from a numpy
seed, with bf16-representable pools, null-padded tables and ragged
lengths.  Tolerance 2e-5 absolute in fp32: the functions are the same, the
sums run in another order.

``test_torch_cuda_kernels.py`` holds the CUDA kernels against the plain
versions on the card.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.paged_attention import paged_attention_bhd, paged_prefill_attention_bhd
from repro.kernels.paged_attention_ref import paged_attention_ref, paged_prefill_attention_ref
from repro_torch.kernels import paged_attention as K
from repro_torch.kernels.paged_attention_ref import paged_attention_plain, paged_prefill_attention_plain

torch.set_num_threads(2)

ATOL = 2e-5
B, KV, BS, NB = 2, 2, 8, 4
CASES = [
    (qpk, window, softcap, hd)
    for qpk in (1, 2, 4)
    for window in (0, 8)
    for softcap in (0.0, 30.0)
    for hd in (16, 128)
]


def _bf16_round(a: np.ndarray) -> np.ndarray:
    return torch.from_numpy(a).bfloat16().float().numpy()


def _inputs(seed, H, hd, q_shape, last_pos):
    """Pools, and tables whose blocks past each sequence's ``last_pos``
    are the null block 0."""
    rng = np.random.default_rng(seed)
    N = 1 + B * NB + 3
    q = rng.standard_normal(q_shape).astype(np.float32)
    kp = _bf16_round(rng.standard_normal((N, BS, KV, hd)).astype(np.float32))
    vp = _bf16_round(rng.standard_normal((N, BS, KV, hd)).astype(np.float32))
    perm = rng.permutation(N - 1)[: B * NB] + 1
    tbl = perm.reshape(B, NB).astype(np.int32)
    for b in range(B):
        tbl[b, last_pos[b] // BS + 1 :] = 0
    return q, kp, vp, tbl


def _close(port: torch.Tensor, ref, what: str) -> None:
    err = float(np.max(np.abs(port.numpy() - np.asarray(ref, np.float32))))
    assert err < ATOL, f"{what}: max abs err {err}"


@pytest.mark.parametrize("qpk,window,softcap,hd", CASES)
def test_decode_plain_matches_jax(qpk, window, softcap, hd):
    H = KV * qpk
    lens = np.array([13, 27], np.int32)
    q, kp, vp, tbl = _inputs(qpk * 100 + hd, H, hd, (B, H, hd), lens - 1)
    port = paged_attention_plain(
        torch.from_numpy(q), torch.from_numpy(kp), torch.from_numpy(vp),
        torch.from_numpy(tbl), torch.from_numpy(lens), softcap=softcap, window=window,
    )
    jargs = [jnp.asarray(a) for a in (q, kp, vp, tbl, lens)]
    _close(port, paged_attention_ref(*jargs, softcap=softcap, window=window), "vs jnp oracle")
    _close(port, paged_attention_bhd(*jargs, softcap=softcap, window=window, interpret=True), "vs Pallas")


@pytest.mark.parametrize("qpk,window,softcap,hd", CASES)
def test_prefill_plain_matches_jax(qpk, window, softcap, hd):
    H = KV * qpk
    C = 6
    start = np.array([5, 19], np.int32)
    q, kp, vp, tbl = _inputs(qpk * 100 + hd + 1, H, hd, (B, C, H, hd), start + C - 1)
    port = paged_prefill_attention_plain(
        torch.from_numpy(q), torch.from_numpy(kp), torch.from_numpy(vp),
        torch.from_numpy(tbl), torch.from_numpy(start), softcap=softcap, window=window,
    )
    jargs = [jnp.asarray(a) for a in (q, kp, vp, tbl, start)]
    _close(port, paged_prefill_attention_ref(*jargs, softcap=softcap, window=window), "vs jnp oracle")
    _close(port, paged_prefill_attention_bhd(*jargs, softcap=softcap, window=window, interpret=True), "vs Pallas")


def test_wrappers_take_the_plain_version_on_cpu():
    """On CPU tensors the wrappers compute the plain version and count no
    launch."""
    H, hd = 4, 16
    lens = np.array([9, 30], np.int32)
    q, kp, vp, tbl = _inputs(7, H, hd, (B, H, hd), lens - 1)
    args = [torch.from_numpy(a) for a in (q, kp, vp, tbl, lens)]
    K.reset_launches()
    out = K.paged_attention(*args, window=8)
    assert torch.equal(out, paged_attention_plain(*args, window=8))
    start = np.array([3, 11], np.int32)
    q2, kp2, vp2, tbl2 = _inputs(8, H, hd, (B, 5, H, hd), start + 4)
    args2 = [torch.from_numpy(a) for a in (q2, kp2, vp2, tbl2, start)]
    out2 = K.paged_prefill_attention(*args2, softcap=30.0)
    assert torch.equal(out2, paged_prefill_attention_plain(*args2, softcap=30.0))
    assert K.LAUNCHES == {"paged_decode": 0, "paged_prefill": 0}
