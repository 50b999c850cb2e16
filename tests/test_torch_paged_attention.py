"""Paged attention of the PyTorch port against the JAX package.

The port's plain K1/K2 versions (``repro_torch.kernels.paged_attention_ref``)
are held against the JAX oracle (``repro.kernels.paged_attention_ref``) and
the Pallas kernels in interpret mode, on the same inputs made from a numpy
seed, with bf16-representable pools, null-padded tables and ragged
lengths.  Tolerance 2e-5 absolute in fp32: the functions are the same, the
sums run in another order.

K2's tensor-core route (bf16 pools) splits fp32 queries into two bf16
terms and P into two, and sums P V per 64-key tile in fp32:
``paged_prefill_attention_split`` emulates those roundings here and is held
to the card's limit against the Pallas kernel; q in one bf16 term must
miss it.

K1 on the card splits each (sequence, kv head)'s live positions over the
blocks of a cluster and the warps of each block and combines the shares'
softmax sums: ``paged_attention_split_walk`` emulates that walk, empty
shares included, and is held against the Pallas K1 for every cluster size
of 1 to 8.

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
from repro_torch.kernels.paged_attention_ref import (
    paged_attention_plain,
    paged_attention_split_walk,
    paged_prefill_attention_plain,
    paged_prefill_attention_split,
)

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
    assert K.LAUNCHES == {"paged_decode": 0, "paged_decode_cuda_cores": 0, "paged_prefill": 0,
                          "paged_prefill_cuda_cores": 0}


# chip_smoke.py's K2 cases for fp32 queries: name, (H, KV, hd), C, start,
# window, softcap; block size 32, a 16-entry table
SPLIT_CASES = [
    ("olmo-1b", (16, 16, 128), 128, 192, 0, 0.0),
    ("gqa-32/8-window-32", (32, 8, 128), 128, 192, 32, 0.0),
    ("gemma-7b-softcap-30", (16, 16, 256), 128, 192, 0, 30.0),
    ("olmo-1b-C40@200", (16, 16, 128), 40, 200, 0, 0.0),
]
CARD_TOL_FP32 = 1e-4  # chip_smoke.py's TOL for fp32 queries


@pytest.mark.parametrize("case", SPLIT_CASES, ids=[c[0] for c in SPLIT_CASES])
def test_split_q_route_meets_the_card_limits(case):
    """The tensor-core route's roundings (q and P as two bf16 terms each,
    P V per 64-key tile) stay within the card's limit of the Pallas K2; q
    in one bf16 term misses it."""
    _, (H, KV_, hd), C, start, window, softcap = case
    rng = np.random.default_rng(hd + C + window)
    bs, nb = 32, 16
    N = 1 + nb + 2
    q = rng.standard_normal((1, C, H, hd)).astype(np.float32)
    kp = _bf16_round(rng.standard_normal((N, bs, KV_, hd)).astype(np.float32))
    vp = _bf16_round(rng.standard_normal((N, bs, KV_, hd)).astype(np.float32))
    tbl = (rng.permutation(N - 1)[:nb] + 1).reshape(1, nb).astype(np.int32)
    tbl[0, (start + C - 1) // bs + 1 :] = 0
    st = np.array([start], np.int32)
    ref = np.asarray(paged_prefill_attention_bhd(*[jnp.asarray(a) for a in (q, kp, vp, tbl, st)],
                                                 softcap=softcap, window=window, interpret=True))
    args = [torch.from_numpy(a) for a in (q, kp, vp, tbl, st)]

    def err(q_terms):
        out = paged_prefill_attention_split(*args, q_terms=q_terms, p_terms=2, softcap=softcap, window=window)
        return float(np.max(np.abs(out.numpy() - ref)))

    assert err(2) < CARD_TOL_FP32
    assert err(1) > CARD_TOL_FP32


@pytest.mark.parametrize("q_dtype", [torch.float32, torch.bfloat16])
def test_routes_follow_the_pool_dtype(q_dtype):
    """bf16 pools run the tensor-core kernel, fp32 pools v1, whatever the
    query dtype; other dtypes are refused; K1 runs fp32 on the CUDA cores
    (its split kernel) on every dtype."""
    assert K.prefill_route(q_dtype, torch.bfloat16) == K.ROUTES[torch.bfloat16] == "tensor_cores_bf16"
    assert K.prefill_route(q_dtype, torch.float32) == K.ROUTES[torch.float32] == "cuda_cores_fp32"
    with pytest.raises(TypeError):
        K.prefill_route(q_dtype, torch.float16)
    with pytest.raises(TypeError):
        K.prefill_route(torch.float16, torch.bfloat16)
    assert K.DECODE_ROUTE == "cuda_cores_fp32"


def test_split_terms_are_exact_where_the_inputs_are_bf16():
    """With bf16 queries one q term carries q exactly, so one term and two
    agree; with P in two terms the route matches the plain version far
    inside the card's limit."""
    H, hd = 4, 16
    start = np.array([3, 11], np.int32)
    q, kp, vp, tbl = _inputs(9, H, hd, (B, 5, H, hd), start + 4)
    args = [torch.from_numpy(a) for a in (_bf16_round(q), kp, vp, tbl, start)]
    one = paged_prefill_attention_split(*args, q_terms=1, p_terms=2, window=8)
    two = paged_prefill_attention_split(*args, q_terms=2, p_terms=2, window=8)
    assert torch.equal(one, two)
    plain = paged_prefill_attention_plain(*args, window=8)
    assert float((two - plain).abs().max()) < CARD_TOL_FP32 / 10


# K1's split walk: lengths (a length of 1, one that fills a table block,
# ragged ones), a window shorter than the shares, a softcap; GQA qpk 1 and 4
SPLIT_WALK_CASES = [
    (qpk, window, softcap, lens)
    for qpk in (1, 4)
    for window, softcap in ((0, 0.0), (5, 0.0), (0, 30.0))
    for lens in ((13, 27), (1, 32), (1, 1))
]
# hymba-1.5b's five query rows per kv head (an odd share of K1's rows of 8),
# with and without a window the lengths outrun
SPLIT_WALK_CASES += [(5, window, 0.0, lens) for window in (0, 5) for lens in ((13, 27), (1, 32))]


@pytest.mark.parametrize("qpk,window,softcap,lens", SPLIT_WALK_CASES)
def test_split_walk_matches_pallas(qpk, window, softcap, lens):
    """Every cluster size 1 to 8 (4 warps a block) gives the Pallas K1's
    output; at length 1 all shares but one are empty."""
    H, hd = KV * qpk, 16
    lens = np.array(lens, np.int32)
    q, kp, vp, tbl = _inputs(qpk * 10 + window + int(lens[0]), H, hd, (B, H, hd), lens - 1)
    ref = paged_attention_bhd(*[jnp.asarray(a) for a in (q, kp, vp, tbl, lens)], softcap=softcap, window=window,
                              interpret=True)
    args = [torch.from_numpy(a) for a in (q, kp, vp, tbl, lens)]
    for splits in range(1, 9):
        out = paged_attention_split_walk(*args, splits=splits, softcap=softcap, window=window)
        assert bool(torch.isfinite(out).all())
        _close(out, ref, f"{splits} blocks")


def test_decode_yardstick_is_card_only():
    """K1's v1 runs only on the card, as the yardstick of the split kernel."""
    lens = np.array([9, 30], np.int32)
    q, kp, vp, tbl = _inputs(11, 4, 16, (B, 4, 16), lens - 1)
    with pytest.raises(ValueError, match="runs on cuda"):
        K.paged_attention_cuda_cores(*[torch.from_numpy(a) for a in (q, kp, vp, tbl, lens)])
