"""The autotuner's layouts of K1 and K2 on the card (``-m gpu``; skips on a
host without CUDA).  Needs no JAX:
``python -m pytest -m gpu tests/test_torch_cuda_autotune.py``.

* ``launch_decode`` under ``"prefill1"`` (K2 at C = 1 from ``seq_lens - 1``)
  at every K2 split, and K1 at every forced split, against the plain decode
  (fp32 queries 1e-4, bf16 2e-2), with a window and without.
* The entry point follows the table in its CUDA branch: ``"prefill1"``
  launches K2 in place of K1, the defaults launch K1, a split out of range
  raises where the launch checks it.
* ``tune_case`` on a small shape: every candidate checked and timed, the
  winner one of them.
"""

import json

import pytest
import torch

from repro_torch.kernels import autotune as A
from repro_torch.kernels import paged_attention as K
from repro_torch.kernels.paged_attention_ref import paged_attention_plain

TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
CASES = [(16, 16, 128, 0, torch.float32), (64, 4, 128, 0, torch.bfloat16), (25, 5, 64, 96, torch.float32)]


def _case(H, KV, hd, q_dtype, lens=(1, 37, 150, 300), nb=12, seed=0):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    c = A.build_case("decode", len(lens), nb, 32, H, KV, hd, torch.bfloat16, q_dtype=q_dtype, lens=lens, layers=1,
                     device="cuda", seed=seed)
    return c["q"], c["k"][0], c["v"][0], c["tbl"], c["lens"]


@pytest.mark.gpu
@pytest.mark.parametrize("H,KV,hd,window,q_dtype", CASES)
def test_cuda_tuned_layouts_match_plain(H, KV, hd, window, q_dtype):
    q, kp, vp, tbl, lens = _case(H, KV, hd, q_dtype)
    ref = paged_attention_plain(q, kp, vp, tbl, lens, window=window).float()
    layouts = [{**A.DEFAULT_CONFIG, "decode_split": s} for s in A.DECODE_SPLITS]
    layouts += [{**A.DEFAULT_CONFIG, "decode_kernel": "prefill1", "prefill_split": s} for s in A.PREFILL_SPLITS]
    for tuned in layouts:
        out = K.launch_decode(q, kp, vp, tbl, lens, window=window, tuned=tuned)
        torch.cuda.synchronize()
        assert out.shape == q.shape and out.dtype == q.dtype
        assert float((out.float() - ref).abs().max()) < TOL[q_dtype], tuned


@pytest.mark.gpu
def test_cuda_entry_point_follows_the_table(tmp_path, monkeypatch):
    q, kp, vp, tbl, lens = _case(16, 16, 128, torch.float32)
    key = A.cache_key(128, 32, tbl.shape[1], torch.bfloat16, 1)
    path = tmp_path / "t.json"
    monkeypatch.setenv(A.CACHE_ENV, str(path))
    ref = paged_attention_plain(q, kp, vp, tbl, lens)
    try:
        for entry, launched in ((None, "paged_decode"), ({"decode_kernel": "prefill1"}, "paged_prefill")):
            path.write_text(json.dumps({key: entry} if entry else {}))
            A.load_table(refresh=True)
            K.reset_launches()
            out = K.paged_attention(q, kp, vp, tbl, lens)
            torch.cuda.synchronize()
            assert float((out - ref).abs().max()) < TOL[torch.float32]
            assert {k: v for k, v in K.LAUNCHES.items() if v} == {launched: 1}
        for entry in ({"decode_split": 16}, {"decode_kernel": "prefill1", "prefill_split": 5}):
            path.write_text(json.dumps({key: entry}))
            A.load_table(refresh=True)
            with pytest.raises(ValueError, match="split"):
                K.paged_attention(q, kp, vp, tbl, lens)
    finally:
        monkeypatch.undo()
        A.load_table(refresh=True)


@pytest.mark.gpu
def test_cuda_tune_case_checks_and_times_every_candidate():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    won = A.tune_case(2, 8, 32, 16, 4, 64, "bfloat16", iters=3, device="cuda", lens=(40, 200), chunk=(16, 64))
    dec, pre = won["candidates"]["decode"], won["candidates"]["prefill"]
    assert len(dec) == len(A.DECODE_SPLITS) + 1 and len(pre) == len(A.PREFILL_SPLITS)
    assert all(r["s"] > 0 and r["max_abs_err"] < TOL[torch.float32] for r in [*dec.values(), *pre.values()])
    assert won["decode_s"] == min(r["s"] for r in dec.values()) and won["prefill_s"] == min(r["s"] for r in pre.values())
    assert won["decode_kernel"] in A.DECODE_KERNELS and won["library"]["decode_split"] in A.DECODE_SPLITS[1:]
