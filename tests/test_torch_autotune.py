"""The port's paged-attention autotuner (``repro_torch.kernels.autotune``) on the CPU.

* The lookup order on temporary table files: the user cache
  (``$REPRO_TORCH_AUTOTUNE_CACHE``) over the in-repo defaults, the exact key
  over the entry for any page count, then ``"default"``; the query heads
  per kv head are part of the key.  The in-repo table's ``"default"`` is
  the library's own pick (``"paged"``, split 0, split 0), and its one
  tuned entry is qwen3-moe's serving shape.
* ``_sanitize``: an unknown ``decode_kernel`` reads as ``"paged"``, the JAX
  tuner's ``prefill_rows_per_tile`` is ignored, a split that is not an int
  raises; ``check_determinism`` passes on a valid table, refuses an
  out-of-range split and a table without ``"default"``, and the table
  round-trips byte for byte.
* On a table both packages read, the port's ``decode_kernel`` is the JAX
  tuner's for every shape.
* The wrappers' CPU branch never reads the table: a table with an invalid
  split changes nothing and launches nothing.
* The ``"prefill1"`` form of decode, K2's plain version at C = 1 from
  ``seq_lens - 1``, equals K1's plain version (fp32, 1e-5) and the JAX
  ``paged_attention`` under a ``"prefill1"`` table (1e-4; its jitted graph
  reads the table at trace time, so its compiled cache is cleared before
  and after).
* ``tune_case`` times on the card only: any other device raises.
"""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import autotune as jax_autotune
from repro.kernels import paged_attention_ops as jax_ops
from repro_torch.kernels import autotune as A
from repro_torch.kernels import paged_attention as K
from repro_torch.kernels.paged_attention_ref import paged_attention_plain, paged_prefill_attention_plain

torch.set_num_threads(2)

DEFAULT = {"decode_kernel": "paged", "decode_split": 0, "prefill_split": 0}


@pytest.fixture
def tables(tmp_path, monkeypatch):
    """Point the tuner at temporary defaults and user-cache files; returns a
    writer ``write(which, table)`` that also refreshes the loaded table."""
    paths = {"defaults": tmp_path / "defaults.json", "user": tmp_path / "user.json"}
    monkeypatch.setattr(A, "DEFAULTS_PATH", paths["defaults"])
    monkeypatch.setenv(A.CACHE_ENV, str(paths["user"]))

    def write(which, table):
        paths[which].write_text(json.dumps(table))
        A.load_table(refresh=True)

    write("defaults", {"default": DEFAULT})
    yield write
    monkeypatch.undo()
    A.load_table(refresh=True)


def test_in_repo_default_is_the_library_pick(monkeypatch, tmp_path):
    monkeypatch.setenv(A.CACHE_ENV, str(tmp_path / "none.json"))  # no user cache
    A.load_table(refresh=True)
    table = json.loads(A.DEFAULTS_PATH.read_text())
    assert table["default"] == DEFAULT
    for key, entry in table.items():  # a committed entry names every knob and is valid
        assert set(entry) == set(DEFAULT) and A._sanitize(entry) == entry, key
    # the one committed entry: qwen3-moe's heads (64 over 4, hd 128) on the serving engine's bf16
    # pools, block 32, 16-block tables, where "prefill1" beat K1 by 1.65x in two sweeps on the card
    qwen3 = A.cache_key(128, 32, 16, torch.bfloat16, 16)
    assert set(table) == {"default", qwen3} and table[qwen3] == {**DEFAULT, "decode_kernel": "prefill1"}
    for hd, bs, nb, qpk in ((128, 32, 16, 1), (64, 32, 48, 5), (128, 32, 16, 4), (128, 16, 16, 16)):
        assert A.get_config(hd, bs, nb, torch.bfloat16, qpk) == DEFAULT  # every other shape: the library's pick
    assert A.get_config(128, 32, 16, torch.float32, 16) == DEFAULT
    monkeypatch.undo()
    A.load_table(refresh=True)


def test_user_cache_path(monkeypatch, tmp_path):
    monkeypatch.delenv(A.CACHE_ENV, raising=False)
    monkeypatch.setenv("HOME", str(tmp_path))
    assert A.user_cache_path() == tmp_path / ".cache" / "repro_torch" / "cuda_autotune.json"
    monkeypatch.setenv(A.CACHE_ENV, str(tmp_path / "t.json"))
    assert A.user_cache_path() == tmp_path / "t.json"
    assert A.CACHE_ENV != jax_autotune.CACHE_ENV  # a JAX cache never steers the port


def test_lookup_order(tables):
    key = A.cache_key(128, 32, 16, torch.bfloat16, 1)
    assert key == "hd128_bs32_pages16_bfloat16_qpk1"
    assert A.get_config(128, 32, 16, torch.bfloat16, 1) == DEFAULT
    any_pages = {"decode_kernel": "paged", "decode_split": 8, "prefill_split": 0}
    exact = {"decode_kernel": "prefill1", "decode_split": 0, "prefill_split": 2}
    tables("defaults", {"default": DEFAULT, A.cache_key(128, 32, 0, "bfloat16", 1): any_pages})
    assert A.get_config(128, 32, 16, torch.bfloat16, 1) == any_pages  # any page count
    assert A.get_config(128, 32, 48, "bfloat16", 1) == any_pages
    assert A.get_config(128, 32, 16, torch.bfloat16, 16) == DEFAULT  # another qpk: another key
    assert A.get_config(128, 32, 16, torch.float32, 1) == DEFAULT  # another dtype
    tables("defaults", {"default": DEFAULT, A.cache_key(128, 32, 0, "bfloat16", 1): any_pages, key: exact})
    assert A.get_config(128, 32, 16, torch.bfloat16, 1) == exact  # the exact key first
    user = {"decode_kernel": "paged", "decode_split": 4, "prefill_split": 1}
    tables("user", {key: user})
    assert A.get_config(128, 32, 16, torch.bfloat16, 1) == user  # the user cache shadows the defaults
    assert A.get_config(128, 32, 48, torch.bfloat16, 1) == any_pages
    tables("user", {"default": {"decode_kernel": "prefill1"}})
    assert A.get_config(64, 16, 8, torch.bfloat16, 4) == {**DEFAULT, "decode_kernel": "prefill1"}


def test_sanitize():
    assert A._sanitize(None) == DEFAULT
    assert A._sanitize({"decode_kernel": "bogus"}) == DEFAULT
    assert A._sanitize({"prefill_rows_per_tile": 32, "decode_kernel": "prefill1"}) == {
        **DEFAULT, "decode_kernel": "prefill1"}  # the JAX knob has no counterpart
    assert A._sanitize({"decode_split": 9}) == {**DEFAULT, "decode_split": 9}  # the launch refuses it
    for bad in ("2", 2.0, True, None):
        with pytest.raises(ValueError, match="decode_split"):
            A._sanitize({"decode_split": bad})
    with pytest.raises(ValueError, match="prefill_split"):
        A._sanitize({"prefill_split": [1]})


def test_check_determinism_round_trip(tables, capsys):
    tables("user", {A.cache_key(64, 16, 8, "bfloat16", 4): {"decode_kernel": "prefill1", "decode_split": 2,
                                                             "prefill_split": 3}})
    A.check_determinism()
    assert "deterministic: 2 entries" in capsys.readouterr().out
    path = A.user_cache_path()
    dumped = json.dumps(A.load_table(), indent=2, sort_keys=True)
    path.write_text(dumped)
    assert json.dumps(A.load_table(refresh=True), indent=2, sort_keys=True) == dumped
    tables("user", {"x": {"decode_split": 3}})  # K1's clusters are 1, 2, 4 or 8 blocks
    with pytest.raises(AssertionError):
        A.check_determinism()
    tables("user", {"x": {"prefill_split": 5}})
    with pytest.raises(AssertionError):
        A.check_determinism()
    tables("user", {})
    tables("defaults", {})
    with pytest.raises(AssertionError, match="default"):
        A.check_determinism()


SHAPES = [(128, 32, 16, 1), (128, 32, 8, 16), (64, 32, 48, 5), (64, 16, 8, 4), (256, 32, 16, 1)]


def test_decode_kernel_matches_the_jax_tuner(tmp_path, monkeypatch):
    """One table file read by both tuners: each shape's entry under both
    packages' keys, and a ``"default"`` the unlisted shapes fall to."""
    table = {"default": {"decode_kernel": "prefill1", "prefill_rows_per_tile": 0}}
    for i, (hd, bs, nb, qpk) in enumerate(SHAPES[:-1]):
        dk = jax_autotune.DECODE_KERNELS[i % 2]
        table[jax_autotune.cache_key(hd, bs, nb, "bfloat16")] = {"decode_kernel": dk, "prefill_rows_per_tile": 0}
        table[A.cache_key(hd, bs, nb, "bfloat16", qpk)] = {"decode_kernel": dk}
    path = tmp_path / "shared.json"
    path.write_text(json.dumps(table))
    monkeypatch.setenv(A.CACHE_ENV, str(path))
    monkeypatch.setenv(jax_autotune.CACHE_ENV, str(path))
    try:
        A.load_table(refresh=True)
        jax_autotune.load_table(refresh=True)
        for hd, bs, nb, qpk in SHAPES:
            ours = A.get_config(hd, bs, nb, torch.bfloat16, qpk)["decode_kernel"]
            theirs = jax_autotune.get_config(hd, bs, nb, "bfloat16")["decode_kernel"]
            assert ours == theirs, (hd, bs, nb, qpk)
        assert A.get_config(*SHAPES[-1][:3], "bfloat16", SHAPES[-1][3])["decode_kernel"] == "prefill1"
    finally:
        monkeypatch.undo()
        A.load_table(refresh=True)
        jax_autotune.load_table(refresh=True)


def _inputs(H=8, KV=2, hd=16, bs=16, nb=6, lens=(1, 17, 40, 96), dtype=torch.float32, seed=0):
    rng = np.random.default_rng(seed)
    B = len(lens)
    N = 1 + B * nb + 2
    q = rng.standard_normal((B, H, hd)).astype(np.float32)
    kp = rng.standard_normal((N, bs, KV, hd)).astype(np.float32)
    vp = rng.standard_normal((N, bs, KV, hd)).astype(np.float32)
    tbl = (rng.permutation(N - 1)[: B * nb] + 1).reshape(B, nb).astype(np.int32)
    for b, n in enumerate(lens):
        tbl[b, (n - 1) // bs + 1 :] = 0
    lens = np.asarray(lens, np.int32)
    return {"np": (q, kp, vp, tbl, lens), "torch": tuple(torch.from_numpy(a) for a in (q, kp, vp, tbl, lens))}


def test_cpu_branch_ignores_the_table(tables):
    x = _inputs()
    q, kp, vp, tbl, lens = x["torch"]
    bad = {"decode_kernel": "prefill1", "decode_split": 99, "prefill_split": 99}
    tables("user", {"default": bad})
    assert K.tuned_config(q, kp, tbl) == bad  # the CUDA branch would read (and refuse) it
    K.reset_launches()
    out = K.paged_attention(q, kp, vp, tbl, lens, window=24)
    chunk = K.paged_prefill_attention(q[:, None], kp, vp, tbl, lens - 1)
    assert torch.equal(out, paged_attention_plain(q, kp, vp, tbl, lens, window=24))
    assert torch.equal(chunk, paged_prefill_attention_plain(q[:, None], kp, vp, tbl, lens - 1))
    assert all(n == 0 for n in K.LAUNCHES.values())


@pytest.mark.parametrize("window,softcap", [(0, 0.0), (24, 0.0), (0, 30.0)])
def test_prefill1_form_equals_decode(window, softcap):
    x = _inputs(seed=window)
    q, kp, vp, tbl, lens = x["torch"]
    decode = paged_attention_plain(q, kp, vp, tbl, lens, softcap=softcap, window=window)
    prefill1 = paged_prefill_attention_plain(q[:, None], kp, vp, tbl, lens - 1, softcap=softcap, window=window)[:, 0]
    assert float((prefill1 - decode).abs().max()) < 1e-5


@pytest.fixture
def jax_prefill1_table(tmp_path, monkeypatch):
    """A ``"prefill1"`` table for the JAX package, and its jitted
    ``paged_attention`` traced afresh before and after."""
    path = tmp_path / "jax_prefill1.json"
    path.write_text(json.dumps({"default": {"decode_kernel": "prefill1", "prefill_rows_per_tile": 0}}))
    monkeypatch.setenv(jax_autotune.CACHE_ENV, str(path))
    jax_autotune.load_table(refresh=True)
    jax_ops.paged_attention.clear_cache()
    yield
    monkeypatch.undo()
    jax_autotune.load_table(refresh=True)
    jax_ops.paged_attention.clear_cache()


@pytest.mark.parametrize("window", [0, 24])
def test_prefill1_form_matches_jax_under_a_prefill1_table(jax_prefill1_table, window):
    x = _inputs(hd=64, bs=32, nb=4, lens=(1, 33, 70, 128), seed=1 + window)
    q, kp, vp, tbl, lens = x["torch"]
    assert jax_autotune.get_config(64, 32, 4, kp.numpy().dtype)["decode_kernel"] == "prefill1"
    theirs = np.asarray(jax_ops.paged_attention(*(jnp.asarray(a) for a in x["np"]), window=window))
    ours = paged_prefill_attention_plain(q[:, None], kp, vp, tbl, lens - 1, window=window)[:, 0]
    assert float(np.abs(ours.numpy() - theirs).max()) < 1e-4


def test_tune_case_needs_the_card():
    for device in ("cpu", "meta"):
        with pytest.raises(ValueError, match="on the card"):
            A.tune_case(4, 16, 32, 16, 16, 128, device=device)
