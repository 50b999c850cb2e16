"""The port's kernel build on the CPU: what keys a built library.  Nothing
is compiled here (no nvcc); ``library_path`` only hashes the sources."""

import pytest

from repro_torch.kernels import build

KERNEL = '#include "common.cuh"\n__global__ void k() {}\n'


@pytest.fixture
def csrc(tmp_path, monkeypatch):
    monkeypatch.setattr(build, "CSRC", tmp_path)
    (tmp_path / "k.cu").write_text(KERNEL)
    (tmp_path / "common.cuh").write_text("#pragma once\n")
    (tmp_path / "other.cuh").write_text("#pragma once\n")
    return tmp_path


def test_library_path_follows_the_headers(csrc):
    first = build.library_path("k.cu")
    assert first == build.library_path("k.cu")  # nothing changed
    assert first.parent == build.BUILD_DIR and first.name.startswith("libk_")
    (csrc / "common.cuh").write_text("#pragma once\n#define X 1\n")
    second = build.library_path("k.cu")
    assert second != first
    (csrc / "other.cuh").write_text("#pragma once\n#define Y 1\n")  # every csrc/*.cuh counts
    third = build.library_path("k.cu")
    assert third not in (first, second)
    (csrc / "other.cuh").write_text("#pragma once\n")
    assert build.library_path("k.cu") == second  # the same content, the same library


def test_library_path_follows_the_source(csrc):
    first = build.library_path("k.cu")
    (csrc / "k.cu").write_text(KERNEL + "// edited\n")
    assert build.library_path("k.cu") != first


def test_a_missing_header_raises(csrc):
    (csrc / "common.cuh").unlink()
    with pytest.raises(FileNotFoundError, match="common.cuh"):
        build.library_path("k.cu")


def test_the_repository_sources_hash():
    for src in ("paged_attention.cu", "fp8_gemm.cu", "flash_attention.cu", "babelstream.cu", "rwkv6_scan.cu"):
        assert build.library_path(src).name.startswith(f"lib{src[:-3]}_")


def _edited_header_rebuilds(src, header, tmp_path, monkeypatch) -> None:
    for f in build.CSRC.iterdir():
        (tmp_path / f.name).write_bytes(f.read_bytes())
    assert f'#include "{header}"' in (tmp_path / src).read_text()
    monkeypatch.setattr(build, "CSRC", tmp_path)
    first = build.library_path(src)
    with open(tmp_path / header, "a") as f:
        f.write("// edited\n")
    assert build.library_path(src) != first


@pytest.mark.parametrize("src", ["fp8_gemm.cu", "flash_attention.cu", "paged_attention.cu"])
def test_tensor_core_sources_follow_hopper_cuh(src, tmp_path, monkeypatch):
    # the tensor-core kernels include hopper.cuh: an edit of it builds them anew
    _edited_header_rebuilds(src, "hopper.cuh", tmp_path, monkeypatch)


@pytest.mark.parametrize("src", ["flash_attention.cu", "paged_attention.cu"])
def test_attention_sources_follow_attention_tc_cuh(src, tmp_path, monkeypatch):
    # K3 and K2 share their softmax and P V code in attention_tc.cuh
    _edited_header_rebuilds(src, "attention_tc.cuh", tmp_path, monkeypatch)
