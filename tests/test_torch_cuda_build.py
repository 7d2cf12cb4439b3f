"""The port's kernel build (deeplearning4j_tpu_torch/ops/cuda_build.py)
without nvcc: which sources it builds and when a built library is stale.
A library is rebuilt when it is missing or older than its `.cu` source
or than any `.cuh` header in csrc/, which the sources include by name."""

import os

import pytest

from deeplearning4j_tpu_torch.ops import cuda_build

pytestmark = pytest.mark.port


def test_sources_are_the_cu_files_only():
    """Every `.cu` in csrc/ is a kernel source; the shared header is
    not built on its own."""
    names = cuda_build.sources()
    assert "flash_bwd" in names and "softmax_xent" in names
    assert not any(n.endswith(".cuh") or n == "mma_bf16" for n in names)
    assert (cuda_build.SRC_DIR / "mma_bf16.cuh").exists()


@pytest.fixture
def tree(tmp_path, monkeypatch):
    src, build = tmp_path / "csrc", tmp_path / "_build"
    src.mkdir()
    build.mkdir()
    (src / "k.cu").write_text('#include "h.cuh"\n')
    (src / "h.cuh").write_text("// header\n")
    monkeypatch.setattr(cuda_build, "SRC_DIR", src)
    monkeypatch.setattr(cuda_build, "BUILD_DIR", build)
    return src, build


def _age(path, seconds):
    st = path.stat()
    os.utime(path, (st.st_atime, st.st_mtime + seconds))


@pytest.mark.parametrize("newer,stale", [
    (None, False),        # the library is newer than both
    ("k.cu", True),       # the source changed
    ("h.cuh", True),      # a header the sources include changed
])
def test_library_is_stale_when_an_input_is_newer(tree, newer, stale):
    src, build = tree
    lib = build / "libk.so"
    lib.write_bytes(b"")
    _age(lib, 100)
    if newer is not None:
        _age(src / newer, 200)
    assert cuda_build._stale("k") is stale


def test_missing_library_is_stale(tree):
    assert cuda_build._stale("k")
