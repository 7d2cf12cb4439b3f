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


_FAKE_NVCC = """#!/bin/sh
# stands in for nvcc: logs the call, takes a second, writes the -o file
echo "$$" >> "{log}"
sleep 1
while [ "$#" -gt 0 ]; do
  if [ "$1" = "-o" ]; then shift; echo lib > "$1"; fi
  shift
done
"""

_BUILDER = """import sys
from pathlib import Path
from deeplearning4j_tpu_torch.ops import cuda_build
cuda_build.SRC_DIR = Path(sys.argv[1])
cuda_build.BUILD_DIR = Path(sys.argv[2])
cuda_build.nvcc = lambda: sys.argv[3]
print(sorted(cuda_build.build(["k"])))
"""


def test_processes_sharing_the_cache_build_once(tree, tmp_path):
    """Two processes that start together on a missing library: one
    compiles it, the other waits on the build lock and finds it up to
    date."""
    import subprocess
    import sys

    src, build = tree
    log = tmp_path / "calls.log"
    fake = tmp_path / "nvcc"
    fake.write_text(_FAKE_NVCC.format(log=log))
    fake.chmod(0o755)
    root = cuda_build.PACKAGE_DIR.parent
    procs = [subprocess.Popen(
        [sys.executable, "-c", _BUILDER, str(src), str(build), str(fake)],
        cwd=root, env={**os.environ, "PYTHONPATH": str(root)},
        stdout=subprocess.PIPE, text=True) for _ in range(2)]
    outs = sorted(p.communicate(timeout=60)[0].strip() for p in procs)
    assert all(p.returncode == 0 for p in procs)
    assert outs == ["['k']", "[]"]
    assert len(log.read_text().split()) == 1
    assert (build / "libk.so").read_text() == "lib\n"
