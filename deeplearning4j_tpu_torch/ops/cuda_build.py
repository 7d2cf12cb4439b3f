"""Build and load the port's hand-written CUDA kernels.

Each source `csrc/<name>.cu` is compiled by `nvcc` for `sm_90a` into a
shared library with a plain C interface (`_build/lib<name>.so` beside
the package, listed in .gitignore) and loaded with `ctypes`. Builds
happen at first use, from the sources in the checkout only; a library
older than its source is rebuilt. `build()` starts one `nvcc` per
source, all at once, so several kernels build in the time of the
slowest.

Nothing here runs at import: the CPU tests import every module, and the
machines without a card have no `nvcc`.

`entry` and `stream_handle` are the lean launch path of a wrapper: the
typed C entry point is looked up once and then read from a dict without
a lock, and the current stream's handle is read without building a
`torch.cuda.Stream` object.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import threading
from pathlib import Path

PACKAGE_DIR = Path(__file__).resolve().parents[1]
SRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "_build"
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")

_lock = threading.Lock()
_loaded: dict[str, ctypes.CDLL] = {}


def sources() -> list[str]:
    """Names of every kernel source in csrc/ (without `.cu`)."""
    return sorted(p.stem for p in SRC_DIR.glob("*.cu"))


def nvcc() -> str:
    """Path of the nvcc that builds the kernels."""
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: the CUDA kernels build only on a "
                       "machine with the CUDA toolkit")


def lib_path(name: str) -> Path:
    return BUILD_DIR / f"lib{name}.so"


def _stale(name: str) -> bool:
    """Whether lib<name>.so is missing or older than its source or than
    any header in csrc/ (the sources include them by name)."""
    lib = lib_path(name)
    if not lib.exists():
        return True
    inputs = [SRC_DIR / f"{name}.cu", *SRC_DIR.glob("*.cuh")]
    return lib.stat().st_mtime < max(p.stat().st_mtime for p in inputs)


def build(names=None, *, verbose: bool = False) -> dict[str, str]:
    """Compile the named sources (default: all) that are missing or
    stale, one `nvcc` process each, started together. Returns each
    compiled source's compiler output (with `-Xptxas -v` when `verbose`:
    registers, shared memory and spills per kernel). Raises with the
    compiler's output if any build fails."""
    names = sources() if names is None else list(names)
    todo = [n for n in names if _stale(n)]
    if not todo:
        return {}
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    compiler = nvcc()
    procs = {}
    for n in todo:
        tmp = BUILD_DIR / f"lib{n}.so.{os.getpid()}.tmp"
        cmd = [compiler, *ARCH_FLAGS, "-std=c++17", "-O3", "-shared",
               "-Xcompiler", "-fPIC", "-o", str(tmp), str(SRC_DIR / f"{n}.cu")]
        if verbose:
            cmd[1:1] = ["-Xptxas", "-v"]
        procs[n] = (tmp, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                          stderr=subprocess.STDOUT,
                                          text=True))
    outputs, failed = {}, []
    for n, (tmp, proc) in procs.items():
        out, _ = proc.communicate()
        outputs[n] = out
        if proc.returncode != 0:
            failed.append(f"{n}.cu (exit {proc.returncode}):\n{out}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, lib_path(n))
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return outputs


_entries: dict[tuple[str, str], ctypes._CFuncPtr] = {}


def entry(name: str, fn: str, argtypes):
    """The C function `fn` of csrc/<name>.cu, typed with `argtypes` and
    an int result; built and loaded on first use, then cached."""
    found = _entries.get((name, fn))
    if found is None:
        found = getattr(load(name), fn)
        found.restype = ctypes.c_int
        found.argtypes = list(argtypes)
        _entries[(name, fn)] = found
    return found


_raw_stream = None


def stream_handle(device_index: int) -> int:
    """The handle of device `device_index`'s current CUDA stream (what
    `torch.cuda.current_stream(device).cuda_stream` gives)."""
    global _raw_stream
    if _raw_stream is None:
        import torch

        _raw_stream = getattr(torch._C, "_cuda_getCurrentRawStream", None) \
            or (lambda i: torch.cuda.current_stream(i).cuda_stream)
    return _raw_stream(device_index)


def load(name: str) -> ctypes.CDLL:
    """The loaded library of csrc/<name>.cu, built first if needed."""
    with _lock:
        lib = _loaded.get(name)
        if lib is None:
            build([name])
            lib = ctypes.CDLL(str(lib_path(name)))
            _loaded[name] = lib
        return lib
