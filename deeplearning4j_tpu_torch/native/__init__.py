"""ctypes bindings for the port's native IO core (io_core.cpp; JAX
counterpart deeplearning4j_tpu/native, the same C ABI and results).

Build model: the C++ source ships inside the package and is compiled
once per source hash with the system g++ (`-O3 -shared -fPIC`) at first
use, into the package's git-ignored `_build/` beside the CUDA kernels
(`_build/io_core-<hash>.so`), under the build directory's file lock so
processes that share a checkout build it once. No build step at install
time.

The contract is the JAX package's: every helper returns None when the
native path does not apply (no toolchain, a non-numeric CSV cell), and
every caller then takes its Python path, which gives the same arrays. A
failed build is not silent: it warns once with the compiler's output,
`available()` is False and `build_error()` returns that output.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import subprocess
import threading
import warnings
from pathlib import Path
from typing import List, Optional, Tuple

import numpy as np

_SRC = Path(__file__).resolve().with_name("io_core.cpp")
BUILD_DIR = Path(__file__).resolve().parents[1] / "_build"

_lock = threading.Lock()
_lib = None
_error: Optional[str] = None


def _build() -> Path:
    """The built library's path, compiling it if it is missing; raises
    RuntimeError with the compiler's output when the build fails."""
    digest = hashlib.sha256(_SRC.read_bytes()).hexdigest()[:16]
    out = BUILD_DIR / f"io_core-{digest}.so"
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(BUILD_DIR / ".build.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if out.exists():  # another process built it while this one waited
            return out
        tmp = BUILD_DIR / f"io_core-{digest}.so.{os.getpid()}.tmp"
        try:
            proc = subprocess.run(
                ["g++", "-O3", "-shared", "-fPIC", "-std=c++17", str(_SRC),
                 "-o", str(tmp)], capture_output=True, text=True,
                timeout=120)
        except (OSError, subprocess.SubprocessError) as exc:
            raise RuntimeError(f"g++ could not run: {exc!r}") from None
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(f"g++ exit {proc.returncode}:\n"
                               f"{proc.stderr}")
        os.replace(tmp, out)
    return out


def get_lib():
    """The loaded CDLL, or None when it could not be built (warned once;
    see `build_error`)."""
    global _lib, _error
    if _lib is not None or _error is not None:
        return _lib
    with _lock:
        if _lib is not None or _error is not None:
            return _lib
        try:
            lib = ctypes.CDLL(str(_build()))
        except (RuntimeError, OSError) as exc:
            _error = str(exc)
            warnings.warn(f"the native IO core did not build; the Python "
                          f"paths run instead: {_error}", RuntimeWarning,
                          stacklevel=3)
            return None
        c_long_p = ctypes.POINTER(ctypes.c_long)
        f32_p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
        i32_p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
        lib.dl4j_csv_dims.argtypes = [
            ctypes.c_char_p, ctypes.c_long, ctypes.c_char, c_long_p, c_long_p]
        lib.dl4j_csv_dims.restype = ctypes.c_long
        lib.dl4j_parse_csv.argtypes = [
            ctypes.c_char_p, ctypes.c_long, ctypes.c_char, f32_p,
            ctypes.c_long, ctypes.c_long]
        lib.dl4j_parse_csv.restype = ctypes.c_long
        lib.dl4j_svmlight_rows.argtypes = [ctypes.c_char_p]
        lib.dl4j_svmlight_rows.restype = ctypes.c_long
        lib.dl4j_parse_svmlight.argtypes = [
            ctypes.c_char_p, ctypes.c_long, f32_p, f32_p, ctypes.c_long]
        lib.dl4j_parse_svmlight.restype = ctypes.c_long
        lib.dl4j_encode_tokens.argtypes = [
            ctypes.c_char_p, ctypes.c_long, ctypes.c_char_p, ctypes.c_long,
            ctypes.c_long, i32_p, ctypes.c_long]
        lib.dl4j_encode_tokens.restype = ctypes.c_long
        lib.dl4j_encode_corpus.argtypes = [
            ctypes.c_char_p, ctypes.c_long, ctypes.c_char_p, ctypes.c_long,
            ctypes.c_long, i32_p, i32_p, ctypes.c_long]
        lib.dl4j_encode_corpus.restype = ctypes.c_long
        _lib = lib
        return _lib


# ------------------------------------------------------------- public API

def load_csv(path: str, skip_lines: int = 0,
             delimiter: str = ",") -> Optional[np.ndarray]:
    """Numeric CSV -> float32 [rows, cols], or None (no core, a
    non-numeric cell)."""
    lib = get_lib()
    if lib is None or len(delimiter) != 1:
        return None
    rows = ctypes.c_long()
    cols = ctypes.c_long()
    if lib.dl4j_csv_dims(path.encode(), skip_lines, delimiter.encode(),
                         ctypes.byref(rows), ctypes.byref(cols)) != 0:
        return None
    if rows.value <= 0 or cols.value <= 0:
        return None
    out = np.empty((rows.value, cols.value), np.float32)
    got = lib.dl4j_parse_csv(path.encode(), skip_lines, delimiter.encode(),
                             out, rows.value, cols.value)
    if got < 0:
        return None  # a non-numeric cell: the caller parses in Python
    return out[:got]


def load_svmlight(path: str, num_features: int
                  ) -> Optional[Tuple[np.ndarray, np.ndarray]]:
    """SVMLight file -> (labels [N], dense features [N, F]), or None."""
    lib = get_lib()
    if lib is None:
        return None
    n = lib.dl4j_svmlight_rows(path.encode())
    if n < 0:
        return None
    labels = np.empty(n, np.float32)
    feats = np.zeros((n, num_features), np.float32)
    got = lib.dl4j_parse_svmlight(path.encode(), num_features, labels,
                                  feats, n)
    if got < 0:
        return None
    return labels[:got], feats[:got]


def encode_tokens(text: str, vocab: List[str]) -> Optional[np.ndarray]:
    """Whitespace-tokenize `text` and map tokens to vocab indices (-1 for
    OOV) in one native pass. Returns int32 [n_tokens] or None."""
    lib = get_lib()
    if lib is None:
        return None
    data = text.encode()
    blob = "\n".join(vocab).encode()
    # upper bound on the token count: every other byte a separator
    out = np.empty(len(data) // 2 + 1, np.int32)
    got = lib.dl4j_encode_tokens(data, len(data), blob, len(blob),
                                 len(vocab), out, len(out))
    if got < 0:
        return None
    return out[:got]


def encode_corpus(lines: List[str], vocab: List[str]
                  ) -> Optional[Tuple[np.ndarray, np.ndarray]]:
    """Encode a whole corpus (one sentence a list entry) in one native
    pass: the vocab hash table is built once; returns (token_ids,
    sentence_ids), OOV as -1, or None."""
    lib = get_lib()
    if lib is None:
        return None
    # embedded or trailing newlines in a line would desync the native
    # sentence counter from the list indices
    data = "\n".join(
        l.replace("\n", " ").strip() for l in lines).encode()
    blob = "\n".join(vocab).encode()
    cap = len(data) // 2 + 1
    ids = np.empty(cap, np.int32)
    sent = np.empty(cap, np.int32)
    got = lib.dl4j_encode_corpus(data, len(data), blob, len(blob),
                                 len(vocab), ids, sent, cap)
    if got < 0:
        return None
    return ids[:got], sent[:got]


def available() -> bool:
    """Whether the native core built and loaded."""
    return get_lib() is not None


def build_error() -> Optional[str]:
    """The compiler's output of a failed build, or None."""
    get_lib()
    return _error
