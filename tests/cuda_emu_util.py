"""Shared by the tests/test_torch_cuda_emu*.py files: the emulation
script (port_tools/cuda_emu/emulate.py) and module-scoped fixtures of its
entry points. The libraries build into the emulation's own directory
(git-ignored `deeplearning4j_tpu_torch/_build/emu/`), keyed by a hash of
the sources and the emulation, under a lock: the files, which pytest-xdist
runs in several processes, compile each source once between them, and
a source that changed is compiled again."""

import importlib.util
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
CSRC = ROOT / "deeplearning4j_tpu_torch" / "csrc"
_spec = importlib.util.spec_from_file_location(
    "emulate", ROOT / "port_tools" / "cuda_emu" / "emulate.py")
emulate = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(emulate)

DTYPES = dict(argvalues=[torch.bfloat16, torch.float32], ids=["bf16", "f32"])
# (T, masked, packed): the flat layout with a ragged key mask at T = 128,
# the packed one unmasked at T = 192
LAYOUTS = [(128, True, False), (192, False, True)]


@pytest.fixture(scope="module")
def kernels():
    return emulate.entry_points(CSRC)


@pytest.fixture(scope="module")
def xent_kernels():
    return emulate.xent_entry_points(CSRC)


@pytest.fixture(scope="module")
def ln_kernels():
    return emulate.ln_entry_points(CSRC)


@pytest.fixture(scope="module")
def sample_kernel():
    return emulate.sample_entry_point(CSRC)


def flash_case(kernels, D, dtype, T, masked, packed):
    """One causal flash case through the emulated kernels against the
    plain versions (the seed D + T)."""
    gen = torch.Generator().manual_seed(D + T)
    ok, line = emulate.run_case(*kernels, D, dtype, True, masked, packed, T,
                                gen)
    assert ok, line
