"""The dropout arm of both flash sources (the keep mask of
csrc/dropout.cuh at every fragment coordinate) and the lse cotangent of
the backward through the CUDA emulation (tests/cuda_emu_util.py), at
phase 2's and 2b's tolerances: a keep decision read at a transposed
coordinate changes 18% of the kept elements at rate 0.1 and fails
them."""

import pytest
import torch

from cuda_emu_util import emulate, kernels  # noqa: F401

pytestmark = pytest.mark.port


@pytest.mark.parametrize("D,dtype,T,causal,masked,packed", [
    (64, torch.bfloat16, 128, True, True, False),
    (256, torch.bfloat16, 192, True, False, True),
    (128, torch.bfloat16, 192, False, False, False),
    (32, torch.float32, 128, True, True, False)],
    ids=["bf16-64-flat", "bf16-256-packed", "bf16-128-noncausal",
         "f32-32-flat"])
def test_emulated_flash_dropout_and_dlse_arms(kernels, D, dtype, T, causal,
                                              masked, packed):
    """The kernels' dropout arm (rate 0.1; the flat layout at window
    origin (T, 0) of a sequence of 4T) and, on the flat layout, the lse
    cotangent folded into delta, against the plain versions with the
    same keep mask and dlse, within the tolerances above."""
    gen = torch.Generator().manual_seed(7 * D + T)
    ok, line = emulate.run_case(*kernels, D, dtype, causal, masked, packed,
                                T, gen, dropout=True, dlse=not packed)
    assert ok, line
