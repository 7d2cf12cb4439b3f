"""The flash sources (csrc/flash_fwd.cu, csrc/flash_bwd.cu) at head dim
16, which only their f32 kernels take, through the CUDA emulation
(tests/cuda_emu_util.py): one causal case a layout, T = 128 (the flat
layout, a ragged key mask with one all-masked row) and T = 192 (the
packed layout, unmasked), against the plain versions within phase 2's
tolerances (1e-4 in f32) and phase 2b's (1e-4 of the largest gradient
entry)."""

import pytest
import torch

from cuda_emu_util import LAYOUTS, flash_case, kernels  # noqa: F401

pytestmark = pytest.mark.port


@pytest.mark.parametrize("T,masked,packed", LAYOUTS)
def test_emulated_f32_flash_kernels_at_head_dim_16(kernels, T, masked,
                                                  packed):
    flash_case(kernels, 16, torch.float32, T, masked, packed)
