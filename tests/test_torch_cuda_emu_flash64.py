"""The flash sources (csrc/flash_fwd.cu, csrc/flash_bwd.cu) at head dim
64 through the CUDA emulation (tests/cuda_emu_util.py), one causal case
a dtype and layout: T = 128 (the flat layout, a ragged key mask with one
all-masked row) and T = 192 (the packed layout, unmasked), against the
plain versions within phase 2's tolerances (o 2e-2 and lse 1e-2 in
bf16, 1e-4 in f32) and phase 2b's (2e-2 and 1e-4 of the largest
gradient entry). One file a head dim, so that pytest-xdist spreads them
over its workers."""

import pytest

from cuda_emu_util import DTYPES, LAYOUTS, flash_case, kernels  # noqa: F401

pytestmark = pytest.mark.port


@pytest.mark.parametrize("dtype", **DTYPES)
@pytest.mark.parametrize("D", [64])
@pytest.mark.parametrize("T,masked,packed", LAYOUTS)
def test_emulated_flash_kernels_match_plain_versions(kernels, D, dtype, T,
                                                     masked, packed):
    flash_case(kernels, D, dtype, T, masked, packed)
