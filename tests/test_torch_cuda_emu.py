"""The CUDA sources of the tensor-core kernels (csrc/flash_fwd.cu,
csrc/flash_bwd.cu, csrc/softmax_xent.cu) run on the CPU through
port_tools/cuda_emu, an emulation of the CUDA they use compiled by g++
(ldmatrix, mma.sync, shuffles and cp.async groups from their PTX
semantics), and agree with the plain versions that chip_smoke.py holds
the compiled kernels to on the card: so a fragment address, a swizzle
or a mask that is wrong fails here, before a card sees it. Flash: one
causal case a head dim and dtype, at T = 128 (the flat layout, a ragged
key mask with one all-masked row) and T = 192 (the packed layout,
unmasked); tolerances are phase 2's (o 2e-2 and lse 1e-2 in bf16, 1e-4
in f32) and phase 2b's (2e-2 and 1e-4 of the largest gradient entry).
The dropout arm of both flash sources (the keep mask of
csrc/dropout.cuh at every fragment coordinate) and the lse cotangent of
the backward, at the same tolerances: a keep decision read at a
transposed coordinate changes 18% of the kept elements at rate 0.1 and
fails them. The bf16 softmax-xent head (K8, and K9's dx and dW/db kernels): N = 144
(a ragged last row block in each kernel: 128-row blocks in K8, 64-row
in K9), V = 200 (16-byte copies of W, a ragged
last chunk), V = 203 (odd V: plain loads) and d = 384 (the logits past
the first 256 columns of d), within phase 2b's limits of the largest
entry: 1e-4 for K8's f32 loss and lse, 2e-2 for K9's bf16 gradients."""

import importlib.util
from pathlib import Path

import pytest
import torch

pytestmark = pytest.mark.port

ROOT = Path(__file__).resolve().parents[1]
_spec = importlib.util.spec_from_file_location(
    "emulate", ROOT / "port_tools" / "cuda_emu" / "emulate.py")
emulate = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(emulate)


@pytest.fixture(scope="module")
def kernels(tmp_path_factory):
    return emulate.entry_points(ROOT / "deeplearning4j_tpu_torch" / "csrc",
                                tmp_path_factory.mktemp("emu"))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "f32"])
@pytest.mark.parametrize("D", [32, 64, 128, 256])
@pytest.mark.parametrize("T,masked,packed", [(128, True, False),
                                             (192, False, True)])
def test_emulated_flash_kernels_match_plain_versions(kernels, D, dtype, T,
                                                     masked, packed):
    gen = torch.Generator().manual_seed(D + T)
    ok, line = emulate.run_case(*kernels, D, dtype, True, masked, packed, T,
                                gen)
    assert ok, line


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


@pytest.fixture(scope="module")
def xent_kernels(tmp_path_factory):
    return emulate.xent_entry_points(
        ROOT / "deeplearning4j_tpu_torch" / "csrc",
        tmp_path_factory.mktemp("emu_xent"))


@pytest.mark.parametrize("N,d,V", emulate.XENT_SHAPES)
def test_emulated_xent_kernels_match_plain_versions(xent_kernels, N, d, V):
    gen = torch.Generator().manual_seed(N + d + V)
    ok, line = emulate.run_xent_case(xent_kernels, N, d, V, gen)
    assert ok, line
