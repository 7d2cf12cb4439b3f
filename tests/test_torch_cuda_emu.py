"""The CUDA sources of the tensor-core kernels (csrc/flash_fwd.cu,
csrc/flash_bwd.cu, csrc/softmax_xent.cu), of LayerNorm
(csrc/layernorm.cu) and of sampling (csrc/sampling.cu) run on the CPU
through port_tools/cuda_emu, an emulation of the CUDA they use compiled
by g++ (ldmatrix, mma.sync, shuffles, ballots, cp.async groups and
thread-block clusters from their PTX semantics), and agree with the plain versions that chip_smoke.py holds
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
entry: 1e-4 for K8's f32 loss and lse, 2e-2 for K9's bf16 gradients.
K10 and K11 (both K10 instantiations) and K12 (one block, clusters, and
a row past shared memory): the cases and limits are in the tests'
docstrings."""

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


@pytest.fixture(scope="module")
def ln_kernels(tmp_path_factory):
    return emulate.ln_entry_points(
        ROOT / "deeplearning4j_tpu_torch" / "csrc",
        tmp_path_factory.mktemp("emu_ln"))


@pytest.mark.parametrize(
    "N,C,dtype,misaligned,nv,blocks", emulate.LN_CASES,
    ids=[f"N{n}-C{c}-{str(d)[6:]}{'-misaligned' if m else ''}"
         f"{'-dy' if m == 'dy' else ''}{'-general' if v == 0 else ''}"
         f"{f'-blocks{k}' if k else ''}"
         for n, c, d, m, v, k in emulate.LN_CASES])
def test_emulated_layernorm_kernels_match_plain_versions(ln_kernels, N, C,
                                                         dtype, misaligned,
                                                         nv, blocks):
    """K10 in both instantiations (the one-pass vector kernel at C = 256
    and 512, one and two 16-byte vectors a lane, and the general kernel
    at C = 200, C = 7, an x one element off its 16-byte boundary, and
    C = 256 forced onto it), rows that are no multiple of a block's 8,
    and K11 beside it in the instantiation `_bwd_plan` picks: its vector
    kernel at bf16 C = 256 and 512 and f32 C = 256, with 3 blocks forced
    at N = 40 (several rows a warp, partials of several blocks summed),
    N = 1 and N = 5 (fewer rows than a block's warps), and its general
    path at C = 200, C = 7, f32 C = 512, bf16 C = 1024 and an unaligned
    x or dy; against `_ln_fwd_reference` and
    `_ln_bwd_reference` within phase 9's LN_TOL of the largest entry
    (1e-5 in f32, 2e-2 in bf16: one bf16 rounding can flip), K11 run
    twice and equal bit for bit."""
    gen = torch.Generator().manual_seed(N * 1000 + C)
    ok, line = emulate.run_ln_case(ln_kernels, N, C, dtype, gen, misaligned,
                                   nv, blocks)
    assert ok, line


@pytest.fixture(scope="module")
def sample_kernel(tmp_path_factory):
    return emulate.sample_entry_point(
        ROOT / "deeplearning4j_tpu_torch" / "csrc",
        tmp_path_factory.mktemp("emu_sample"))


@pytest.mark.parametrize("mode", [m for _, m in emulate.SAMPLE_MODES],
                         ids=[label for label, _ in emulate.SAMPLE_MODES])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("B,V", emulate.SAMPLE_SHAPES,
                         ids=lambda v: str(v))
def test_emulated_sampling_kernel_matches_plain_version(sample_kernel, B, V,
                                                        dtype, mode):
    """K12 in every mode of chip_smoke.py's SAMPLE_MODES, with the plan
    `_plan` gives (one block of 128 threads at V = 1000, a cluster of 5
    at V = 4099, each block with its own shared memory and the cluster's
    barrier and distributed shared memory emulated), against
    `_select_reference` on the same Gumbel noise: every row's id equal,
    and the top-k thresholds the kernel writes equal to the plain binary
    walk's bit for bit (a candidate mid formed from the wrong parent, or
    a vote read for the wrong node, fails them)."""
    gen = torch.Generator().manual_seed(B * 7 + V)
    ok, line = emulate.run_sample_case(sample_kernel, B, V, dtype, mode, gen)
    assert ok, line


@pytest.mark.parametrize("shape,plan", emulate.SAMPLE_PLANS,
                         ids=lambda v: str(v))
@pytest.mark.parametrize("mode", [m for _, m in emulate.SAMPLE_MODES[1:4:2]],
                         ids=["top_k", "top_k-top_p"])
def test_emulated_sampling_kernel_in_other_plans(sample_kernel, shape, plan,
                                                 mode):
    """K12 in plans `_plan` does not pick at these shapes: clusters of 4
    blocks of 128 and 2 of 256 threads at V = 1000, and one block whose
    slice (17,500 elements, 210 KB) overflows shared memory, so z, P and
    the score are recomputed from the logits on every pass; the same
    checks."""
    gen = torch.Generator().manual_seed(sum(shape) + sum(plan))
    ok, line = emulate.run_sample_case(sample_kernel, *shape,
                                       torch.float32, mode, gen, plan)
    assert ok, line


@pytest.mark.parametrize("mode", [m for _, m in emulate.SAMPLE_MODES[1:4:2]],
                         ids=["top_k", "top_k-top_p"])
def test_emulated_sampling_kernel_with_ties_at_the_top(sample_kernel, mode):
    """Rows whose 200 largest logits are equal: more than CAP = 128
    elements stay in top-k's [lo, hi) to the last level, so its walk runs
    every round over the cluster and never finishes in one warp; both
    modes still give the plain version's ids and top-k thresholds bit for
    bit."""
    (B, V), plan, ties = emulate.SAMPLE_TIES
    gen = torch.Generator().manual_seed(B + V + ties)
    ok, line = emulate.run_sample_case(sample_kernel, B, V, torch.float32,
                                       mode, gen, plan, ties)
    assert ok, line
