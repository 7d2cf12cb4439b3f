"""The bf16 softmax-xent head (csrc/softmax_xent.cu), LayerNorm
(csrc/layernorm.cu) and sampling (csrc/sampling.cu) run on the CPU
through port_tools/cuda_emu (tests/cuda_emu_util.py), an emulation of
the CUDA they use compiled by g++ (ldmatrix, mma.sync, shuffles,
ballots, cp.async groups and thread-block clusters from their PTX
semantics), and agree with the plain versions that chip_smoke.py holds
the compiled kernels to on the card. The flash sources' cases are in
tests/test_torch_cuda_emu_flash{32,64,128,256}.py and
test_torch_cuda_emu_flash_arms.py. The softmax-xent head (K8, and K9's
dx and dW/db kernels): N = 144
(a ragged last row block in each kernel: 128-row blocks in K8, 64-row
in K9), V = 200 (16-byte copies of W, a ragged
last chunk), V = 203 (odd V: plain loads) and d = 384 (the logits past
the first 256 columns of d), within phase 2b's limits of the largest
entry: 1e-4 for K8's f32 loss and lse, 2e-2 for K9's bf16 gradients.
K10 and K11 (both K10 instantiations) and K12 (one block, clusters, and
a row past shared memory): the cases and limits are in the tests'
docstrings."""

import pytest
import torch

from cuda_emu_util import (  # noqa: F401
    emulate,
    ln_kernels,
    sample_kernel,
    xent_kernels,
)

pytestmark = pytest.mark.port


@pytest.mark.parametrize("N,d,V", emulate.XENT_SHAPES)
def test_emulated_xent_kernels_match_plain_versions(xent_kernels, N, d, V):
    gen = torch.Generator().manual_seed(N + d + V)
    ok, line = emulate.run_xent_case(xent_kernels, N, d, V, gen)
    assert ok, line


@pytest.mark.parametrize(
    "N,C,dtype,misaligned,nv,blocks,pdtype", emulate.LN_CASES,
    ids=[f"N{n}-C{c}-{str(d)[6:]}{'-misaligned' if m else ''}"
         f"{'-dy' if m == 'dy' else ''}{'-general' if v == 0 else ''}"
         f"{f'-blocks{k}' if k else ''}{'-f32params' if p else ''}"
         for n, c, d, m, v, k, p in emulate.LN_CASES])
def test_emulated_layernorm_kernels_match_plain_versions(ln_kernels, N, C,
                                                         dtype, misaligned,
                                                         nv, blocks, pdtype):
    """K10 in both instantiations (the one-pass vector kernel at C = 256
    and 512, one and two 16-byte vectors a lane, and the general kernel
    at C = 200, C = 7, an x one element off its 16-byte boundary, and
    C = 256 forced onto it), rows that are no multiple of a block's 8,
    and K11 beside it in the instantiation `_bwd_plan` picks: its vector
    kernel at bf16 C = 256 and 512 and f32 C = 256, with 3 blocks forced
    at N = 40 (several rows a warp, partials of several blocks summed),
    N = 1 and N = 5 (fewer rows than a block's warps), and its general
    path at C = 200, C = 7, f32 C = 512, bf16 C = 1024 and an unaligned
    x or dy; bf16 x with f32 gamma and beta (the kernels' second
    parameter type) through both vector kernels at C = 256, K10's at C =
    512 and 1024 beside K11's general path, and the general path at C =
    200; against `_ln_fwd_reference` and
    `_ln_bwd_reference` within phase 9's LN_TOL of the largest entry
    (1e-5 in f32, 2e-2 in bf16: one bf16 rounding can flip), K11 run
    twice and equal bit for bit."""
    gen = torch.Generator().manual_seed(N * 1000 + C)
    ok, line = emulate.run_ln_case(ln_kernels, N, C, dtype, gen, misaligned,
                                   nv, blocks, pdtype)
    assert ok, line


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
