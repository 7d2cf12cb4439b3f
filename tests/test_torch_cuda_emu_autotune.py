"""Launch parameters a tuning table may give (ops/autotune.py) through
the emulated kernels (port_tools/cuda_emu, tests/cuda_emu_util.py's
cached build), each resolved through `autotune.override` and the
wrappers' resolution functions, against the plain versions at
chip_smoke.py's limits:

* K9's bf16 dW/db kernel at N = 300 (5 row blocks of 64) in 1, 4 and 5
  slices of N (at 4, a slice holds no row block and writes a zero
  partial) and a target of 9 clamped to the 5 row blocks; within 2e-2
  of the largest entry (phase 2b), K8 beside it within 1e-4.
* K11's vector backward at N = 256, C = 256 bf16 on 3 and 32 blocks
  (several rows a warp; one block per warp's rows), within phase 9's
  2e-2, run twice and equal bit for bit.
* K12 at [3, 1000] in the plans (256, 3), (128, 8) and (256, 1): every
  row's id equal to the plain version's and the top-k thresholds bit
  for bit.
"""

import pytest
import torch

from cuda_emu_util import (  # noqa: F401
    emulate,
    ln_kernels,
    sample_kernel,
    xent_kernels,
)
from deeplearning4j_tpu_torch.ops import autotune
from deeplearning4j_tpu_torch.ops import fused_layernorm as tln
from deeplearning4j_tpu_torch.ops import fused_sampling as tsm
from deeplearning4j_tpu_torch.ops import fused_softmax_xent as tsx

pytestmark = pytest.mark.port


@pytest.mark.parametrize("tuned,want", [(1, 1), (4, 4), (5, 5), (9, 5)],
                         ids=["slices1", "slices4", "slices5",
                              "target9-clamped"])
def test_emulated_xent_dw_in_tuned_slices(xent_kernels, tuned, want):
    N, d, V = 300, 256, 200
    rows = -(-N // tsx.DW_ROW_BLOCK)
    with autotune.override({"softmax_xent": {"slices": tuned}}):
        slices = autotune.xent_slices(N, d, V, 2, rows)
    assert slices == want
    gen = torch.Generator().manual_seed(N + tuned)
    ok, line = emulate.run_xent_case(xent_kernels, N, d, V, gen,
                                     slices=slices)
    assert ok and f"({want} slices)" in line, line


@pytest.mark.parametrize("blocks", [3, 32])
def test_emulated_ln_bwd_on_tuned_blocks(ln_kernels, blocks):
    N, C = 256, 256
    with autotune.override({"fused_layer_norm": {"blocks": blocks}}):
        nv, got = tln._bwd_plan(N, C, 2, (0, 16, 32, 48))
    assert (nv, got) == (1, blocks)
    gen = torch.Generator().manual_seed(N + blocks)
    ok, line = emulate.run_ln_case(ln_kernels, N, C, torch.bfloat16, gen,
                                   blocks=got)
    assert ok, line


@pytest.mark.parametrize("plan", [(256, 3), (128, 8), (256, 1)],
                         ids=lambda p: f"{p[0]}x{p[1]}")
@pytest.mark.parametrize("mode", [dict(temperature=0.8, top_k=8),
                                  dict(temperature=1.0, top_k=8,
                                       top_p=0.9)],
                         ids=["top_k", "top_k-top_p"])
def test_emulated_sampling_in_tuned_plans(sample_kernel, plan, mode):
    B, V = 3, 1000
    with autotune.override({"sample": {"threads": plan[0],
                                       "cluster": plan[1]}}):
        got = tsm._plan(B, V)
    assert got == plan
    gen = torch.Generator().manual_seed(B + V + sum(plan))
    ok, line = emulate.run_sample_case(sample_kernel, B, V, torch.float32,
                                       mode, gen, got)
    assert ok, line
