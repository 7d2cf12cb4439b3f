# lint-path: deeplearning4j_tpu_torch/ops/_fixture.py
"""graftlint fixture: G016 must stay quiet here (torch spelling),
linted as deeplearning4j_tpu_torch/ops/_fixture.py."""

BLOCK_Q = 128


def launch(kernel, grid, x, block_n):
    kernel[grid](x, BLOCK_N=block_n)
