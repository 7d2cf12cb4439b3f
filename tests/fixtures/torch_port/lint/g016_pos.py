# lint-path: deeplearning4j_tpu_torch/ops/_fixture.py
"""graftlint fixture: G016 must fire here (torch spelling),
linted as deeplearning4j_tpu_torch/ops/_fixture.py."""

BLOCK_Q = 256


def launch(kernel, grid, x):
    kernel[grid](x, BLOCK_N=512)
