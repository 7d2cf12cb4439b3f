# lint-path: deeplearning4j_tpu_torch/nn/_fixture.py
"""graftlint fixture: G033 must stay quiet here (torch spelling),
linted as deeplearning4j_tpu_torch/nn/_fixture.py."""

def padded(n):
    return (n + 127) // 128 * 128
