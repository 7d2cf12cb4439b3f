# lint-path: deeplearning4j_tpu_torch/serving/_fixture.py
"""graftlint fixture: G029 must stay quiet here (torch spelling),
linted as deeplearning4j_tpu_torch/serving/_fixture.py."""

import torch


def sample_memory():
    return torch.cuda.memory_allocated()
