# lint-path: deeplearning4j_tpu_torch/nn/_fixture.py
"""graftlint fixture: G033 must fire here (torch spelling),
linted as deeplearning4j_tpu_torch/nn/_fixture.py."""

import torch


def quantize(x, amax):
    scale = amax / 127.0
    return torch.clamp(torch.round(x / scale), -127, 127)
