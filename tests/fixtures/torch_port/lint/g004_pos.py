# lint-path: deeplearning4j_tpu_torch/parallel/_fixture.py
"""graftlint fixture: G004 must fire here (torch spelling),
linted as deeplearning4j_tpu_torch/parallel/_fixture.py."""

import numpy as np
import torch


def init(shape):
    torch.manual_seed(0)
    noise = np.random.rand(4)
    w = torch.empty(shape).uniform_(-1.0, 1.0)
    return w + torch.randn(shape) + torch.as_tensor(noise)
