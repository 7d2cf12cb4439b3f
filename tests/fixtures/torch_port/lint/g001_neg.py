# lint-path: deeplearning4j_tpu_torch/parallel/_fixture.py
"""graftlint fixture: G001 must stay quiet here (torch spelling),
linted as deeplearning4j_tpu_torch/parallel/_fixture.py."""

import torch


def step(x, flag):
    if x is None:
        return flag
    if x.shape[0] > 2 and x.dtype == torch.float32:
        return torch.where(x > 0, x, -x)
    n = int(x.numel())
    return x[:n]
