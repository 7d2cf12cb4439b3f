# lint-path: deeplearning4j_tpu_torch/parallel/_fixture.py
"""graftlint fixture: G001 must fire here (torch spelling),
linted as deeplearning4j_tpu_torch/parallel/_fixture.py."""

import torch


def step(x):
    s = torch.sum(x)
    if s > 0:
        return x
    return float(torch.max(x))
