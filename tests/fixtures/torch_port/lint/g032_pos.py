# lint-path: deeplearning4j_tpu_torch/nn/_fixture.py
"""graftlint fixture: G032 must fire here (torch spelling),
linted as deeplearning4j_tpu_torch/nn/_fixture.py."""

import torch


def widen(x):
    y = x.to(torch.float64)
    z = torch.zeros(3, dtype=torch.float64)
    return y, z, x.double()
