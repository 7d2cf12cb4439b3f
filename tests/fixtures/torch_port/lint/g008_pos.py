# lint-path: deeplearning4j_tpu_torch/parallel/_fixture.py
"""graftlint fixture: G008 must fire here (torch spelling),
linted as deeplearning4j_tpu_torch/parallel/_fixture.py."""

import torch

ZERO = torch.zeros(4)


def f(x, acc=[]):
    acc.append(x)
    return acc
