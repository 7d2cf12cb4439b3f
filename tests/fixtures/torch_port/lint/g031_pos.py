# lint-path: deeplearning4j_tpu_torch/ops/_fixture.py
"""graftlint fixture: G031 must fire here (torch spelling),
linted as deeplearning4j_tpu_torch/ops/_fixture.py."""

import torch


def scores(a, b):
    s = torch.einsum("ij,jk->ik", a, b)
    return s, a @ b
