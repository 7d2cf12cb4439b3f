# lint-path: deeplearning4j_tpu_torch/ops/_fixture.py
"""graftlint fixture: G031 must stay quiet here (torch spelling),
linted as deeplearning4j_tpu_torch/ops/_fixture.py."""

import torch


def scores(a, b):
    s = torch.einsum("ij,jk->ik", a.float(), b.float())
    af, bf = a.float(), b.float()
    return s, af @ bf.T
