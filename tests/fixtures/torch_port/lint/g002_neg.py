# lint-path: deeplearning4j_tpu_torch/parallel/_fixture.py
"""graftlint fixture: G002 must stay quiet here (torch spelling),
linted as deeplearning4j_tpu_torch/parallel/_fixture.py."""

import torch


def step(x):
    return torch.sum(x), x.detach()
