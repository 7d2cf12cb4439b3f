# lint-path: deeplearning4j_tpu_torch/parallel/_fixture.py
"""graftlint fixture: G011 must fire here (torch spelling),
linted as deeplearning4j_tpu_torch/parallel/_fixture.py."""

import time

import torch


def noise(shape):
    t0 = time.time()
    return torch.full(shape, t0)
