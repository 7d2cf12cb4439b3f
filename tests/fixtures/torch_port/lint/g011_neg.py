# lint-path: deeplearning4j_tpu_torch/parallel/_fixture.py
"""graftlint fixture: G011 must stay quiet here (torch spelling),
linted as deeplearning4j_tpu_torch/parallel/_fixture.py."""

import time

import torch


def noise(shape):
    t0 = time.time()
    out = torch.full(shape, 0.5)
    print("took", time.time() - t0)
    return out
