# lint-path: deeplearning4j_tpu_torch/parallel/_fixture.py
"""graftlint fixture: G008 must stay quiet here (torch spelling),
linted as deeplearning4j_tpu_torch/parallel/_fixture.py."""

import numpy as np
import torch

ZERO = np.zeros(4, dtype=np.float32)


def f(x, acc=None):
    acc = [] if acc is None else acc
    acc.append(torch.zeros(4))
    return acc
