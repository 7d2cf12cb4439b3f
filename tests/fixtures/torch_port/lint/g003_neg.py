# lint-path: deeplearning4j_tpu_torch/parallel/_fixture.py
"""graftlint fixture: G003 must stay quiet here (torch spelling),
linted as deeplearning4j_tpu_torch/parallel/_fixture.py."""

import numpy as np
import torch


def f(x):
    w = torch.from_numpy(np.arange(5, dtype=np.float32))
    return torch.matmul(x, w)


def host_only():
    return np.arange(5)
