# lint-path: deeplearning4j_tpu_torch/parallel/_fixture.py
"""graftlint fixture: G002 must fire here (torch spelling),
linted as deeplearning4j_tpu_torch/parallel/_fixture.py."""

import numpy as np


def step(x):
    y = np.asarray(x)
    return x.item(), x.cpu(), y
