# lint-path: deeplearning4j_tpu_torch/serving/_fixture.py
"""graftlint fixture: G024 must fire here (torch spelling),
linted as deeplearning4j_tpu_torch/serving/_fixture.py."""

import numpy as np


def sample(logits, n):
    out = []
    for tok in range(n):
        order = logits.argsort()
        out.append(np.random.choice(order[:8]))
    return out
