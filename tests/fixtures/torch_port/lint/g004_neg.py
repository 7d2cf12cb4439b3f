# lint-path: deeplearning4j_tpu_torch/parallel/_fixture.py
"""graftlint fixture: G004 must stay quiet here (torch spelling),
linted as deeplearning4j_tpu_torch/parallel/_fixture.py."""

import numpy as np
import torch


def init(shape, seed):
    gen = torch.Generator().manual_seed(seed)
    rng = np.random.default_rng(seed)
    noise = rng.random(4)
    w = torch.empty(shape).uniform_(-1.0, 1.0, generator=gen)
    return w + torch.randn(shape, generator=gen) + torch.as_tensor(noise)
