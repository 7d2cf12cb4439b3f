# lint-path: deeplearning4j_tpu_torch/parallel/_fixture.py
"""graftlint fixture: G010 must fire here (torch spelling),
linted as deeplearning4j_tpu_torch/parallel/_fixture.py."""

import torch.distributed as dist


def step(t):
    if dist.get_rank() == 0:
        dist.all_reduce(t)
    return t
