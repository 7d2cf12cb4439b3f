# lint-path: deeplearning4j_tpu_torch/parallel/_fixture.py
"""graftlint fixture: G010 must stay quiet here (torch spelling),
linted as deeplearning4j_tpu_torch/parallel/_fixture.py."""

import torch.distributed as dist


def step(t):
    if dist.get_rank() == 0:
        print("rank 0 logs")
    dist.all_reduce(t)
    return t
