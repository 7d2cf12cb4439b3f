# lint-path: deeplearning4j_tpu_torch/parallel/_fixture.py
"""graftlint fixture: G013 must stay quiet here (torch spelling),
linted as deeplearning4j_tpu_torch/parallel/_fixture.py."""

import torch.distributed as dist


def report(loss):
    value = loss.item()
    if dist.get_rank() == 0:
        print(value)
    return value
