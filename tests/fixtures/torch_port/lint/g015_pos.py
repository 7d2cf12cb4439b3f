# lint-path: deeplearning4j_tpu_torch/parallel/_fixture.py
"""graftlint fixture: G015 must fire here (torch spelling),
linted as deeplearning4j_tpu_torch/parallel/_fixture.py."""

import torch.distributed as dist


def sync(grads_flat, group):
    dist.all_reduce(grads_flat, group=group)
    return grads_flat
