# lint-path: deeplearning4j_tpu_torch/parallel/_fixture.py
"""graftlint fixture: G015 must stay quiet here (torch spelling),
linted as deeplearning4j_tpu_torch/parallel/_fixture.py."""

import torch.distributed as dist

from deeplearning4j_tpu_torch.parallel.overlap import reduce_gradients


def sync(loss, grads, groups):
    dist.all_reduce(loss)
    return reduce_gradients(grads, groups)
