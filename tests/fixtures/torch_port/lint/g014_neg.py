# lint-path: deeplearning4j_tpu_torch/parallel/_fixture.py
"""graftlint fixture: G014 must stay quiet here (torch spelling),
linted as deeplearning4j_tpu_torch/parallel/_fixture.py."""

import torch.distributed as dist


def reduce(t):
    try:
        dist.all_reduce(t)
    except Exception:
        print("peer lost")
        raise
    return t
