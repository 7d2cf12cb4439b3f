# lint-path: deeplearning4j_tpu_torch/parallel/_fixture.py
"""graftlint fixture: G009 must fire here (torch spelling),
linted as deeplearning4j_tpu_torch/parallel/_fixture.py."""

import os

import torch.distributed as dist


def start():
    dist.init_process_group("nccl")
    return os.environ["DL4J_TPU_PROCESS_ID"]
