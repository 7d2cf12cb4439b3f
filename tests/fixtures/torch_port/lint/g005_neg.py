# lint-path: deeplearning4j_tpu_torch/parallel/_fixture.py
"""graftlint fixture: G005 must stay quiet here (torch spelling),
linted as deeplearning4j_tpu_torch/parallel/_fixture.py."""

import torch


def body(x):
    return x * 2


step = torch.compile(body)


def run(x):
    return step(x)
