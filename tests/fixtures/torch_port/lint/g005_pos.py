# lint-path: deeplearning4j_tpu_torch/parallel/_fixture.py
"""graftlint fixture: G005 must fire here (torch spelling),
linted as deeplearning4j_tpu_torch/parallel/_fixture.py."""

import torch


def run(f, x):
    return torch.compile(f)(x)


def sweep(f, xs):
    for x in xs:
        g = torch.compile(f)
        g(x)
