# lint-path: deeplearning4j_tpu_torch/serving/_fixture.py
"""graftlint fixture: G017 must stay quiet here (torch spelling),
linted as deeplearning4j_tpu_torch/serving/_fixture.py."""

import torch


def model(x):
    return x


fwd = torch.compile(model)


def handle_batch(padded):
    return fwd(padded)


def finish(requests, out):
    values = out.cpu()
    for req in requests:
        req.value = values[req.row]
