# lint-path: deeplearning4j_tpu_torch/serving/_fixture.py
"""graftlint fixture: G017 must fire here (torch spelling),
linted as deeplearning4j_tpu_torch/serving/_fixture.py."""

import torch


def model(x):
    return x


fwd = torch.compile(model)


def handle(request):
    return fwd(request.tokens)


def finish(requests, out):
    for req in requests:
        req.value = out[req.row].item()
