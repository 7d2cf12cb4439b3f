# lint-path: deeplearning4j_tpu_torch/serving/_fixture.py
"""graftlint fixture: G029 must fire here (torch spelling),
linted as deeplearning4j_tpu_torch/serving/_fixture.py."""

import torch


def serve(requests, handle):
    for req in requests:
        handle(req)
        torch.cuda.memory_allocated()
