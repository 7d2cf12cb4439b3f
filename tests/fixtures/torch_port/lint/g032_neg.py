# lint-path: deeplearning4j_tpu_torch/nn/_fixture.py
"""graftlint fixture: G032 must stay quiet here (torch spelling),
linted as deeplearning4j_tpu_torch/nn/_fixture.py."""

import torch

DTYPES = {"float64": torch.float64, "float32": torch.float32}


def narrow(x, name):
    return x.float(), x.to(DTYPES[name])
