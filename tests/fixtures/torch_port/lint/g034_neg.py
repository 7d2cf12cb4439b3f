# lint-path: deeplearning4j_tpu_torch/nn/_fixture.py
"""graftlint fixture: G034 must stay quiet here (torch spelling),
linted as deeplearning4j_tpu_torch/nn/_fixture.py."""

import torch

from deeplearning4j_tpu_torch.nn.tree import tree_map


def cast(params):
    w = params["W"].to(torch.bfloat16)
    return w, tree_map(lambda t: t * 0, params)
