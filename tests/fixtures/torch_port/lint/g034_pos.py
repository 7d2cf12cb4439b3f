# lint-path: deeplearning4j_tpu_torch/nn/_fixture.py
"""graftlint fixture: G034 must fire here (torch spelling),
linted as deeplearning4j_tpu_torch/nn/_fixture.py."""

import torch

from deeplearning4j_tpu_torch.nn.tree import tree_map


def cast(params):
    return tree_map(lambda t: t.to(torch.bfloat16), params)
