# lint-path: deeplearning4j_tpu_torch/nlp/_fixture.py
"""graftlint fixture: G030 must stay quiet here (torch spelling),
linted as deeplearning4j_tpu_torch/nlp/_fixture.py."""

import torch


def lookup(weights, idx, engine):
    rows = torch.index_select(weights, 0, idx)
    return rows, engine.embed(idx)
