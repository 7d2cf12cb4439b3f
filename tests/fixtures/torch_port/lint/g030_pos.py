# lint-path: deeplearning4j_tpu_torch/nlp/_fixture.py
"""graftlint fixture: G030 must fire here (torch spelling),
linted as deeplearning4j_tpu_torch/nlp/_fixture.py."""

import torch


def lookup(syn0, idx, grads):
    rows = torch.index_select(syn0, 0, idx)
    again = syn0[idx]
    dense = torch.zeros_like(syn0).index_add_(0, idx, grads)
    return rows, again, dense
