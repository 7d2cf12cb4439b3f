# lint-path: deeplearning4j_tpu_torch/parallel/_fixture.py
"""graftlint fixture: G018 must stay quiet here (torch spelling),
linted as deeplearning4j_tpu_torch/parallel/_fixture.py."""

import numpy as np

from deeplearning4j_tpu_torch.nn.tree import tree_map


def dump(net, params):
    w = np.asarray(params["W"])
    return w, tree_map(lambda t: t * 2, net.params)
