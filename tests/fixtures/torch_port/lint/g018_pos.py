# lint-path: deeplearning4j_tpu_torch/parallel/_fixture.py
"""graftlint fixture: G018 must fire here (torch spelling),
linted as deeplearning4j_tpu_torch/parallel/_fixture.py."""

import numpy as np

from deeplearning4j_tpu_torch.nn.tree import tree_map


def dump(net, params):
    host = np.asarray(params)
    return host, tree_map(lambda t: t.cpu(), net.params)
