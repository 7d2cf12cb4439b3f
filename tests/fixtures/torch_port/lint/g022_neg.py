# lint-path: deeplearning4j_tpu_torch/cli/_fixture.py
"""graftlint fixture: G022 must stay quiet here (torch spelling),
linted as deeplearning4j_tpu_torch/cli/_fixture.py."""

from deeplearning4j_tpu_torch.parallel import make_mesh
from deeplearning4j_tpu_torch.reshard.planner import Placement


def build(net, axes, spec):
    net.set_mesh(Placement.of(spec))
    return make_mesh(axes)
