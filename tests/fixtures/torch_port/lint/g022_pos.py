# lint-path: deeplearning4j_tpu_torch/cli/_fixture.py
"""graftlint fixture: G022 must fire here (torch spelling),
linted as deeplearning4j_tpu_torch/cli/_fixture.py."""

from torch.distributed.device_mesh import init_device_mesh

from deeplearning4j_tpu_torch.parallel import make_mesh


def build():
    raw = init_device_mesh("cuda", (2,))
    return raw, make_mesh({"data": 2})
