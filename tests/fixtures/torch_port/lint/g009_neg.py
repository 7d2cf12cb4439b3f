# lint-path: deeplearning4j_tpu_torch/parallel/_fixture.py
"""graftlint fixture: G009 must stay quiet here (torch spelling),
linted as deeplearning4j_tpu_torch/parallel/_fixture.py."""

import os

from deeplearning4j_tpu_torch.distributed import bootstrap


def start():
    bootstrap.initialize()
    return os.environ[bootstrap.ENV_PROCESS_ID]
