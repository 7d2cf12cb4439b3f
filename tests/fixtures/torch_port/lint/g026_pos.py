# lint-path: deeplearning4j_tpu_torch/serving/_fixture.py
"""graftlint fixture: G026 must fire here (torch spelling),
linted as deeplearning4j_tpu_torch/serving/_fixture.py."""

import threading

import torch


class Worker:
    def __init__(self):
        self._lock = threading.Lock()

    def read(self, t):
        with self._lock:
            value = t.item()
            torch.cuda.synchronize()
        return value
