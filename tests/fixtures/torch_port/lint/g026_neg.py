# lint-path: deeplearning4j_tpu_torch/serving/_fixture.py
"""graftlint fixture: G026 must stay quiet here (torch spelling),
linted as deeplearning4j_tpu_torch/serving/_fixture.py."""

import threading


class Worker:
    def __init__(self):
        self._lock = threading.Lock()
        self.last = None

    def read(self, t):
        value = t.item()
        with self._lock:
            self.last = value
        return value
