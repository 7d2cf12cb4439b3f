# lint-path: deeplearning4j_tpu_torch/serving/_fixture.py
"""graftlint fixture: G021 must stay quiet here (torch spelling),
linted as deeplearning4j_tpu_torch/serving/_fixture.py."""

def read(ws):
    return ws.params
