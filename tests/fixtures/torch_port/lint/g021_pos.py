# lint-path: deeplearning4j_tpu_torch/serving/_fixture.py
"""graftlint fixture: G021 must fire here (torch spelling),
linted as deeplearning4j_tpu_torch/serving/_fixture.py."""

def swap(engine, net, new_params, ckpt):
    engine.net.params = new_params
    net.resume_from(ckpt)
