# lint-path: deeplearning4j_tpu_torch/nn/_fixture.py
"""graftlint fixture: G020 must fire here (torch spelling),
linted as deeplearning4j_tpu_torch/nn/_fixture.py."""

def fit(net, it, step):
    while it.has_next():
        ds = it.next()
        batch = net._batch_dict(ds)
        step(batch)
