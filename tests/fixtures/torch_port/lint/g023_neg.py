# lint-path: deeplearning4j_tpu_torch/nn/_fixture.py
"""graftlint fixture: G023 must stay quiet here (torch spelling),
linted as deeplearning4j_tpu_torch/nn/_fixture.py."""

def record(rec, m):
    rec.event("step")
    with rec.span("forward"):
        pass
    return m.span(0)
