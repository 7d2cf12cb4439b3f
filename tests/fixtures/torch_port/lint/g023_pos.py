# lint-path: deeplearning4j_tpu_torch/nn/_fixture.py
"""graftlint fixture: G023 must fire here (torch spelling),
linted as deeplearning4j_tpu_torch/nn/_fixture.py."""

def record(rec):
    rec.event("not_a_registered_kind")
    with rec.span("bogus_span"):
        pass
