# lint-path: deeplearning4j_tpu_torch/serving/_fixture.py
"""graftlint fixture: G019 must fire here (torch spelling),
linted as deeplearning4j_tpu_torch/serving/_fixture.py."""

def emit(tokens, out):
    for tok in tokens:
        out.append(tok.item())
