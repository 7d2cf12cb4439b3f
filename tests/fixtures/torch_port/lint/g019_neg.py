# lint-path: deeplearning4j_tpu_torch/serving/_fixture.py
"""graftlint fixture: G019 must stay quiet here (torch spelling),
linted as deeplearning4j_tpu_torch/serving/_fixture.py."""

def emit(tokens, out):
    ids = tokens.cpu().tolist()
    for tok in ids:
        out.append(tok)
