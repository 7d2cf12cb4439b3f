# lint-path: deeplearning4j_tpu_torch/serving/_fixture.py
"""graftlint fixture: G024 must stay quiet here (torch spelling),
linted as deeplearning4j_tpu_torch/serving/_fixture.py."""

from deeplearning4j_tpu_torch.ops.fused_sampling import fused_sample


def sample(logits, n, emit):
    ids = fused_sample(logits)
    for tok in ids.cpu().tolist():
        emit(tok)
