# lint-path: deeplearning4j_tpu_torch/nn/_fixture.py
"""graftlint fixture: G020 must stay quiet here (torch spelling),
linted as deeplearning4j_tpu_torch/nn/_fixture.py."""

from deeplearning4j_tpu_torch.data.pipeline import iter_prefetched


def fit(net, it, step):
    for _ds, batch in iter_prefetched(it):
        step(batch)
