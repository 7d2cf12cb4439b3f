"""Demo stage-5 fixture of the port: a hand-written FORWARD bf16
accumulation, the silent-precision shape graftlint's precision stage
exists to catch (the torch twin of tests/fixtures/precision_bf16_entry.py).

`python3 port_tools/graftlint.py --check --stage precision --device cpu
tests/fixtures/torch_port/precision_bf16_entry.py` must exit non-zero
with a P001 finding: the loop below sums the rows of a bf16 product into
a bf16 accumulator, so the running sum drops low bits on every row —
the loss-flattens-late bug class the f32-accumulation policy prevents.
It runs outside autograd's backward, so the accumulation checks apply in
full.

The GRAFTLINT_PRECISION_ENTRIES hook is the external-entry contract of
deeplearning4j_tpu_torch/analysis/precision_audit.py: {name: builder},
builder() -> (fn, args).
"""


def build_bf16_sum_over_mm():
    import numpy as np
    import torch

    def fn(x, w):
        y = x @ w  # a bf16 product
        acc = torch.zeros(64, dtype=torch.bfloat16)
        for row in y:
            acc = acc + row  # a bf16 running sum: drops low bits
        return acc

    rng = np.random.default_rng(0)
    x, w = (torch.as_tensor(rng.standard_normal((64, 64),
                                                dtype=np.float32))
            .to(torch.bfloat16) for _ in range(2))
    return fn, (x, w)


GRAFTLINT_PRECISION_ENTRIES = {
    "demo/bf16_sum_over_mm": build_bf16_sum_over_mm,
}
