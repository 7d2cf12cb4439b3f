"""6-layer Transformer LM through the DAG builder API with MFU reporting
(the port's twin of examples/transformer_lm.py). Runs on the card;
`--device cpu` runs it on the CPU."""
import argparse

import numpy as np

from deeplearning4j_tpu_torch import resolve_device
from deeplearning4j_tpu_torch.datasets.api import DataSet
from deeplearning4j_tpu_torch.datasets.iterators import ListDataSetIterator
from deeplearning4j_tpu_torch.models.transformer import (
    transformer_flops_per_token,
    transformer_lm,
)
from deeplearning4j_tpu_torch.optimize.listeners import PerformanceListener
from deeplearning4j_tpu_torch.telemetry.costbook import device_kind, peak_flops

ap = argparse.ArgumentParser(description=__doc__)
ap.add_argument("--device", default=None, help="cuda (default) or cpu")
args = ap.parse_args()

VOCAB, SEQ, BATCH = 1000, 128, 8
net = transformer_lm(vocab_size=VOCAB, d_model=128, n_heads=2, n_layers=6,
                     d_ff=512, max_length=SEQ, device=args.device)
net.init()
# the device's own peak (telemetry/costbook.py); informational on the CPU
peak = peak_flops(device_kind(resolve_device(args.device)))
net.set_listeners(PerformanceListener(
    frequency=4, printer=print, examples_per_iteration=BATCH * SEQ,
    flops_per_example=transformer_flops_per_token(VOCAB, 128, 6, 512, SEQ),
    peak_flops=peak))

rng = np.random.default_rng(0)
toks = np.asarray(rng.integers(0, VOCAB, (BATCH, SEQ)), np.int32)
# sparse integer labels: next-token targets, no one-hot materialization
ds = DataSet(toks, np.roll(toks, -1, axis=1))
net.fit(ListDataSetIterator([ds] * 8), epochs=3)
print("final loss:", net.score_value)
