"""Long-context training with rematerialization (the port's twin of
examples/long_context_remat.py): `remat=True` recomputes each layer's
activations in the backward pass (torch.utils.checkpoint) instead of
holding them for the whole step, the memory-for-FLOPs trade that lets
longer sequences train on one card. It composes with the flash kernels
(attention never materializes [T, T] scores either way) and with every
set_mesh role; for sequences too long for one card see
sequence_parallel_lm.py. Runs on the card; `--device cpu` runs it on the
CPU."""
import argparse

import numpy as np

from deeplearning4j_tpu_torch.datasets.api import DataSet
from deeplearning4j_tpu_torch.datasets.iterators import ListDataSetIterator
from deeplearning4j_tpu_torch.models.transformer import transformer_lm

ap = argparse.ArgumentParser(description=__doc__)
ap.add_argument("--device", default=None, help="cuda (default) or cpu")
args = ap.parse_args()

VOCAB, SEQ, BATCH = 512, 1024, 2

rng = np.random.default_rng(0)
toks = np.asarray(rng.integers(0, VOCAB, (BATCH, SEQ)), np.int32)
ds = DataSet(toks, np.roll(toks, -1, axis=1))

net = transformer_lm(vocab_size=VOCAB, d_model=64, n_heads=2, n_layers=4,
                     d_ff=128, max_length=SEQ, remat=True,
                     device=args.device)
net.init()

for epoch in range(5):
    net.fit(ListDataSetIterator([ds]), epochs=1)
    print(f"epoch {epoch}: loss {net.score_value:.4f}")
