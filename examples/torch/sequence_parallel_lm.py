"""Sequence-parallel transformer training: the TIME dimension sharded
over the mesh, attention running as a ring over the flash kernels so no
device ever holds the full sequence (the port's twin of
examples/sequence_parallel_lm.py).

One process holds one device: run alone this is a fleet of one (NCCL
on the card, gloo with `--device cpu`), whose mesh is 1 x 1 and whose
ring has one block, as the JAX script's is on one chip; started as N
ranks by `distributed.launcher.launch_local` the same code shards the
batch and the sequence over them.

The JAX script's 4 heads of 16 stay: head dim 16 runs on the f32 flash
kernels (the bf16 ones start at 32).
"""
import argparse

import numpy as np

from deeplearning4j_tpu_torch.datasets.api import DataSet
from deeplearning4j_tpu_torch.datasets.iterators import ListDataSetIterator
from deeplearning4j_tpu_torch.distributed import bootstrap
from deeplearning4j_tpu_torch.models.transformer import transformer_lm
from deeplearning4j_tpu_torch.parallel.mesh import make_mesh
from deeplearning4j_tpu_torch.parallel.sequence_parallel import (
    SequenceParallelTrainer,
)
from deeplearning4j_tpu_torch.reshard.planner import Placement

ap = argparse.ArgumentParser(description=__doc__)
ap.add_argument("--device", default=None, help="cuda (default) or cpu")
args = ap.parse_args()

VOCAB, SEQ, BATCH = 512, 256, 4

rng = np.random.default_rng(0)
toks = np.asarray(rng.integers(0, VOCAB, (BATCH, SEQ)), np.int32)
ds = DataSet(toks, np.roll(toks, -1, axis=1))

# 2-D mesh: batch over 'data', time over 'seq' (degrade gracefully on a
# fleet of few ranks, e.g. one card). The layout is declared as a
# validated Placement (reshard/planner.py), never a raw axis dict.
n = min(8, bootstrap.initialize(device=args.device)["num_processes"])
data_ax = 2 if n >= 4 else 1
placement = Placement.of({"data": data_ax, "seq": n // data_ax},
                         {"data": "data", "seq": "seq"})
mesh = make_mesh(dict(placement.mesh_axes))

# the conf carries the axis name: attention becomes the K/V ring, the
# positional encodings offset by each shard's global position
net = transformer_lm(vocab_size=VOCAB, d_model=64, n_heads=4, n_layers=2,
                     d_ff=128, max_length=SEQ, seq_parallel_axis="seq",
                     device=args.device)
net.init()

trainer = SequenceParallelTrainer(net, mesh, seq_axis="seq",
                                  data_axis="data")
for epoch in range(5):
    trainer.fit(ListDataSetIterator([ds]), epochs=1)
    print(f"epoch {epoch}: loss {net.score_value:.4f}")

# the SAME net serves ordinary single-process inference: outside the
# mesh the SP layers run whole-sequence attention
net.set_mesh(None)
out = net.output(toks)
print("inference output:", tuple(out.shape))
bootstrap.shutdown()
