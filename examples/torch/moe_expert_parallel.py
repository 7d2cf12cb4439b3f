"""Mixture-of-Experts LM with routed dispatch and expert parallelism
(the port's twin of examples/moe_expert_parallel.py).

Each transformer block's feed-forward is a bank of expert FFNs behind a
learned top-k router (nn/layers/moe.py): tokens are dispatched to their
experts through static-shaped capacity-factor dispatch, and a
Switch-style load-balance loss keeps the router honest.

The experts split over an "expert" role: `net.set_mesh(mesh, axes=
{"expert": ...})` splits them over the ranks of a process group, one
card a rank. On one card the JAX script's {data 2, expert 4} becomes
the experts split over 4 shards held in this process
(`tensor_parallel.place_in_process`): each shard computes its 2 experts'
share and the combine is summed here. Runs on the card; `--device cpu`
runs it on the CPU.
"""
import argparse

import numpy as np

from deeplearning4j_tpu_torch.datasets.api import DataSet
from deeplearning4j_tpu_torch.models.transformer import transformer_moe_lm
from deeplearning4j_tpu_torch.parallel.tensor_parallel import place_in_process

ap = argparse.ArgumentParser(description=__doc__)
ap.add_argument("--device", default=None, help="cuda (default) or cpu")
args = ap.parse_args()

VOCAB, SEQ, BATCH = 512, 64, 8

rng = np.random.default_rng(0)
toks = np.asarray(rng.integers(0, VOCAB, (BATCH, SEQ)), np.int32)
labels = np.eye(VOCAB, dtype=np.float32)[np.roll(toks, -1, axis=1)]
ds = DataSet(toks, labels)

net = transformer_moe_lm(
    vocab_size=VOCAB, d_model=64, n_heads=2, n_layers=2,
    n_experts=8, top_k=2, d_expert_hidden=128, max_length=SEQ,
    routing="routed",        # capacity-factor dispatch (default);
    capacity_factor=1.25,    # "dense" = compute-all-experts oracle
    device=args.device,
)
net.init()

place_in_process(net, 4, role="expert")
split = net._inproc_split
print(f"device: {net.device}, expert shards: 4, split layers: "
      f"{sorted(split.layers)}")
print("expert tensor split:", {"/".join(k): v[:2] for k, v in
                               split.leaves.items() if k[0] == "blk0_moe"})

for epoch in range(5):
    net.fit(ds)
    print(f"epoch {epoch}: loss {float(net.score_value):.4f}")

out = net.output(toks)
print("output:", tuple(out[0].shape))
