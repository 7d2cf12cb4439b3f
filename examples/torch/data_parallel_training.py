"""ResNet-20 under allreduce data parallelism on a device mesh (the
port's twin of examples/data_parallel_training.py).

One process holds one device under torch.distributed: run alone, this
forms a fleet of one (NCCL on the card, gloo with `--device cpu`);
started as N ranks by `distributed.launcher.launch_local`, the same code
shards the batch over them.
"""
import argparse

import numpy as np

from deeplearning4j_tpu_torch.datasets.api import DataSet
from deeplearning4j_tpu_torch.datasets.iterators import ListDataSetIterator
from deeplearning4j_tpu_torch.distributed import bootstrap
from deeplearning4j_tpu_torch.models.resnet import resnet20
from deeplearning4j_tpu_torch.parallel.data_parallel import (
    DataParallelTrainer,
    ParameterAveragingTrainer,
)
from deeplearning4j_tpu_torch.parallel.mesh import make_mesh
from deeplearning4j_tpu_torch.reshard.search import FleetShape, search_placement

ap = argparse.ArgumentParser(description=__doc__)
ap.add_argument("--device", default=None, help="cuda (default) or cpu")
args = ap.parse_args()

rng = np.random.default_rng(0)
x = rng.random((64, 32, 32, 3), dtype=np.float32)
y = np.eye(10, dtype=np.float32)[rng.integers(0, 10, 64)]
batches = ListDataSetIterator([DataSet(x, y)] * 4)

net = resnet20(device=args.device)
net.init()

# the cost model picks the mesh (automatic placement search,
# reshard/search.py): pure dp over every rank wins this fleet shape, and
# the trainers consume the winner's axes instead of a hand-guessed layout
world = bootstrap.initialize(device=args.device)["num_processes"]
search = search_placement(net, FleetShape(world, 1))
mesh = make_mesh(dict(search.winner.mesh_axes))
DataParallelTrainer(net, mesh).fit(batches)        # in-step allreduce
print("allreduce DP loss:", net.score_value)
print("sharded eval accuracy:", net.evaluate(DataSet(x, y)).accuracy())

net2 = resnet20(device=args.device)
net2.init()
ParameterAveragingTrainer(net2, mesh, averaging_frequency=2).fit(batches)
print("param-averaging loss:", net2.score_value)   # reference-parity mode
bootstrap.shutdown()
