"""Data-parallel training, one rank per replica (JAX counterpart
deeplearning4j_tpu/parallel/data_parallel.py).

Two modes, mirroring the reference's two Spark training masters:

1. **All-reduce** — `DataParallelTrainer`: each rank steps on its rows
   of every global batch and the gradients are mean-reduced over the
   mesh's "data" axis inside the step (nn/training.make_train_step),
   in one all-reduce after the backward (monolithic: the one-device
   result on the global batch) or bucket by bucket during it
   (`overlap=`, parallel/overlap.py).
2. **Parameter averaging** — `ParameterAveragingTrainer`: each rank
   holds its own replica params and updater state, runs k local steps
   with no collective, then averages params, layer state and (by
   default) updater moments every k steps — the reference's
   averagingFrequency semantics, integer counters kept.
"""

from __future__ import annotations

import warnings

from deeplearning4j_tpu_torch.datasets.api import DataSet, MultiDataSet
from deeplearning4j_tpu_torch.datasets.iterators import (
    DataSetIterator,  # noqa: F401
    ListDataSetIterator,
)


class DataParallelTrainer:
    """All-reduce DP wrapper around a network (MultiLayerNetwork or
    ComputationGraph): `trainer.fit(iterator)` == network.fit with the
    step built for the mesh. `overlap` (True / bucket bytes / a
    parallel/overlap.BucketPlan) reduces the gradients bucket by bucket
    while the backward runs instead of in one all-reduce after it."""

    def __init__(self, net, mesh, overlap=None):
        if "data" not in mesh.axis_names:
            raise ValueError("mesh needs a 'data' axis")
        self.net = net
        self.mesh = mesh
        net.set_mesh(mesh, overlap=overlap)

    def fit(self, data, epochs: int = 1):
        return self.net.fit(data, epochs=epochs)


class ParameterAveragingTrainer:
    """Reference-parity parameter averaging (k local steps, then
    average). Every replica is one rank of the mesh's "data" axis; the
    net's params, state and optimizer state ARE this rank's replica. One
    step generator serves every replica, as the JAX package passes one
    key to all of them: the ranks' generators start equal and advance
    alike."""

    def __init__(self, net, mesh, averaging_frequency: int = 1,
                 average_updater_state: bool = True):
        from deeplearning4j_tpu_torch.nn.training import make_train_step
        from deeplearning4j_tpu_torch.nn.updater import named_layer_confs
        from deeplearning4j_tpu_torch.parallel.mesh import replicate

        if "data" not in mesh.axis_names:
            raise ValueError("mesh needs a 'data' axis")
        self.net = net
        self.mesh = mesh
        self.k = max(1, averaging_frequency)
        self.average_updater = average_updater_state
        self.n_replicas = mesh.axis_size("data")
        self._group = mesh.group("data")
        if net.params is None:
            net.init()
        if mesh.device.type != net.device.type:
            raise ValueError(f"the net lives on {net.device} but this "
                             f"rank's mesh device is {mesh.device}")
        net.device = mesh.device
        for t in (net.params, net.state, net.opt_state):
            replicate(t, mesh)
        self._local_steps = 0
        self._warned_truncation = False
        self._step = make_train_step(net._loss, net.tx,
                                     named_layer_confs(net))

    def _convert(self, ds):
        """Prefetch-thread batch prep: the replica truncation, this
        rank's rows, the tensors on the device."""
        from deeplearning4j_tpu_torch.parallel.placement import shard_dataset

        n = self.n_replicas
        b = (ds.features[0] if isinstance(ds, MultiDataSet)
             else ds.features).shape[0]
        per = b // n
        if per == 0:
            raise ValueError(
                f"batch of {b} examples cannot be split over {n} "
                f"replicas — use batches of at least {n} examples")
        if per * n != b and not self._warned_truncation:
            warnings.warn(
                f"batch size {b} is not divisible by {n} replicas; "
                f"the last {b - per * n} examples of each such batch "
                f"are dropped", stacklevel=2)
            self._warned_truncation = True
        net = self.net
        local = shard_dataset(ds, self.mesh, "data", n_rows=per * n)
        if hasattr(net, "_to_mds"):
            # ComputationGraph: the multi-input batch format
            local = net._to_mds(local)
        return net._batch_dict(local)

    def _average(self):
        """Average float params, layer state and (optionally) updater
        moments over the replicas; integer counters pass through."""
        from deeplearning4j_tpu_torch.nn import tree
        from deeplearning4j_tpu_torch.parallel.overlap import (
            pmean_float_leaves,
        )

        net, g, n = self.net, self._group, self.n_replicas
        avg = pmean_float_leaves(net.params, g, n)
        for path, t in tree.leaves(avg):
            tree.get(net.params, path).copy_(t)
        net.state = pmean_float_leaves(net.state, g, n)
        if self.average_updater:
            net.opt_state = pmean_float_leaves(net.opt_state, g, n)

    def fit(self, data, epochs: int = 1):
        """Each incoming minibatch is split across the replicas (the RDD
        partition analogue); every k local steps they are averaged."""
        from deeplearning4j_tpu_torch.data.pipeline import iter_prefetched
        from deeplearning4j_tpu_torch.parallel.overlap import (
            reduce_gradients,
        )

        net = self.net
        if isinstance(data, (DataSet, MultiDataSet)):
            data = ListDataSetIterator([data])
        for _ in range(epochs):
            data.reset()
            for _ds, batch in iter_prefetched(data, self._convert):
                net.params, net.opt_state, net.state, loss, _ = self._step(
                    net.params, net.opt_state, net.state, net._generator,
                    batch)
                self._local_steps += 1
                if self._local_steps % self.k == 0:
                    self._average()
                net._after_step(reduce_gradients(
                    {"l": loss}, [(self._group, self.n_replicas)])["l"])
        self.sync_to_network()
        return net

    def sync_to_network(self):
        """Make every replica's params and state replica 0's (the JAX
        package writes replica 0 back to the net)."""
        from deeplearning4j_tpu_torch.parallel.mesh import replicate

        replicate(self.net.params, self.mesh)
        replicate(self.net.state, self.mesh)
        return self.net
