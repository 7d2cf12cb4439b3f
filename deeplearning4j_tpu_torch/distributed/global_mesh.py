"""Process-spanning meshes and host-data globalization (JAX counterpart
deeplearning4j_tpu/distributed/global_mesh.py).

In the JAX package a process can hand jax data only for its own devices,
so each process's slice of the global batch is assembled into a global
`jax.Array` (`globalize_batch`). In the port every device is its own
process and a global array sharded over "data" IS each rank's rows: the
helpers below place this rank's part on its device. The split is the
one rule of `data/sharding.process_slice` (process-major contiguous
rows), so iterator sharding and host-array sharding agree on which rows
a rank owns.
"""

from __future__ import annotations

import numpy as np

from deeplearning4j_tpu_torch.data.sharding import local_rows
from deeplearning4j_tpu_torch.parallel.mesh import (
    make_mesh,
    map_leaves,
    shard_batch,
    spans_processes,
)

__all__ = ["globalize_batch", "globalize_full", "local_shard",
           "make_global_mesh", "spans_processes"]


def make_global_mesh(axes=None, *, device=None):
    """A Mesh over every rank of the fleet (process-major: rank r is
    device r). Same axes spec as `parallel.mesh.make_mesh`; defaults to
    pure DP."""
    return make_mesh(axes or {"data": -1}, device=device)


def globalize_batch(batch, mesh, data_axis: str = "data"):
    """This rank's local batch shard as the global batch's part on this
    rank: every leaf (this rank's rows already) moved to the mesh's
    device. ``data_axis=None`` (or one the mesh lacks) means the leaves
    are replicated: every rank holds the full, identical value."""
    import torch

    def leaf(x):
        if x is None:
            return None
        t = x if isinstance(x, torch.Tensor) else torch.as_tensor(
            np.asarray(x))
        return t.to(mesh.device)

    return map_leaves(leaf, batch)


def globalize_full(x, mesh, data_axis: str = "data"):
    """This rank's part of a FULL host value held identically on every
    rank (the inference path): its rows when the mesh has `data_axis`,
    else the whole value, on the mesh's device."""
    if data_axis and data_axis in mesh.shape:
        return shard_batch(x, mesh, data_axis)
    return globalize_batch(x, mesh, None)


def local_shard(x, axis: int = 0):
    """This process's contiguous slice of a full host array: process i of
    N gets rows [i*B/N, (i+1)*B/N) (`data/sharding.local_rows`)."""
    import torch.distributed as dist

    return local_rows(x, dist.get_rank(), dist.get_world_size(), axis=axis)
