"""Device meshes over processes (JAX counterpart
deeplearning4j_tpu/parallel/mesh.py).

A JAX `Mesh` arranges the devices of one program on named axes. The
port runs one process per device under `torch.distributed`, so its
`Mesh` arranges the RANKS of the default process group on named axes,
row-major in axis order (rank r sits where device r sits in the JAX
package's mesh), and gives each axis the process group of the ranks
that share every other coordinate. Axis conventions:

- "data": data parallelism (the gradient all-reduce);
- "seq":  sequence parallelism (ring attention);
- "model": tensor parallelism (Megatron's split of attention heads and
  feed-forward units);
- "expert": expert parallelism (a MoE layer's experts split);
- "pipe": pipeline parallelism (a stage of the layer stack a rank,
  parallel/pipeline.py).

`make_mesh` brings the process group up itself when it is not yet
(`distributed.bootstrap.initialize`: from the launcher's env contract,
else a fleet of one), so a single-card run needs no launcher.
"""

from __future__ import annotations

import itertools
import math

import numpy as np

from deeplearning4j_tpu_torch.data.sharding import process_slice


class Mesh:
    """Named axes over the ranks of the default process group.

    axis_names: the axes in order; shape: {axis: size}; device: this
    rank's device; group(axis): the process group along `axis` that
    holds this rank; axis_index(axis) / axis_size(axis): this rank's
    coordinate and the axis length."""

    def __init__(self, axes, device, groups, coords, rank):
        self.axis_names = tuple(axes)
        self.shape = dict(axes)
        self.device = device
        self.rank = rank
        self._groups = groups
        self._coords = coords

    @property
    def size(self) -> int:
        return math.prod(self.shape.values())

    def group(self, axis: str):
        return self._groups[axis]

    def axis_index(self, axis: str) -> int:
        return self._coords[axis]

    def axis_size(self, axis: str) -> int:
        return self.shape[axis]

    def coords_of(self, rank: int) -> dict:
        """{axis: coordinate} of any rank of the mesh."""
        sizes = [self.shape[a] for a in self.axis_names]
        return dict(zip(self.axis_names, (int(c) for c in np.unravel_index(
            rank, sizes))))

    def rank_of(self, coords: dict) -> int:
        """The rank at `coords` ({axis: coordinate}; an axis left out
        takes this rank's own coordinate)."""
        sizes = [self.shape[a] for a in self.axis_names]
        full = [int(coords.get(a, self._coords[a])) for a in self.axis_names]
        return int(np.ravel_multi_index(full, sizes))

    def subgroup(self, axes):
        """The process group of the ranks that share every coordinate
        but those of `axes` (one axis: `group(axis)`). Every rank must
        make the first call for a set of axes, in the same order: the
        groups are created collectively."""
        import torch.distributed as dist

        axes = tuple(a for a in self.axis_names if a in set(axes))
        if len(axes) == 1:
            return self._groups[axes[0]]
        cache = self.__dict__.setdefault("_subgroups", {})
        if axes not in cache:
            others = [a for a in self.axis_names if a not in axes]
            mine = None
            for rest in itertools.product(*(range(self.shape[a])
                                            for a in others)):
                fixed = dict(zip(others, rest))
                members = sorted(
                    self.rank_of({**fixed, **dict(zip(axes, c))})
                    for c in itertools.product(*(range(self.shape[a])
                                                 for a in axes)))
                g = (dist.group.WORLD if len(members) == self.size
                     else dist.new_group(members))
                if self.rank in members:
                    mine = g
            cache[axes] = mine
        return cache[axes]

    def __repr__(self):
        return (f"Mesh({self.shape}, rank={self.rank}, "
                f"device={self.device})")


def _axis_sizes(axes, n_ranks):
    axes = dict(axes or {"data": -1})
    sizes = list(axes.values())
    n_fixed = int(np.prod([s for s in sizes if s != -1])) if sizes else 1
    if -1 in sizes:
        rem = n_ranks // max(n_fixed, 1)
        sizes = [rem if s == -1 else s for s in sizes]
    total = int(np.prod(sizes))
    if total > n_ranks:
        raise ValueError(f"mesh {dict(zip(axes, sizes))} needs {total} "
                         f"devices, have {n_ranks}")
    if total != n_ranks:
        raise ValueError(
            f"mesh {dict(zip(axes, sizes))} covers {total} of the "
            f"{n_ranks} ranks; every rank of the process group must sit "
            "in the mesh (one process per device)")
    return dict(zip(axes, sizes))


def make_mesh(axes: dict | None = None, *, device=None) -> Mesh:
    """Build a Mesh from {axis: size} over every rank of the default
    process group; -1 means 'all remaining ranks'.

    make_mesh({"data": -1})               # pure DP over every rank
    make_mesh({"data": 2, "seq": 2})      # 2-way DP x 2-way SP

    Every rank must call it, with the same axes (the process groups are
    created collectively). `device` is this process's device when the
    process group is not up yet (CUDA unless the caller names another)."""
    import torch.distributed as dist

    from deeplearning4j_tpu_torch.distributed import bootstrap

    if not bootstrap.is_initialized():
        bootstrap.initialize(device=device)
    world, rank = dist.get_world_size(), dist.get_rank()
    shape = _axis_sizes(axes, world)
    names = list(shape)
    sizes = [shape[a] for a in names]
    coords = dict(zip(names, (int(c) for c in
                              np.unravel_index(rank, sizes))))
    groups = {}
    for a_i, axis in enumerate(names):
        others = [range(s) for j, s in enumerate(sizes) if j != a_i]
        for rest in itertools.product(*others):
            members = []
            for c in range(sizes[a_i]):
                full = list(rest)
                full.insert(a_i, c)
                members.append(int(np.ravel_multi_index(full, sizes)))
            if len(members) == world:
                g = dist.group.WORLD
            else:
                g = dist.new_group(members)
            if rank in members:
                groups[axis] = g
    return Mesh(shape, bootstrap.process_device(), groups, coords, rank)


def data_shards(mesh, axis: str = "data"):
    """The "data" split of a sharded loop, as (n, the shard indices this
    process computes, the process group or None): a `Mesh` gives its
    `axis` over the process group (this rank's one shard);
    `ops.shard_comm.InProcessShards(n)` gives n shards in this process
    (the caller sums their results in shard order)."""
    from deeplearning4j_tpu_torch.ops.shard_comm import InProcessShards

    if isinstance(mesh, InProcessShards):
        return mesh.n, tuple(range(mesh.n)), None
    if not isinstance(mesh, Mesh) or axis not in mesh.shape:
        raise ValueError(f"a data-sharded loop needs a parallel.Mesh with a "
                         f"{axis!r} axis or an InProcessShards, got {mesh!r}")
    return mesh.shape[axis], (mesh.axis_index(axis),), mesh.group(axis)


def spans_processes(mesh: Mesh) -> bool:
    """True when the mesh's devices live in more than one OS process —
    in the port, whenever it has more than one device."""
    return mesh.size > 1


def local_slice(n_rows: int, mesh: Mesh, axis: str = "data") -> slice:
    """This rank's contiguous rows of `n_rows` along `axis`
    (`data/sharding.process_slice`); all rows when the mesh lacks it."""
    if axis not in mesh.shape:
        return slice(0, n_rows)
    return process_slice(n_rows, mesh.axis_index(axis),
                         mesh.axis_size(axis))


def shard_batch(batch, mesh: Mesh, axis: str = "data"):
    """This rank's rows of every leaf of a host or device batch (a
    tensor, an array, or dicts / lists / tuples of them) along `axis`,
    as tensors on the mesh's device: the local shard of a leading dim
    sharded over `axis`."""
    import torch

    def leaf(x):
        if x is None:
            return None
        t = torch.as_tensor(np.asarray(x) if not isinstance(  # graftlint: disable=G002 — host arrays
            x, torch.Tensor) else x)
        if t.ndim:
            t = t[local_slice(t.shape[0], mesh, axis)]
        return t.to(mesh.device)

    return map_leaves(leaf, batch)


def replicate(tree, mesh: Mesh):
    """Make every tensor of `tree` equal rank 0's, in place (a broadcast
    from rank 0 over the mesh), and return it."""
    import torch
    import torch.distributed as dist

    def leaf(t):
        if isinstance(t, torch.Tensor) and mesh.size > 1:
            dist.broadcast(t, src=0)
        return t

    return map_leaves(leaf, tree)


def map_leaves(fn, tree):
    """`fn` applied to every leaf of nested dicts / lists / tuples."""
    if isinstance(tree, dict):
        return {k: map_leaves(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(map_leaves(fn, v) for v in tree)
    return fn(tree)
