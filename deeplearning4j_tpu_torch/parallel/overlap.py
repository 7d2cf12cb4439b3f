"""Bucketed gradient reduction with compute/communication overlap (JAX
counterpart deeplearning4j_tpu/parallel/overlap.py).

The monolithic data-parallel step reduces every gradient in one
collective after the backward ends. Here the gradient tree is cut into
size-targeted **buckets** in *reverse layer order* (the gradients the
backward produces first reduce first), one flat all-reduce each. The
JAX package hands XLA's async-collective scheduler the per-bucket
`psum`s; the port launches each bucket's asynchronous all-reduce from
gradient hooks the moment the last of its leaves has its gradient, so
the reduction of late layers runs while the backward of early layers
still computes.

`BucketPlan` is pure metadata derived from the param tree's structure
and sizes — identical on every rank by construction, and equal to the
JAX package's plan of the same tree (`summary()`), since the port's
params nest like the JAX package's and flatten in its order (sorted
keys). A plan of mode "psum_scatter" reduces each bucket as a
reduce-scatter then an all-gather (the same sums, the decomposed
collective); a ZeRO-1 step takes this rank's rows of the result.

The sparse kind (`SparseBucket`, `sparse_bucket_reduce`) carries an
embedding table's gradient as a fixed-shape COO pair — row indices and
their gradient rows — all-gathered over the "data" group (or joined in
shard order for n shards in one process) and never expanded to the
table's shape.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass
from typing import Optional, Sequence, Tuple

import numpy as np

DEFAULT_BUCKET_BYTES = 4 << 20

_REDUCE_MODES = ("psum", "psum_scatter")


@dataclass(frozen=True)
class Bucket:
    """One reduction unit: a contiguous run of grad leaves (in reverse
    layer order) reduced as a single flat vector."""

    index: int
    paths: Tuple[str, ...]        # the JAX package's keystr leaf paths
    leaf_ids: Tuple[int, ...]     # positions in the canonical flatten order
    n_elements: int
    n_bytes: int                  # at the reduction dtype


@dataclass(frozen=True)
class BucketPlan:
    """Deterministic partition of a grads tree into reduction buckets."""

    buckets: Tuple[Bucket, ...]
    bucket_bytes: int
    reduce_dtype: str = "float32"
    mode: str = "psum"

    @property
    def n_leaves(self) -> int:
        return sum(len(b.paths) for b in self.buckets)

    @property
    def n_elements(self) -> int:
        return sum(b.n_elements for b in self.buckets)

    def leaf_paths(self) -> Tuple[str, ...]:
        return tuple(p for b in self.buckets for p in b.paths)

    def summary(self) -> dict:
        """Telemetry-ready description (the `bucket_plan` event)."""
        return {
            "n_buckets": len(self.buckets),
            "bucket_bytes": self.bucket_bytes,
            "mode": self.mode,
            "reduce_dtype": self.reduce_dtype,
            "n_leaves": self.n_leaves,
            "n_elements": self.n_elements,
            "buckets": [{"index": b.index, "n_leaves": len(b.paths),
                         "bytes": b.n_bytes} for b in self.buckets],
        }


def reduce_scatter(out, inp, group, async_op=False):
    """`out` = this rank's 1/n of the sum of `inp` over `group`
    (torch.distributed's reduce-scatter into one tensor, by whichever
    name this torch gives it)."""
    import torch.distributed as dist

    fn = (getattr(dist, "reduce_scatter_single", None)
          or dist.reduce_scatter_tensor)
    return fn(out, inp, group=group, async_op=async_op)


def all_gather(out, inp, group, async_op=False):
    """`out` = every rank's `inp` concatenated in rank order (the
    all-gather into one tensor)."""
    import torch.distributed as dist

    fn = (getattr(dist, "all_gather_single", None)
          or dist.all_gather_into_tensor)
    return fn(out, inp, group=group, async_op=async_op)


def _keystr(path) -> str:
    """A leaf path as `jax.tree_util.keystr` spells a dict path."""
    return "".join(f"[{k!r}]" for k in path)


def _float_leaves(tree):
    from deeplearning4j_tpu_torch.nn import tree as tree_mod

    return [(p, t) for p, t in tree_mod.leaves(tree)
            if t.is_floating_point()]


def plan_buckets(tree, bucket_bytes: int = DEFAULT_BUCKET_BYTES, *,
                 layer_order: Optional[Sequence[str]] = None,
                 reduce_dtype: str = "float32",
                 mode: str = "psum") -> BucketPlan:
    """Partition `tree` (params or grads — same structure) into
    size-targeted buckets by REVERSE layer order: a greedy pack over the
    reversed leaf sequence closes a bucket when the next leaf would
    exceed `bucket_bytes` (a single oversized leaf gets its own).
    `layer_order` — the network's top-level layer names in forward order
    — pins "layer order" to the model's topology; without it the
    flatten order (sorted keys) stands in."""
    if mode not in _REDUCE_MODES:
        raise ValueError(f"mode must be one of {_REDUCE_MODES}, got {mode!r}")
    if bucket_bytes <= 0:
        raise ValueError(f"bucket_bytes must be positive, got {bucket_bytes}")
    flat = _float_leaves(tree)
    if not flat:
        raise ValueError("cannot plan buckets over an empty pytree")
    itemsize = np.dtype(reduce_dtype).itemsize
    order = list(range(len(flat)))
    if layer_order is not None:
        pos = {name: i for i, name in enumerate(layer_order)}
        order.sort(key=lambda i: (pos.get(flat[i][0][0], len(pos)), i))
    order.reverse()  # last-computed gradients reduce first

    buckets = []
    cur_ids, cur_elems = [], 0
    for i in order:
        size = int(flat[i][1].numel())
        if cur_ids and (cur_elems + size) * itemsize > bucket_bytes:
            buckets.append((tuple(cur_ids), cur_elems))
            cur_ids, cur_elems = [], 0
        cur_ids.append(i)
        cur_elems += size
    if cur_ids:
        buckets.append((tuple(cur_ids), cur_elems))
    return BucketPlan(
        buckets=tuple(
            Bucket(index=bi, paths=tuple(_keystr(flat[i][0]) for i in ids),
                   leaf_ids=ids, n_elements=elems,
                   n_bytes=elems * itemsize)
            for bi, (ids, elems) in enumerate(buckets)),
        bucket_bytes=int(bucket_bytes), reduce_dtype=reduce_dtype,
        mode=mode)


def _check_cover(plan: BucketPlan, paths):
    if sorted(paths) != sorted(plan.leaf_paths()):
        raise ValueError(
            f"bucket plan does not cover this grads pytree: plan has "
            f"{plan.n_leaves} leaves, grads have {len(paths)} "
            f"(first mismatch: "
            f"{sorted(set(paths) ^ set(plan.leaf_paths()))[:3]})")


class BucketReducer:
    """The overlapped all-reduce of one backward: `attach` registers a
    hook on each live leaf (in the plan's flatten order); a hook stores
    its leaf's gradient and launches, in plan order, every bucket whose
    leaves all have theirs, as one flat asynchronous all-reduce over
    `group` (mode "psum_scatter": a reduce-scatter, whose all-gather
    `finish` runs). `finish(grads)` takes the backward's gradients (None where
    the loss does not reach a leaf: zeros then, filled only now, so no
    launch races the fill), launches what is left, waits, and returns
    the reduced (mean over the group when `mean`) gradients in the
    leaves' dtypes. Buckets launch in plan order on every rank, as the
    collectives of a process group must."""

    def __init__(self, plan: BucketPlan, group, size: int, *,
                 mean: bool = True):
        import torch

        self.plan = plan
        self.group = group
        self.size = size
        self.mean = mean
        self._dtype = getattr(torch, plan.reduce_dtype)

    def attach(self, paths, leaves, *, hook: bool = True):
        """Start one backward: hook `leaves` (their keystr `paths` must
        cover the plan); with hook=False, `finish` alone launches every
        bucket (the reduction after a backward)."""
        keys = [_keystr(p) for p in paths]
        _check_cover(self.plan, keys)
        pos = {k: i for i, k in enumerate(keys)}
        self._ids = [[pos[k] for k in b.paths] for b in self.plan.buckets]
        self._leaves = list(leaves)
        self._grads = [None] * len(self._leaves)
        self._vecs = [None] * len(self.plan.buckets)
        self._works = [None] * len(self.plan.buckets)
        self._next = 0
        self._lock = threading.Lock()
        self._handles = [t.register_hook(self._hook(i))
                         for i, t in enumerate(self._leaves)] if hook else []

    def _hook(self, i):
        def fn(grad):
            with self._lock:
                self._grads[i] = grad
                self._launch_ready()
        return fn

    def _launch_ready(self):
        import torch
        import torch.distributed as dist

        while self._next < len(self._ids):
            ids = self._ids[self._next]
            if any(self._grads[i] is None for i in ids):
                return
            vec = torch.cat([self._grads[i].reshape(-1).to(self._dtype)
                             for i in ids])
            if self.plan.mode == "psum_scatter":
                pad = (-vec.numel()) % self.size
                if pad:
                    vec = torch.cat([vec, vec.new_zeros(pad)])
                part = vec.new_empty(vec.numel() // self.size)
                self._works[self._next] = reduce_scatter(
                    part, vec, self.group, async_op=True)
                self._vecs[self._next] = part
            else:
                self._works[self._next] = dist.all_reduce(
                    vec, group=self.group, async_op=True)
                self._vecs[self._next] = vec
            self._next += 1

    def finish(self, grads):
        """The reduced gradients of the leaves, from the backward's
        `grads` (one per leaf, None = unreached)."""
        import torch

        for h in self._handles:
            h.remove()
        with self._lock:
            for i, g in enumerate(grads):
                if self._grads[i] is None:
                    self._grads[i] = (torch.zeros_like(self._leaves[i])
                                      if g is None else g)
            self._launch_ready()
        out = [None] * len(self._leaves)
        for ids, vec, work in zip(self._ids, self._vecs, self._works):
            work.wait()
            if self.plan.mode == "psum_scatter":
                part = vec
                vec = part.new_empty(part.numel() * self.size)
                all_gather(vec, part, self.group)
            if self.mean:
                vec = vec / self.size
            off = 0
            for i in ids:
                leaf = self._leaves[i]
                n = leaf.numel()
                out[i] = vec[off:off + n].reshape(leaf.shape).to(leaf.dtype)
                off += n
        self._leaves = self._grads = self._vecs = self._works = None
        return out


def bucketed_reduce(grads, plan: BucketPlan, group, size: int, *,
                    mean: bool = True):
    """Cross-replica reduction of a grads tree after the backward, one
    collective per bucket in plan order (the JAX package's
    `bucketed_reduce`; the overlapped form is `BucketReducer`). Returns
    a tree of the same nest."""
    from deeplearning4j_tpu_torch.nn import tree as tree_mod

    flat = _float_leaves(grads)
    red = BucketReducer(plan, group, size, mean=mean)
    red.attach([p for p, _ in flat], [t for _, t in flat], hook=False)
    out = red.finish([t for _, t in flat])
    result = tree_mod.tree_map(lambda t: t, grads)
    for (p, _), t in zip(flat, out):
        tree_mod.put(result, p, t)
    return result


@dataclass(frozen=True)
class SparseBucket:
    """One sparse reduction unit: a gradient that travels as a fixed-shape
    COO pair — `indices [n_rows]` naming embedding-table rows and
    `values [n_rows, dim]` carrying their gradients — and is NEVER
    materialized at the table's shape on the wire. Pure metadata like
    `Bucket`: derived from static batch shapes, identical on every
    process."""

    name: str
    n_rows: int                   # rows per participant (fixed shape)
    dim: int
    n_participants: int = 1
    index_dtype: str = "int32"
    value_dtype: str = "float32"

    @property
    def n_bytes(self) -> int:
        """Per-participant wire bytes: indices + values."""
        return self.n_rows * (np.dtype(self.index_dtype).itemsize
                              + self.dim * np.dtype(self.value_dtype).itemsize)

    @property
    def gathered_bytes(self) -> int:
        """Bytes each participant holds after the all-gather."""
        return self.n_bytes * self.n_participants

    def summary(self) -> dict:
        """Telemetry-ready description (rides the `bucket_plan` event
        next to the dense BucketPlan summaries)."""
        return {
            "kind": "sparse", "name": self.name, "n_rows": self.n_rows,
            "dim": self.dim, "n_participants": self.n_participants,
            "bytes": self.n_bytes, "gathered_bytes": self.gathered_bytes,
        }


def plan_sparse_bucket(name: str, n_rows: int, dim: int, *,
                       n_participants: int = 1,
                       index_dtype: str = "int32",
                       value_dtype: str = "float32") -> SparseBucket:
    """Plan one sparse (indices, values) bucket. Like `plan_buckets`,
    this is pure static metadata — every process derives the identical
    plan from the identical batch shapes."""
    if n_rows <= 0 or dim <= 0:
        raise ValueError(f"sparse bucket needs positive n_rows/dim, got "
                         f"({n_rows}, {dim})")
    if n_participants <= 0:
        raise ValueError(f"n_participants must be positive, "
                         f"got {n_participants}")
    return SparseBucket(name=name, n_rows=int(n_rows), dim=int(dim),
                        n_participants=int(n_participants),
                        index_dtype=index_dtype, value_dtype=value_dtype)


def _check_pair(indices, values, bucket):
    if values.ndim != 2 or indices.ndim != 1 \
            or values.shape[0] != indices.shape[0]:
        raise ValueError(
            f"sparse bucket expects indices [R] + values [R, D], got "
            f"{tuple(indices.shape)} / {tuple(values.shape)}")
    if bucket is not None:
        if (indices.shape[0] != bucket.n_rows
                or values.shape[1] != bucket.dim):
            raise ValueError(
                f"sparse bucket plan {bucket.name!r} is for "
                f"({bucket.n_rows}, {bucket.dim}) rows, traced shapes are "
                f"{tuple(indices.shape)} / {tuple(values.shape)}")


def sparse_bucket_reduce(indices, values, group=None, size: int = 1, *,
                         bucket: Optional[SparseBucket] = None):
    """Cross-replica exchange of a sparse gradient bucket: every
    participant's (indices, values) COO pair, joined in participant
    order, so each can scatter-add the rows it owns.

    Over a process group: `indices` [R] and `values` [R, D] are this
    rank's pair, all-gathered over `group` of `size` ranks. In one
    process (``group=None``): `indices` and `values` are lists of every
    participant's pairs in shard order, concatenated. The pair stays COO
    — ``(n * R)`` indices and ``(n * R, D)`` values — and is never
    expanded to the table's shape. Duplicate indices across
    participants are fine: the owner's scatter-add sums them, which is
    the dense formulation's semantics. A `bucket` plan checks each
    pair's shapes against it."""
    import torch

    if group is None:
        pairs = list(zip(indices, values))
        for idx, vals in pairs:
            _check_pair(idx, vals, bucket)
        if len(pairs) == 1:
            return pairs[0]
        return (torch.cat([p[0] for p in pairs]),
                torch.cat([p[1] for p in pairs]))
    import torch.distributed as dist

    _check_pair(indices, values, bucket)
    if size == 1:
        return indices, values
    idx_parts = [torch.empty_like(indices) for _ in range(size)]
    val_parts = [torch.empty_like(values) for _ in range(size)]
    dist.all_gather(idx_parts, indices.contiguous(), group=group)
    dist.all_gather(val_parts, values.contiguous(), group=group)
    return torch.cat(idx_parts), torch.cat(val_parts)


def _flat_mean(tensors, group, size, mean=True):
    """One all-reduce of `tensors` flattened into an f32 vector (mean
    over the group when `mean`); the results in the tensors' shapes and
    dtypes."""
    import torch
    import torch.distributed as dist

    if not tensors:
        return []
    vec = torch.cat([t.reshape(-1).to(torch.float32) for t in tensors])
    dist.all_reduce(vec, group=group)
    if mean:
        vec = vec / size
    out, off = [], 0
    for t in tensors:
        n = t.numel()
        out.append(vec[off:off + n].reshape(t.shape).to(t.dtype))
        off += n
    return out


def reduce_gradients(grads, groups, *, mean: bool = True):
    """Unbucketed cross-replica gradient mean over one or more axes
    (`groups`: [(process group, size)]), one flat all-reduce a tree per
    axis — the sequence-parallel step's reduction."""
    from deeplearning4j_tpu_torch.nn import tree as tree_mod

    flat = _float_leaves(grads)
    tensors = [t for _, t in flat]
    for group, size in groups:
        tensors = _flat_mean(tensors, group, size, mean)
    result = tree_mod.tree_map(lambda t: t, grads)
    for (p, _), t in zip(flat, tensors):
        tree_mod.put(result, p, t)
    return result


def pmean_float_leaves(tree, group, size: int):
    """Average the float tensors of `tree` (nested dicts / lists) over
    `group`, pass integer leaves (step counters) through: per-shard
    mutable state (BatchNorm running stats of local batches, optimizer
    moments) leaves as the cross-replica average."""
    import torch

    from deeplearning4j_tpu_torch.parallel.mesh import map_leaves

    floats = []
    map_leaves(lambda t: floats.append(t) if isinstance(
        t, torch.Tensor) and t.is_floating_point() else None, tree)
    means = iter(_flat_mean(floats, group, size))
    return map_leaves(lambda t: next(means) if isinstance(
        t, torch.Tensor) and t.is_floating_point() else t, tree)
