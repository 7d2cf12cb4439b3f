"""The collectives of a layer split over model or expert shards, as
transports the layers call (JAX counterpart: the psums GSPMD inserts
for the placement rules of deeplearning4j_tpu/parallel/tensor_parallel.py
and the shard_map of parallel/expert_parallel.py).

A split layer computes over the shards a process holds: one list entry
a shard, `transport.shards` their indices. Megatron's conjugate pair
joins replicated and per-shard values:

- `copy(x)`: a replicated x handed to every shard. Forward the identity;
  backward the sum of the shards' gradients (each shard's computation
  reaches x only through its own part).
- `reduce(parts)`: the shards' partial results summed into one
  replicated value. Forward the sum; backward the identity to each.
- `gather(parts, dim)`: the shards' slices concatenated along `dim` into
  a replicated value that replicated code then uses (the embedding's
  features, the LM head's vocab). Backward each shard's slice of the
  gradient, which is the same on every shard.

Two transports carry them:

- `ProcessGroupShards`: one shard a rank over a process group (NCCL on
  CUDA, gloo on the CPU); the sums run in f32 and cast back.
- `InProcessShards`: n shards in one process, one device: copy hands the
  same tensor to every shard (autograd then sums their gradients),
  reduce sums the parts in f32 in shard order, gather concatenates. It
  is what the card can run at one rank to check a split of n shards
  against the whole layer, and what `tensor_parallel.place_in_process`
  registers: the process then holds each split layer's params whole and
  `pieces` cuts every shard's slices from them.

`pieces(params, split, n_heads)` gives the shard params a split layer
computes with: a rank's own under `ProcessGroupShards`, every shard's
slices under `InProcessShards`.
"""

from __future__ import annotations

import torch


def _all_reduce_f32(t, group):
    """The sum of `t` over `group`, taken in f32 in a contiguous buffer
    of its own (a collective takes no strided tensor; a gradient may
    come strided)."""
    import torch.distributed as dist

    out = torch.empty(t.shape, dtype=torch.float32, device=t.device)
    out.copy_(t.detach())
    dist.all_reduce(out, group=group)
    return out.to(t.dtype)


class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce_f32(g, ctx.group), None


class _ReduceFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return _all_reduce_f32(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, size, index, dim):
        import torch.distributed as dist

        ctx.index, ctx.dim, ctx.width = index, dim, x.shape[dim]
        parts = [torch.empty_like(x) for _ in range(size)]
        dist.all_gather(parts, x.contiguous(), group=group)
        return torch.cat(parts, dim=dim)

    @staticmethod
    def backward(ctx, g):
        lo = ctx.index * ctx.width
        return g.narrow(ctx.dim, lo, ctx.width), None, None, None, None


class _GatherRows(torch.autograd.Function):
    """The global batch of a batch-major tensor whose rows the ranks of
    a data group split: forward the all-gather; backward each rank's
    rows of the gradients summed over the ranks (the reduce-scatter),
    since every rank's loss may reach every row."""

    @staticmethod
    def forward(ctx, x, group, size):
        import torch.distributed as dist

        ctx.group, ctx.size = group, size
        parts = [torch.empty_like(x) for _ in range(size)]
        dist.all_gather(parts, x.contiguous(), group=group)
        return torch.cat(parts, dim=0)

    @staticmethod
    def backward(ctx, g):
        import torch.distributed as dist

        fn = (getattr(dist, "reduce_scatter_single", None)
              or dist.reduce_scatter_tensor)
        g32 = g.contiguous().to(torch.float32)
        out = g32.new_empty((g.shape[0] // ctx.size,) + tuple(g.shape[1:]))
        fn(out, g32, group=ctx.group)
        return out.to(g.dtype), None, None


def gather_rows(x, group, size: int):
    """`_GatherRows`: the rows of every rank of `group`, in rank order."""
    return _GatherRows.apply(x, group, size)


class ProcessGroupShards:
    """This rank is shard `index` of `size` over `group`."""

    def __init__(self, group, size: int, index: int):
        self.group = group
        self.n = int(size)
        self.index = int(index)
        self.shards = (self.index,)

    def copy(self, x):
        return [_CopyTo.apply(x, self.group)]

    def reduce(self, parts):
        (p,) = parts
        return _ReduceFrom.apply(p, self.group)

    def gather(self, parts, dim: int):
        (p,) = parts
        dim = dim % p.ndim
        return _GatherFrom.apply(p, self.group, self.n, self.index, dim)

    def pieces(self, params, split, n_heads=None):
        """The shard params of a split layer this rank holds: its own."""
        return [params]


class InProcessShards:
    """All `n` shards in this process, in order."""

    def __init__(self, n: int):
        self.n = int(n)
        self.shards = tuple(range(self.n))

    def copy(self, x):
        return [x] * self.n

    def reduce(self, parts):
        if len(parts) == 1:
            return parts[0]
        acc = parts[0].to(torch.float32)
        for p in parts[1:]:
            acc = acc + p.to(torch.float32)
        return acc.to(parts[0].dtype)

    def gather(self, parts, dim: int):
        return parts[0] if len(parts) == 1 else torch.cat(parts, dim=dim)

    def pieces(self, params, split, n_heads=None):
        """Every shard's params of a split layer whose `params` this
        process holds whole: shard j's slice of each leaf `split` names
        ({name: dim}; a packed QKV leaf by `n_heads`), the rest shared.
        The slices are cut anew on every call, so under autograd the
        gradients reach the whole leaf."""
        if self.n == 1:
            return [params]
        from deeplearning4j_tpu_torch.parallel.tensor_parallel import (
            shard_slice,
        )

        out = [dict(params) for _ in range(self.n)]
        for name, dim in split.items():
            heads = n_heads if name in ("Wqkv", "bqkv") else None
            for j in range(self.n):
                out[j][name] = shard_slice(params[name], dim, self.n, j,
                                           heads)
        return out
