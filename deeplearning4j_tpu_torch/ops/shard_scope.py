"""The shard a mesh step's forward runs as: what the layers, the losses
and the attention kernels read to behave as the JAX package's code does
inside its jit over a mesh or its shard_map.

JAX runs every shard of a mesh in one program, so a batch statistic
under GSPMD is global and a layer inside shard_map finds its axis bound.
The port runs one process per device, and the train step tells the
forward which shard it is by entering `sharded(...)`:

- `DataShard`: the monolithic data-parallel step (GSPMD semantics, one
  device over the global batch). BatchNorm normalizes by statistics
  summed over the data group, the masked loss divides by the global mask
  count, input dropout draws the global batch's mask and keeps this
  shard's rows, and the flash kernels' dropout hashes global b*H + h
  slices, and a capacity-routed MoE layer routes the global batch's
  tokens (`global_batch`); so the step equals one device on the global
  batch. A shard of one rank takes the same path, its collectives over a
  group of one.
- `SeqShard`: the sequence-parallel step. The attention layer runs the
  ring over `transport` and the positional encoding offsets by the
  shard's global position. It composes with a `ModelShard`: each model
  shard's heads run the ring, their keep masks folded apart
  (`fold_slices`).
- `ModelShard`: a layer whose params a "model" or "expert" placement
  split (parallel/tensor_parallel.py, parallel/expert_parallel.py): the
  transport of its collectives (ops/shard_comm.py) and which param is
  split on which dim. Unlike the two above it is not a step's context
  but the placement's, kept from `set_mesh` to the next: `place(conf,
  shard)` registers it for the layer conf, `layer_shard(conf)` is what
  the layer reads in every forward (training, inference, the remat
  recompute), `unplace(conf)` ends it. A layer no placement registered
  runs whole.

The context is process-wide, not per thread: the autograd engine
recomputes a remat block's forward on its own thread, inside the step,
and must see the same shard. The module sits under ops/, below the
layers and parallel/, which both read it; it imports torch only inside
the functions that use it.
"""

from __future__ import annotations

import contextlib
import weakref
from dataclasses import dataclass
from typing import Any, Optional

# b*H + h slice stride of the flash kernels' keep hash (csrc/dropout.cuh)
_BH_MIX = 0x9E3779B9
_U32 = 0xFFFFFFFF


@dataclass(frozen=True)
class DataShard:
    """Shard `index` of `size` along a data axis whose process group is
    `group`."""

    group: Any
    size: int
    index: int


@dataclass(frozen=True)
class SeqShard:
    """Shard `index` of `size` along the sequence axis `axis`, with the
    ring `transport` (parallel/ring_attention.py) and the generator the
    ring's dropout step seeds come from (the same on every shard of the
    axis, so the ring drops what one kernel over the whole sequence
    would). An `InProcessRing` transport (index 0 of size 1) means this
    process holds the whole sequence and the attention runs the ring
    over its n blocks."""

    axis: str
    transport: Any
    index: int
    size: int
    ring_generator: Any = None


@dataclass(frozen=True)
class ModelShard:
    """A layer split over the shards of a mesh axis (a "model" or
    "expert" role): its collectives go through `transport`
    (ops/shard_comm.py), and `split` maps each split param's name to the
    dim it is split on (the rest are whole)."""

    transport: Any
    split: Any


_active = {"data": None, "seq": None}
# id(layer conf) -> (a weak reference to the conf, its ModelShard)
_placed = {}


def place(conf, shard: ModelShard):
    """Register `shard` as the split of the layer `conf`."""
    _placed[id(conf)] = (weakref.ref(conf), shard)


def unplace(conf):
    """End the split of the layer `conf` (no-op when it has none)."""
    _placed.pop(id(conf), None)


def layer_shard(conf) -> Optional[ModelShard]:
    """The ModelShard a placement registered for the layer `conf`, or
    None: the layer runs whole."""
    entry = _placed.get(id(conf))
    if entry is None:
        return None
    ref, shard = entry
    if ref() is not conf:  # a dead conf whose id was reused
        del _placed[id(conf)]
        return None
    return shard


@contextlib.contextmanager
def sharded(data: Optional[DataShard] = None,
            seq: Optional[SeqShard] = None):
    """Run the enclosed forward (and backward) as the given shard(s)."""
    prev = dict(_active)
    _active["data"] = data
    _active["seq"] = seq
    try:
        yield
    finally:
        _active.update(prev)


def data_shard() -> Optional[DataShard]:
    """The monolithic data-parallel shard the forward runs as, or None."""
    return _active["data"]


def seq_shard(axis: str) -> Optional[SeqShard]:
    """The sequence shard along `axis` the forward runs as, or None
    (also when `axis` is empty: a conf built without sequence
    parallelism)."""
    s = _active["seq"]
    return s if axis and s is not None and s.axis == axis else None


def global_sum(t):
    """Differentiable sum of `t` over the data group (the gradient flows
    back to every shard's contribution), or `t` outside a data shard."""
    d = data_shard()
    if d is None:
        return t
    from torch.distributed.nn.functional import all_reduce

    return all_reduce(t, group=d.group)


def global_total(t):
    """Sum of a constant (no gradient) over the data group, or `t`."""
    d = data_shard()
    if d is None:
        return t
    import torch.distributed as dist

    out = t.detach().clone()
    dist.all_reduce(out, group=d.group)
    return out


def global_rows(shape):
    """(shape of the global batch, this shard's row slice) for a
    batch-major tensor of local `shape`, or (shape, None)."""
    d = data_shard()
    if d is None:
        return tuple(shape), None
    rows = shape[0]
    return ((rows * d.size,) + tuple(shape[1:]),
            slice(d.index * rows, (d.index + 1) * rows))


def global_batch(t):
    """The global batch of a batch-major tensor under a data shard:
    every rank's rows, in rank order, differentiable (each rank's rows
    collect the gradients of every rank's loss); `t` itself outside
    one."""
    d = data_shard()
    if d is None:
        return t
    from deeplearning4j_tpu_torch.ops.shard_comm import gather_rows

    return gather_rows(t, d.group, d.size)


def fold_slices(seed, offset: int):
    """The flash step seed under which local slice bh hashes as slice bh
    + `offset`: the keep hash keys slice bh on seed + bh * _BH_MIX (mod
    2^32), so an offset folds into the seed. `seed` is the one-element
    int32 tensor; returned unchanged at offset 0."""
    if not offset:
        return seed
    import torch

    off = (int(offset) * _BH_MIX) & _U32
    s = (seed.long() + off) & _U32
    return torch.where(s >= 2**31, s - 2**32, s).to(torch.int32)


def fold_bh_offset(seed, BH: int):
    """The flash step seed under which local slice bh hashes as global
    slice bh + index*BH (`fold_slices`); returned unchanged outside a
    data shard."""
    d = data_shard()
    if d is None or not d.index:
        return seed
    return fold_slices(seed, d.index * BH)


def shard_seed(state, indices) -> int:
    """The 63-bit seed of the shard at `indices` whose parent generator
    is in `state` (`Generator.get_state()`): a hash of the state's
    bytes and the indices. The state is a CPU byte tensor for a CPU and
    a CUDA generator alike (a CUDA generator's Philox seed and offset
    live on the host), so the seed is made without reading the card."""
    import hashlib

    # the state is a CPU tensor on every device: no read of the card
    h = hashlib.blake2b(state.numpy().tobytes(),  # graftlint: disable=G002
                        digest_size=8)
    for i in indices:
        h.update(int(i).to_bytes(8, "little", signed=True))
    return int.from_bytes(h.digest(), "little") % 2**63


def shard_generator(generator, indices, size: int):
    """The dropout generator of one shard of a mesh step whose shards
    draw apart (the JAX package's `fold_in` of the axis indices into the
    step key): `generator` itself on a mesh of one shard (`size` 1),
    else a generator on its device seeded from `generator`'s state mixed
    with `indices`, this shard's coordinates (`shard_seed`). The parent
    then advances by one draw that stays on its device and is never
    read, so every rank's `generator` advances alike and the next call
    gets a new seed."""
    if generator is None or size == 1:
        return generator
    import torch

    seed = shard_seed(generator.get_state(), indices)
    torch.randint(0, 2**62, (1,), generator=generator,
                  device=generator.device)
    return torch.Generator(device=generator.device).manual_seed(seed)
