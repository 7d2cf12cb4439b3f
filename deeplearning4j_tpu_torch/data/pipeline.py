"""The pipelined input loader the fit loops ride (JAX counterpart
deeplearning4j_tpu/data/pipeline.py).

`iter_prefetched(it, convert)` replaces the synchronous step-loop shape

    for ds in it:
        batch = net._batch_dict(ds)      # host conversion + device copy
        step(batch)                      # ...only now does compute start

with a producer thread that runs ``convert`` (for the containers: this
rank's rows under a mesh, then `_batch_dict`, the tensors on the net's
device) ahead of the step loop, into a depth-k bounded `Channel`
(data/prefetcher.py). The step thread dequeues under a typed
``input_wait`` telemetry span: at steady state on a compute-bound
workload its seconds are ~0, while on an input-bound one the wall win
is the overlap itself (sync step = convert + compute; pipelined =
max(convert, compute)).

Ordering is the sync loop's: one producer, a FIFO channel, so batch k is
converted before batch k+1 and consumed in order — pipelined `fit` is
bit-identical to synchronous `fit`. A producer exception is re-raised
in the step loop at the point its batch would have been consumed.

The queue-depth knob: ``depth`` argument > `set_prefetch_depth` >
``DL4J_TPU_PREFETCH_DEPTH`` env > DEFAULT_DEPTH (2, double buffering).
Depth 0 is the synchronous path (also taken when an iterator declares
``async_supported() == False``).

`ShardedDataSetIterator` walks this process's shard of an in-memory
dataset by `data/sharding.ShardAssignment`; its batches are already
this rank's rows (`process_local`), which the containers' fit does not
split again.
"""

from __future__ import annotations

import os
from typing import Callable, Optional

import numpy as np

from deeplearning4j_tpu_torch.data.prefetcher import EOS, Prefetcher
from deeplearning4j_tpu_torch.data.sharding import ShardAssignment, local_rows
from deeplearning4j_tpu_torch.datasets.api import DataSet
from deeplearning4j_tpu_torch.datasets.iterators import DataSetIterator

DEFAULT_DEPTH = 2
ENV_DEPTH = "DL4J_TPU_PREFETCH_DEPTH"

_depth_override: Optional[int] = None


def set_prefetch_depth(depth: Optional[int]) -> Optional[int]:
    """Process-wide prefetch depth override (the bench's arm toggle).
    ``None`` restores the env/default resolution; returns the previous
    override."""
    global _depth_override
    prev, _depth_override = _depth_override, depth
    return prev


def prefetch_depth(depth: Optional[int] = None) -> int:
    """Resolve the queue-depth knob: explicit arg > `set_prefetch_depth`
    override > ``DL4J_TPU_PREFETCH_DEPTH`` > DEFAULT_DEPTH."""
    if depth is not None:
        return int(depth)
    if _depth_override is not None:
        return int(_depth_override)
    env = os.environ.get(ENV_DEPTH)
    if env:
        try:
            return int(env)
        except ValueError:
            raise ValueError(
                f"{ENV_DEPTH}={env!r} is not an integer queue depth")
    return DEFAULT_DEPTH


def _batches(it):
    """The DataSets of `it`: its has_next/next protocol, or plain
    iteration for another iterable."""
    if hasattr(it, "has_next"):
        while it.has_next():
            yield it.next()
    else:
        yield from it


def iter_prefetched(it, convert: Callable, *, depth: Optional[int] = None,
                    recorder=None):
    """Yield ``(ds, convert(ds))`` over a DataSetIterator with
    ``convert`` running on a background prefetch thread.

    ``convert`` must be order-deterministic and thread-compatible (the
    containers' conversion is both). Every dequeue is timed under an
    ``input_wait`` span carrying ``pipelined`` and the post-dequeue
    ``buffered`` count. Closing the generator or an exception in the
    step loop stops the producer and joins its thread."""
    k = prefetch_depth(depth)
    if recorder is None:
        from deeplearning4j_tpu_torch.telemetry import get_default

        recorder = get_default()
    if k <= 0 or not getattr(it, "async_supported", lambda: True)():
        # synchronous: the input stall IS the conversion
        for ds in _batches(it):
            with recorder.span("input_wait", pipelined=False):
                batch = convert(ds)
            yield ds, batch
        return

    pf = Prefetcher(lambda: _batches(it), depth=k,
                    transform=lambda ds: (ds, convert(ds)),
                    name="input-pipeline")
    try:
        while True:
            with recorder.span("input_wait", pipelined=True) as span:
                item = pf.get()
                span["buffered"] = pf.buffered()
            if item is EOS:
                return
            yield item
    finally:
        pf.stop()


class ShardedDataSetIterator(DataSetIterator):
    """A DataSetIterator over this process's shard of a full in-memory
    dataset, driven by `ShardAssignment`, so every process walks the
    SAME global batch sequence at any fleet size. Its batches are this
    process's rows already (``process_local`` when the fleet has more
    than one process).

    ``set_epoch(e)`` re-keys the permutation; ``reset()`` rewinds the
    CURRENT epoch."""

    def __init__(self, features, labels, global_batch: int, *,
                 process_index: int = 0, process_count: int = 1,
                 seed: int = 0, epoch: int = 0):
        super().__init__()
        self._x = np.asarray(features)
        self._y = np.asarray(labels)
        self.assignment = ShardAssignment(
            self._x.shape[0], global_batch,
            process_index=process_index, process_count=process_count,
            seed=seed)
        self.process_local = process_count > 1
        self._epoch = int(epoch)
        self._step = 0

    def set_epoch(self, epoch: int) -> None:
        self._epoch = int(epoch)
        self._step = 0

    @property
    def epoch(self) -> int:
        return self._epoch

    def has_next(self) -> bool:
        return self._step < self.assignment.steps_per_epoch

    def next(self, num=None):
        idx = self.assignment.local_indices(self._epoch, self._step)
        self._step += 1
        return self._apply_pre(DataSet(self._x[idx], self._y[idx]))

    def reset(self) -> None:
        self._step = 0

    def batch(self) -> int:
        return (self.assignment.global_batch
                // self.assignment.process_count)

    def total_examples(self) -> int:
        return self.assignment.steps_per_epoch * self.batch()


__all__ = ["DEFAULT_DEPTH", "ENV_DEPTH", "ShardedDataSetIterator",
           "iter_prefetched", "local_rows", "prefetch_depth",
           "set_prefetch_depth"]
