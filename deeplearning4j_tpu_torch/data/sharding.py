"""Deterministic per-process shard assignment (JAX counterpart
deeplearning4j_tpu/data/sharding.py, whose pure-numpy code this module
repeats so that the port imports nothing of the JAX package; both give
the same indices).

The contract:

1. The GLOBAL example order for an epoch is a seeded permutation keyed
   off ``(seed, epoch)`` only — never the process count — so every
   fleet size walks the identical global batch sequence.
2. Step ``s`` (0-based within the epoch) owns the contiguous window
   ``perm[s*B : (s+1)*B]`` of that order (``B`` = global batch).
3. Process ``p`` of ``N`` owns the contiguous process-major rows
   ``[p*B/N, (p+1)*B/N)`` of its step's window — the same split
   `distributed/global_mesh.local_shard` applies to host arrays and the
   data-parallel step applies to a global batch (rank r keeps the rows
   JAX device r holds).

So concatenating the N processes' local index sets for a step, in
process order, is exactly the global window at any N, and a fleet
re-formed N -> N' that resumes at step ``s`` sees the same remaining
global windows an uninterrupted run would.

Pure numpy + stdlib.
"""

from __future__ import annotations

import numpy as np


def process_slice(n_rows: int, process_index: int,
                  process_count: int) -> slice:
    """The process-major contiguous row slice ``[p*n/N, (p+1)*n/N)`` —
    the one split rule shared by `ShardAssignment`,
    `distributed/global_mesh.local_shard`, and the data-parallel
    step's row split. Raises when the rows don't divide evenly (an uneven
    shard would desync the fleet's lockstep batch shapes)."""
    if not 0 <= process_index < process_count:
        raise ValueError(
            f"process_index {process_index} out of range for "
            f"process_count {process_count}")
    if n_rows % process_count:
        raise ValueError(
            f"{n_rows} rows do not split over {process_count} processes")
    per = n_rows // process_count
    return slice(process_index * per, (process_index + 1) * per)


def local_rows(array, process_index: int, process_count: int,
               axis: int = 0):
    """This process's contiguous slice of a full host array along
    ``axis`` (the `process_slice` rule applied to data)."""
    arr = np.asarray(array)
    sl = process_slice(arr.shape[axis], process_index, process_count)
    idx = [slice(None)] * arr.ndim
    idx[axis] = sl
    return arr[tuple(idx)]


def epoch_permutation(n_examples: int, epoch: int, seed: int) -> np.ndarray:
    """The global example order for one epoch: a PhiloxSeedSequence-fed
    permutation keyed off ``(seed, epoch)`` ONLY. Identical on every
    process of every fleet size — the root determinism the whole
    assignment contract rests on."""
    rng = np.random.default_rng(np.random.SeedSequence([int(seed),
                                                        int(epoch)]))
    return rng.permutation(n_examples)


class ShardAssignment:
    """Stable global example→process mapping for an epoch-structured run.

    ``global_batch`` must divide by ``process_count`` (rule 3) and
    ``n_examples`` truncates to whole global batches (the ragged tail is
    dropped deterministically — the same tail at every N, so no fleet
    shape ever trains on rows another shape skipped).
    """

    def __init__(self, n_examples: int, global_batch: int, *,
                 process_index: int = 0, process_count: int = 1,
                 seed: int = 0):
        if global_batch < 1:
            raise ValueError(f"global_batch must be >= 1, got {global_batch}")
        if global_batch > n_examples:
            raise ValueError(
                f"global_batch {global_batch} exceeds {n_examples} examples")
        # validates index/count and divisibility up front
        self._local = process_slice(global_batch, process_index,
                                    process_count)
        self.n_examples = int(n_examples)
        self.global_batch = int(global_batch)
        self.process_index = int(process_index)
        self.process_count = int(process_count)
        self.seed = int(seed)
        self.steps_per_epoch = self.n_examples // self.global_batch

    def global_indices(self, epoch: int, step: int) -> np.ndarray:
        """The global batch window for 0-based ``step`` of ``epoch`` —
        process-count independent by construction."""
        if not 0 <= step < self.steps_per_epoch:
            raise ValueError(
                f"step {step} out of range [0, {self.steps_per_epoch})")
        perm = epoch_permutation(self.n_examples, epoch, self.seed)
        b = self.global_batch
        return perm[step * b:(step + 1) * b]

    def local_indices(self, epoch: int, step: int) -> np.ndarray:
        """This process's rows of the step's global window (rule 3)."""
        return self.global_indices(epoch, step)[self._local]

    def for_process(self, process_index: int,
                    process_count: int) -> "ShardAssignment":
        """The same assignment viewed from another fleet shape — what an
        elastic re-form constructs after N→N'."""
        return ShardAssignment(
            self.n_examples, self.global_batch,
            process_index=process_index, process_count=process_count,
            seed=self.seed)
