"""Ragged-walk batching: uneven walks -> fixed shapes (JAX counterpart
deeplearning4j_tpu/embedding/walks.py).

DeepWalk walks are ragged (a walk that reaches a dead end stops early).
`WalkBucketer` pads each walk up to the smallest bucket of a fixed
LENGTH GRID that holds it (the mask marks real tokens) and batches walks
of one bucket together into fixed [B, L] blocks. `WalkPairExtractor`
then builds every (center, context) pair within `window` of a block on
the device, with static offsets, masked, and returns them flat with a
validity mask; the host compacts the valid pairs into training batches
(embedding/corpus.py). The JAX package compiles the extractor once per
(B, L) bucket; PyTorch runs it eagerly, so the fixed shapes matter here
only for the steps downstream.
"""

from __future__ import annotations

import numpy as np
import torch

from deeplearning4j_tpu_torch import resolve_device

DEFAULT_LENGTH_BUCKETS = (8, 16, 32, 64)


class WalkBucketer:
    """Buckets ragged walks into fixed [batch, length] blocks with
    masks. Walks longer than the top bucket are split; shorter ones pad
    up to the smallest bucket that holds them (id 0, mask False)."""

    def __init__(self, length_buckets=DEFAULT_LENGTH_BUCKETS,
                 batch: int = 64):
        self.length_buckets = tuple(sorted(int(b) for b in length_buckets))
        if not self.length_buckets:
            raise ValueError("need at least one length bucket")
        self.batch = int(batch)

    def length_bucket(self, n: int) -> int:
        for b in self.length_buckets:
            if n <= b:
                return b
        return self.length_buckets[-1]

    def batches(self, walks):
        """Yield (walk_block [batch, L] int32, mask [batch, L] bool)
        fixed-shape batches from an iterable of ragged walks. Partial
        batches flush with all-False mask rows."""
        pending = {b: [] for b in self.length_buckets}
        top = self.length_buckets[-1]
        for walk in walks:
            arr = np.asarray(walk, np.int32).reshape(-1)
            # split over-long walks into top-bucket chunks
            chunks = [arr[i:i + top] for i in range(0, max(arr.size, 1), top)]
            for chunk in chunks:
                if chunk.size < 2:
                    continue
                bucket = self.length_bucket(chunk.size)
                pending[bucket].append(chunk)
                if len(pending[bucket]) >= self.batch:
                    yield self._pack(pending[bucket], bucket)
                    pending[bucket] = []
        for bucket, rows in pending.items():
            if rows:
                yield self._pack(rows, bucket)

    def _pack(self, rows, bucket: int):
        block = np.zeros((self.batch, bucket), np.int32)
        mask = np.zeros((self.batch, bucket), bool)
        for i, row in enumerate(rows):
            block[i, :row.size] = row
            mask[i, :row.size] = True
        return block, mask


class WalkPairExtractor:
    """Device-side skip-gram pair extraction over a fixed [B, L] walk
    block: returns (centers [B*L*2w], contexts [B*L*2w], valid
    [B*L*2w]) — flat, fixed-shape tensors on `device` (CUDA unless the
    caller names another)."""

    def __init__(self, window: int = 5, device=None):
        self.window = int(window)
        self.device = resolve_device(device)

    def extract(self, block: np.ndarray, mask: np.ndarray):
        """Fixed-shape pair extraction; see class docstring."""
        block = torch.as_tensor(np.asarray(block), device=self.device).int()
        mask = torch.as_tensor(np.asarray(mask), device=self.device).bool()
        length = block.shape[1]
        positions = torch.arange(length, device=self.device)
        centers, contexts, valid = [], [], []
        for off in range(-self.window, self.window + 1):
            if off == 0:
                continue
            shifted = torch.roll(block, -off, dims=1)
            shifted_mask = torch.roll(mask, -off, dims=1)
            pos = positions + off
            in_range = (pos >= 0) & (pos < length)
            ok = mask & shifted_mask & in_range[None, :]
            centers.append(block.reshape(-1))
            contexts.append(torch.where(ok, shifted, 0).reshape(-1))
            valid.append(ok.reshape(-1))
        return torch.cat(centers), torch.cat(contexts), torch.cat(valid)
