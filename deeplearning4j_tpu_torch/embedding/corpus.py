"""Skip-gram pair feeds for the embedding engine, riding the async
prefetch channel (JAX counterpart deeplearning4j_tpu/embedding/corpus.py).

Two front doors:

* `walk_pair_batches` — DeepWalk random walks (ragged) through the
  WalkBucketer/WalkPairExtractor fixed-shape path, compacted host-side
  into fixed [batch] (center, context) training batches.
* `sequence_pair_batches` — tokenized word2vec sequences (already
  index-mapped) through the same compaction.

Both produce FIXED-SHAPE batches (tail resampled like SequenceVectors'
flush), and `prefetched` wraps any of them in the
data/prefetcher.Prefetcher channel — pair generation and negative
sampling run on the prefetch thread, overlapping the device step.
"""

from __future__ import annotations

import numpy as np

from deeplearning4j_tpu_torch.data.prefetcher import EOS, Prefetcher
from deeplearning4j_tpu_torch.embedding.walks import (
    WalkBucketer,
    WalkPairExtractor,
)
from deeplearning4j_tpu_torch.nlp.vocab import sample_negatives


def _compact(buf_c, buf_x, batch_size, rng):
    """Yield fixed-size (center, context) batches from growing buffers;
    returns the remainders."""
    out = []
    while buf_c.size >= batch_size:
        out.append((buf_c[:batch_size], buf_x[:batch_size]))
        buf_c, buf_x = buf_c[batch_size:], buf_x[batch_size:]
    return out, buf_c, buf_x


def _flush_tail(buf_c, buf_x, batch_size, rng):
    """Pad the tail by resampling existing pairs — the SequenceVectors
    tail-flush convention, keeping the step shape fixed."""
    if buf_c.size == 0:
        return None
    pad = rng.integers(0, buf_c.size, batch_size - buf_c.size)
    return (np.concatenate([buf_c, buf_c[pad]]),
            np.concatenate([buf_x, buf_x[pad]]))


def walk_pair_batches(walks, *, batch_size: int = 1024, window: int = 5,
                      length_buckets=None, walk_batch: int = 64,
                      seed: int = 0, bucketer: WalkBucketer = None,
                      extractor: WalkPairExtractor = None, device=None):
    """Ragged walks -> fixed [batch_size] (center, context) batches.
    The extraction runs on `device` (CUDA unless the caller names
    another), fixed-shape per length bucket; the host compacts the
    masked pairs."""
    if bucketer is None:
        kw = {} if length_buckets is None else \
            {"length_buckets": length_buckets}
        bucketer = WalkBucketer(batch=walk_batch, **kw)
    if extractor is None:
        extractor = WalkPairExtractor(window=window, device=device)
    rng = np.random.default_rng(seed)
    buf_c = np.empty(0, np.int32)
    buf_x = np.empty(0, np.int32)
    for block, mask in bucketer.batches(walks):
        centers, contexts, valid = extractor.extract(block, mask)
        keep = valid.cpu().numpy()
        buf_c = np.concatenate([buf_c, centers.cpu().numpy()[keep]])
        buf_x = np.concatenate([buf_x, contexts.cpu().numpy()[keep]])
        ready, buf_c, buf_x = _compact(buf_c, buf_x, batch_size, rng)
        yield from ready
    tail = _flush_tail(buf_c, buf_x, batch_size, rng)
    if tail is not None:
        yield tail


def sequence_pair_batches(sequences, *, batch_size: int = 1024,
                          window: int = 5, seed: int = 0):
    """Index sequences (word2vec corpus, already vocab-mapped) ->
    fixed [batch_size] (center, context) batches with the full fixed
    window (the engine-corpus counterpart of SequenceVectors'
    random-shrunk host windows)."""
    rng = np.random.default_rng(seed)
    buf_c = np.empty(0, np.int32)
    buf_x = np.empty(0, np.int32)
    for seq in sequences:
        idx = np.asarray(seq, np.int32).reshape(-1)
        n = idx.size
        if n < 2:
            continue
        centers, contexts = [], []
        for i in range(n):
            lo, hi = max(0, i - window), min(n, i + window + 1)
            for j in range(lo, hi):
                if j != i:
                    centers.append(idx[i])
                    contexts.append(idx[j])
        buf_c = np.concatenate([buf_c, np.asarray(centers, np.int32)])
        buf_x = np.concatenate([buf_x, np.asarray(contexts, np.int32)])
        ready, buf_c, buf_x = _compact(buf_c, buf_x, batch_size, rng)
        yield from ready
    tail = _flush_tail(buf_c, buf_x, batch_size, rng)
    if tail is not None:
        yield tail


def with_negatives(pair_batches, cum_table, k: int, seed: int = 0):
    """Attach [batch, k] negative samples to each (center, context)
    batch — unigram-table sampling on the PRODUCER thread, so the whole
    feed (pairs + negatives) overlaps the device step when prefetched."""
    rng = np.random.default_rng(seed)
    for centers, contexts in pair_batches:
        negs = sample_negatives(cum_table, (centers.size, k), rng)
        yield centers, contexts, negs


def prefetched(batches, *, depth: int = 4, name: str = "embed-pairs"):
    """Wrap a pair-batch generator in the data/ async prefetch channel.
    Returns an iterator; generation runs on the prefetch thread."""
    pf = Prefetcher(lambda: batches, depth=depth, name=name)
    try:
        while True:
            item = pf.get()
            if item is EOS:
                return
            yield item
    finally:
        pf.stop()
