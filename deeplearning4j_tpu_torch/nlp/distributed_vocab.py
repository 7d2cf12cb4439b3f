"""Parallel and distributed vocabulary construction (JAX counterpart
deeplearning4j_tpu/nlp/distributed_vocab.py).

- `parallel_count` / `VocabConstructor(n_workers=...)` count corpus
  chunks in a host process pool (workers tokenize, optionally, and
  count); Counters merge associatively, so the result equals the serial
  pass. `cache_from_counts` is the shared tail that finishes a
  VocabCache (filter, index order, Huffman).
- `build_vocab_distributed`: every cluster worker counts ITS corpus
  shard, publishes the counts through the coordinator's config registry
  (parallel/cluster.py), barriers, and merges all shards in
  sorted-worker order — each worker ends with the IDENTICAL VocabCache
  (same counts, same index order, same Huffman codes), the invariant
  the device pipeline needs for device-count-invariant training
  (reference: spark/dl4j-spark-nlp TextPipeline.buildVocabCache).
"""

from __future__ import annotations

import multiprocessing
from collections import Counter
from typing import Iterable, List, Optional

from deeplearning4j_tpu_torch.nlp.vocab import Huffman, VocabCache, VocabWord


def _count_chunk(args):
    chunk, tokenizer_factory = args
    counts: Counter = Counter()
    n = 0
    for item in chunk:
        tokens = (tokenizer_factory.create(item).get_tokens()
                  if tokenizer_factory is not None else item)
        counts.update(tokens)
        n += 1
    return counts, n


def parallel_count(sequences: Iterable, tokenizer_factory=None,
                   n_workers: Optional[int] = None, chunk_size: int = 2000):
    """(Counter, n_sequences) over `sequences` using a process pool.

    sequences: token lists, or raw strings when `tokenizer_factory` is
    given (tokenization happens IN the workers — it is the expensive
    part). Falls back to inline counting for n_workers <= 1.
    """
    n_workers = n_workers or multiprocessing.cpu_count()
    if n_workers <= 1:
        # stream — never buffer the corpus (the serial constructor's
        # memory profile)
        return _count_chunk((sequences, tokenizer_factory))
    chunks: List[list] = []
    buf: list = []
    for s in sequences:
        buf.append(s)
        if len(buf) >= chunk_size:
            chunks.append(buf)
            buf = []
    if buf:
        chunks.append(buf)
    if len(chunks) <= 1:
        only = chunks[0] if chunks else []
        return _count_chunk((only, tokenizer_factory))
    total: Counter = Counter()
    n_seq = 0
    ctx = multiprocessing.get_context("spawn")
    with ctx.Pool(min(n_workers, len(chunks))) as pool:
        for counts, n in pool.imap_unordered(
                _count_chunk,
                ((c, tokenizer_factory) for c in chunks)):
            total.update(counts)
            n_seq += n
    return total, n_seq


def cache_from_counts(counts: Counter, n_sequences: int,
                      min_word_frequency: int = 1,
                      limit: Optional[int] = None,
                      build_huffman: bool = True) -> VocabCache:
    """Finish a VocabCache from merged counts (shared tail of the serial,
    parallel, and distributed constructors)."""
    cache = VocabCache()
    for word, c in counts.items():
        cache.add_token(VocabWord(word, float(c)))
    cache.finish(min_word_frequency, limit)
    if build_huffman:
        Huffman(cache.vocab_words()).build()
    cache.n_sequences = n_sequences
    return cache


def build_vocab_distributed(client, local_sequences: Iterable[List[str]],
                            *, min_word_frequency: int = 1,
                            limit: Optional[int] = None,
                            build_huffman: bool = True,
                            n_workers: int = 1,
                            key: str = "vocab") -> VocabCache:
    """Cluster-wide vocabulary from per-worker corpus shards.

    client: a connected parallel.cluster.ClusterClient. Every worker
    calls this with its OWN shard; all workers return the same cache.
    """
    counts, n_seq = parallel_count(local_sequences, n_workers=n_workers)
    client.set_config(f"{key}/counts/{client.worker_id}",
                      {"counts": dict(counts), "n_sequences": n_seq})
    client.barrier(f"{key}/counted")
    merged: Counter = Counter()
    total_seq = 0
    for wid in sorted(client.workers()):
        shard = client.get_config(f"{key}/counts/{wid}")
        if shard is None:
            continue  # worker died between counting and the barrier
        merged.update(shard["counts"])
        total_seq += int(shard["n_sequences"])
    return cache_from_counts(merged, total_seq, min_word_frequency, limit,
                             build_huffman)
