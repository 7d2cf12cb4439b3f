"""Parallel vocabulary counting (JAX counterpart
deeplearning4j_tpu/nlp/distributed_vocab.py, lines 35-97).

`parallel_count` / `VocabConstructor(n_workers=...)` count corpus
chunks in a host process pool (workers tokenize, optionally, and
count); Counters merge associatively, so the result equals the serial
pass. `cache_from_counts` is the shared tail that finishes a VocabCache
(filter, index order, Huffman). The cluster-wide
`build_vocab_distributed` waits for the distributed runtime
(ROADMAP Queue A item 7).
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
