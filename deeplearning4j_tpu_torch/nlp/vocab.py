"""Vocabulary construction + Huffman coding for hierarchical softmax
(JAX counterpart deeplearning4j_tpu/nlp/vocab.py; pure host code, kept
as the port's own copy).

Reference:
- models/word2vec/VocabWord.java (word + count + huffman code/points)
- models/word2vec/wordstore/VocabConstructor.java:34
  (buildJointVocabulary:163 — corpus count, min-count filter, Huffman)
- models/word2vec/wordstore/inmemory/AbstractCache.java (VocabCache impl)
- models/word2vec/Huffman.java:34-66 (binary tree over counts → per-word
  code/point arrays, max code length 40)

Given the same corpus and the same numpy `Generator`, every function
here produces the JAX package's words, counts, indices, Huffman
codes/points and negative draws exactly: the training host loop
(nlp/sequencevectors.py) depends on it to draw the same pairs. It emits
padded numpy arrays (codes/points/mask) so the device-side
hierarchical-softmax step works on fixed shapes.
"""

from __future__ import annotations

import heapq
import itertools
from collections import Counter
from typing import Dict, Iterable, List, Optional, Sequence

import numpy as np

MAX_CODE_LENGTH = 40  # reference Huffman.java MAX_CODE_LENGTH


class VocabWord:
    """A sequence element: word, count, huffman code/points
    (reference VocabWord.java / SequenceElement)."""

    __slots__ = ("word", "count", "index", "code", "points", "labels")

    def __init__(self, word: str, count: float = 1.0):
        self.word = word
        self.count = count
        self.index = -1
        self.code: List[int] = []
        self.points: List[int] = []
        self.labels: List[str] = []

    def increment(self, by: float = 1.0):
        self.count += by

    def __repr__(self):
        return f"VocabWord({self.word!r}, count={self.count})"


class VocabCache:
    """Word ↔ index ↔ count store (reference wordstore/VocabCache +
    inmemory/AbstractCache)."""

    def __init__(self):
        self._words: Dict[str, VocabWord] = {}
        self._index: List[VocabWord] = []
        self.total_word_occurrences = 0.0

    # construction ---------------------------------------------------------
    def add_token(self, vw: VocabWord):
        existing = self._words.get(vw.word)
        if existing is not None:
            existing.increment(vw.count)
        else:
            self._words[vw.word] = vw

    def finish(self, min_word_frequency: int = 1,
               limit: Optional[int] = None):
        """Filter by min count, sort by descending count, assign indices
        (reference VocabConstructor.buildJointVocabulary:163)."""
        kept = [w for w in self._words.values()
                if w.count >= min_word_frequency]
        kept.sort(key=lambda w: (-w.count, w.word))
        if limit:
            kept = kept[:limit]
        self._words = {w.word: w for w in kept}
        self._index = kept
        for i, w in enumerate(kept):
            w.index = i
        self.total_word_occurrences = float(sum(w.count for w in kept))
        return self

    # queries --------------------------------------------------------------
    def contains_word(self, word: str) -> bool:
        return word in self._words

    def word_for(self, word: str) -> Optional[VocabWord]:
        return self._words.get(word)

    def index_of(self, word: str) -> int:
        vw = self._words.get(word)
        return vw.index if vw else -1

    def word_at_index(self, i: int) -> str:
        return self._index[i].word

    def element_at_index(self, i: int) -> VocabWord:
        return self._index[i]

    def word_frequency(self, word: str) -> float:
        vw = self._words.get(word)
        return vw.count if vw else 0.0

    def num_words(self) -> int:
        return len(self._index)

    def words(self) -> List[str]:
        return [w.word for w in self._index]

    def vocab_words(self) -> List[VocabWord]:
        return list(self._index)

    def __len__(self):
        return len(self._index)

    def __contains__(self, word):
        return word in self._words


class Huffman:
    """Huffman tree over word counts → per-word (code, points)
    (reference Huffman.java:34-66).

    code[d]  ∈ {0,1}: branch taken at depth d
    points[d]: inner-node index at depth d (relative, as syn1 row)
    """

    def __init__(self, words: Sequence[VocabWord]):
        self.words = list(words)

    def build(self):
        n = len(self.words)
        if n == 0:
            return self
        counter = itertools.count()
        # heap of (count, tiebreak, node_id); leaves are 0..n-1, inner n..2n-2
        heap = [(w.count, next(counter), i) for i, w in enumerate(self.words)]
        heapq.heapify(heap)
        parent = np.zeros(2 * n, dtype=np.int64)
        binary = np.zeros(2 * n, dtype=np.int8)
        next_inner = n
        while len(heap) > 1:
            c1, _, i1 = heapq.heappop(heap)
            c2, _, i2 = heapq.heappop(heap)
            parent[i1] = next_inner
            parent[i2] = next_inner
            binary[i2] = 1
            heapq.heappush(heap, (c1 + c2, next(counter), next_inner))
            next_inner += 1
        root = next_inner - 1 if n > 1 else n
        for i, w in enumerate(self.words):
            code, points = [], []
            node = i
            while n > 1 and node != root:
                code.append(int(binary[node]))
                node = int(parent[node])
                points.append(node - n)  # inner-node id → syn1 row
            # reference stores root→leaf order
            w.code = code[::-1][:MAX_CODE_LENGTH]
            w.points = points[::-1][:MAX_CODE_LENGTH]
        return self

    def padded_arrays(self, max_len: Optional[int] = None):
        """(codes [V,L] int8, points [V,L] int32, mask [V,L] bool) for the
        fixed-shape device hierarchical-softmax step."""
        L = max_len or max((len(w.code) for w in self.words), default=1) or 1
        V = len(self.words)
        codes = np.zeros((V, L), dtype=np.int8)
        points = np.zeros((V, L), dtype=np.int32)
        mask = np.zeros((V, L), dtype=bool)
        for i, w in enumerate(self.words):
            k = min(len(w.code), L)
            codes[i, :k] = w.code[:k]
            points[i, :k] = w.points[:k]
            mask[i, :k] = True
        return codes, points, mask


class VocabConstructor:
    """Builds a joint vocabulary from token-sequence sources (reference
    VocabConstructor.buildJointVocabulary:163 — count, filter, Huffman).
    n_workers > 1 counts corpus chunks in a process pool (the reference
    constructor is multi-threaded; Counter merge is associative, so the
    result is identical to the serial pass)."""

    def __init__(self, min_word_frequency: int = 1,
                 limit: Optional[int] = None, build_huffman: bool = True,
                 n_workers: int = 1):
        self.min_word_frequency = min_word_frequency
        self.limit = limit
        self.build_huffman = build_huffman
        self.n_workers = n_workers
        self._sources: List[Iterable[List[str]]] = []

    def add_source(self, token_sequences: Iterable[List[str]]):
        self._sources.append(token_sequences)
        return self

    def build_joint_vocabulary(self) -> VocabCache:
        from deeplearning4j_tpu_torch.nlp.distributed_vocab import (
            cache_from_counts,
            parallel_count,
        )

        counts: Counter = Counter()
        n_sequences = 0
        for source in self._sources:
            if self.n_workers > 1:
                c, n = parallel_count(source, n_workers=self.n_workers)
                counts.update(c)
                n_sequences += n
            else:
                for tokens in source:
                    counts.update(tokens)
                    n_sequences += 1
        return cache_from_counts(counts, n_sequences,
                                 self.min_word_frequency, self.limit,
                                 self.build_huffman)


def unigram_table(cache: VocabCache, power: float = 0.75) -> np.ndarray:
    """Negative-sampling table: word index repeated ∝ count^0.75
    (reference InMemoryLookupTable.makeTable). Stored compactly as a
    cumulative-probability array sampled by searchsorted instead of the
    reference's 100M-entry int table."""
    counts = np.array([w.count for w in cache.vocab_words()], dtype=np.float64)
    probs = counts ** power
    probs /= probs.sum()
    return np.cumsum(probs)


def sample_negatives(cumprobs: np.ndarray, shape, rng: np.random.Generator):
    """Draw negative-sample word indices from the unigram^0.75 table."""
    u = rng.random(shape)
    return np.searchsorted(cumprobs, u).astype(np.int32)


def subsample_mask(indices: np.ndarray, keep_prob: np.ndarray,
                   rng: np.random.Generator) -> np.ndarray:
    """Frequent-word subsampling (reference SequenceVectors sampling>0:
    p_keep = (sqrt(f/t) + 1) * t/f)."""
    return rng.random(indices.shape) < keep_prob[indices]


def keep_probabilities(cache: VocabCache, sampling: float) -> np.ndarray:
    counts = np.array([w.count for w in cache.vocab_words()], dtype=np.float64)
    freq = counts / max(cache.total_word_occurrences, 1.0)
    with np.errstate(divide="ignore", invalid="ignore"):
        p = (np.sqrt(freq / sampling) + 1.0) * sampling / np.maximum(freq, 1e-12)
    return np.clip(p, 0.0, 1.0)
