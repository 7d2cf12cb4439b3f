"""Inverted corpus index (reference: text/invertedindex/{InvertedIndex,
LuceneInvertedIndex}.java — term→document postings over tokenised docs,
mini-batch iteration and document sampling for embedding training).

The Lucene dependency is replaced by a plain in-memory postings dict; the
capability surface (addWordsToDoc, documents(word), numDocuments, docs,
miniBatches, sample, search) matches the reference interface.

JAX counterpart deeplearning4j_tpu/nlp/invertedindex.py: host code, kept as the
port's own copy.
"""

from __future__ import annotations

import math
import random
from collections import defaultdict
from typing import Dict, Iterator, List, Optional, Sequence, Tuple


class InvertedIndex:
    """In-memory inverted index over tokenised documents."""

    def __init__(self, seed: int = 0):
        self._docs: List[List[str]] = []
        self._labels: List[Optional[List[str]]] = []
        self._postings: Dict[str, List[int]] = defaultdict(list)
        self._rng = random.Random(seed)

    # ---------------------------------------------------------- population
    def add_words_to_doc(self, doc_id: int, words: Sequence[str],
                         labels: Optional[Sequence[str]] = None) -> None:
        """Append words to document `doc_id`, creating it if needed
        (InvertedIndex.addWordsToDoc)."""
        while len(self._docs) <= doc_id:
            self._docs.append([])
            self._labels.append(None)
        seen_here = set(self._docs[doc_id])
        for w in words:
            self._docs[doc_id].append(w)
            if w not in seen_here:
                self._postings[w].append(doc_id)
                seen_here.add(w)
        if labels is not None:
            self._labels[doc_id] = list(labels)

    def add_doc(self, words: Sequence[str],
                labels: Optional[Sequence[str]] = None) -> int:
        doc_id = len(self._docs)
        self.add_words_to_doc(doc_id, words, labels)
        return doc_id

    # ------------------------------------------------------------- queries
    def document(self, index: int) -> List[str]:
        return list(self._docs[index])

    def document_with_labels(self, index: int) -> Tuple[List[str], Optional[List[str]]]:
        return list(self._docs[index]), self._labels[index]

    def documents(self, word: str) -> List[int]:
        """Doc ids containing `word` (InvertedIndex.documents)."""
        return list(self._postings.get(word, []))

    def num_documents(self) -> int:
        return len(self._docs)

    def all_docs(self) -> List[int]:
        return list(range(len(self._docs)))

    def docs(self) -> Iterator[List[str]]:
        return iter(list(d) for d in self._docs)

    def mini_batches(self, batch_size: int) -> Iterator[List[List[str]]]:
        """Documents in batches (InvertedIndex.batchIter/miniBatches)."""
        for s in range(0, len(self._docs), batch_size):
            yield [list(d) for d in self._docs[s:s + batch_size]]

    def sample(self) -> List[str]:
        """A uniformly random document (InvertedIndex.sample)."""
        if not self._docs:
            raise IndexError("empty index")
        return list(self._docs[self._rng.randrange(len(self._docs))])

    # ------------------------------------------------------ search/scoring
    def search(self, *words: str) -> List[int]:
        """Conjunctive (AND) search: ids of docs containing every word."""
        if not words:
            return []
        sets = [set(self._postings.get(w, ())) for w in words]
        hit = set.intersection(*sets) if sets else set()
        return sorted(hit)

    def tfidf_search(self, *words: str, top_n: int = 10) -> List[Tuple[int, float]]:
        """Disjunctive search ranked by summed tf-idf."""
        n = max(len(self._docs), 1)
        scores: Dict[int, float] = defaultdict(float)
        for w in words:
            posting = self._postings.get(w, [])
            if not posting:
                continue
            idf = math.log(n / len(posting))
            for d in posting:
                tf = self._docs[d].count(w) / max(len(self._docs[d]), 1)
                scores[d] += tf * idf
        return sorted(scores.items(), key=lambda kv: -kv[1])[:top_n]
