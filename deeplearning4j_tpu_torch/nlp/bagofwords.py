"""Document vectorizers: bag-of-words counts and TF-IDF.

Reference: bagofwords/vectorizer/{BagOfWordsVectorizer, TfidfVectorizer,
BaseTextVectorizer}.java (SURVEY.md §2.3 "Bag-of-words" row) — vectorize a
labelled corpus into a DataSet for the classifiers.

JAX counterpart deeplearning4j_tpu/nlp/bagofwords.py: host code, kept as the
port's own copy.
"""

from __future__ import annotations

import math
from typing import List, Optional, Sequence

import numpy as np

from deeplearning4j_tpu_torch.datasets.api import DataSet
from deeplearning4j_tpu_torch.nlp.text import (
    DefaultTokenizerFactory,
    TokenizerFactory,
)
from deeplearning4j_tpu_torch.nlp.vocab import VocabCache, VocabConstructor


class BaseTextVectorizer:
    """Shared corpus→matrix machinery (reference BaseTextVectorizer)."""

    def __init__(self, min_word_frequency: int = 1,
                 tokenizer_factory: Optional[TokenizerFactory] = None,
                 stop_words: Sequence[str] = (),
                 vocab_limit: Optional[int] = None):
        self.min_word_frequency = min_word_frequency
        self.factory = tokenizer_factory or DefaultTokenizerFactory()
        self.stop = frozenset(stop_words)
        self.vocab_limit = vocab_limit
        self.vocab: Optional[VocabCache] = None
        self.n_docs = 0
        self._doc_freq: Optional[np.ndarray] = None

    def _tokenize(self, text: str) -> List[str]:
        toks = self.factory.create(text).get_tokens()
        return [t for t in toks if t not in self.stop] if self.stop else toks

    def fit(self, documents: Sequence[str]):
        seqs = [self._tokenize(d) for d in documents]
        self.vocab = (VocabConstructor(self.min_word_frequency,
                                       self.vocab_limit, build_huffman=False)
                      .add_source(seqs).build_joint_vocabulary())
        V = self.vocab.num_words()
        self.n_docs = len(seqs)
        df = np.zeros(V, np.float64)
        for toks in seqs:
            seen = {self.vocab.index_of(t) for t in toks}
            for i in seen:
                if i >= 0:
                    df[i] += 1
        self._doc_freq = df
        return self

    def counts(self, text: str) -> np.ndarray:
        v = np.zeros(self.vocab.num_words(), np.float32)
        for t in self._tokenize(text):
            i = self.vocab.index_of(t)
            if i >= 0:
                v[i] += 1
        return v

    def transform(self, text: str) -> np.ndarray:
        raise NotImplementedError

    def vectorize(self, documents: Sequence[str],
                  labels: Sequence[str]) -> DataSet:
        """Corpus → DataSet (reference TextVectorizer.vectorize)."""
        label_names = sorted(set(labels))
        lab_idx = {l: i for i, l in enumerate(label_names)}
        X = np.stack([self.transform(d) for d in documents])
        Y = np.eye(len(label_names), dtype=np.float32)[
            [lab_idx[l] for l in labels]]
        ds = DataSet(X, Y)
        ds.label_names = label_names
        return ds


class BagOfWordsVectorizer(BaseTextVectorizer):
    """Raw term counts (reference BagOfWordsVectorizer)."""

    def transform(self, text: str) -> np.ndarray:
        return self.counts(text)


class TfidfVectorizer(BaseTextVectorizer):
    """TF-IDF weights (reference TfidfVectorizer: tf * log(N/df))."""

    def transform(self, text: str) -> np.ndarray:
        tf = self.counts(text)
        total = max(tf.sum(), 1.0)
        idf = np.log(self.n_docs / np.maximum(self._doc_freq, 1.0))
        return (tf / total * idf).astype(np.float32)

    def tfidf_word(self, word: str, document: str) -> float:
        i = self.vocab.index_of(word)
        if i < 0:
            return 0.0
        return float(self.transform(document)[i])
