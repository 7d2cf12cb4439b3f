"""ParagraphVectors (doc2vec) — PV-DBOW and PV-DM (JAX counterpart
deeplearning4j_tpu/nlp/paragraph_vectors.py).

Reference: models/paragraphvectors/ParagraphVectors.java (labels as extra
sequence elements trained alongside words; inferVector for unseen docs);
sequence learning algorithms impl/sequence/{DBOW,DM}.java.

Label vectors are extra rows of syn0 (rows [V, V+n_labels)). PV-DBOW =
skip-gram pairs (label -> every word); PV-DM = CBOW windows with the
label appended as a context column; both train through the port's
SequenceVectors host loop and lookup steps, on `device` (CUDA unless the
caller names another). infer_vector trains ONE free row against frozen
output weights (nlp/lookup.infer_sgns_step / infer_hs_step); its start
vector and negatives come from `np.random.default_rng(seed)`, as in the
JAX package.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from deeplearning4j_tpu_torch.nlp.lookup import (
    infer_hs_step,
    infer_sgns_step,
    to_numpy,
)
from deeplearning4j_tpu_torch.nlp.sequencevectors import SequenceVectors
from deeplearning4j_tpu_torch.nlp.text import (
    LabelAwareIterator,
    LabelAwareListSentenceIterator,
    SentenceTransformer,  # noqa: F401
    TokenizerFactory,
)
from deeplearning4j_tpu_torch.nlp.vocab import sample_negatives


class ParagraphVectors(SequenceVectors):
    """Doc embeddings. sequence_learning_algorithm: 'dbow' (default,
    reference DBOW.java) or 'dm' (reference DM.java)."""

    def __init__(self, sequence_learning_algorithm: str = "dbow", **kw):
        algo = sequence_learning_algorithm.lower()
        kw.setdefault("elements_learning_algorithm",
                      "cbow" if algo == "dm" else "skipgram")
        self.train_words = kw.pop("train_words", True)
        super().__init__(**kw)
        self.sequence_algorithm = algo
        self.labels: List[str] = []
        self._label_index: Dict[str, int] = {}
        self._doc_labels: List[List[str]] = []
        self._max_labels_per_doc = 1
        self._iterator: Optional[LabelAwareIterator] = None
        self._factory: Optional[TokenizerFactory] = None

    # Builder is attached at module bottom (shares Word2Vec.Builder surface)

    # ----------------------------------------------------------- corpus
    def _load_corpus(self, docs=None, labels=None):
        """Returns (token_sequences, per-sequence label lists)."""
        if docs is not None:
            it = LabelAwareListSentenceIterator(docs, labels)
        else:
            it = self._iterator
        if it is None:
            raise ValueError("No corpus: pass docs or set an iterator")
        seqs, doc_labels = [], []
        factory = self._factory
        for d in it:
            toks = (factory.create(d.content).get_tokens() if factory
                    else d.content.split())
            if toks:
                seqs.append(toks)
                doc_labels.append(list(d.labels))
        return seqs, doc_labels

    def _extra_rows(self) -> int:
        return len(self.labels)

    def _max_extra_context(self) -> int:
        # PV-DM appends every doc label as a context column
        return (self._max_labels_per_doc
                if self.sequence_algorithm == "dm" else 0)

    # ----------------------------------------------------------- training
    def fit(self, docs=None, labels=None):
        if self.use_device_pipeline:
            raise ValueError(
                "device pipeline does not support extra label rows "
                "(ParagraphVectors) — use the host path")
        seqs, doc_labels = self._load_corpus(docs, labels)
        self._doc_labels = doc_labels
        # register labels before vocab init so syn0 gets the extra rows
        self.labels = sorted({l for ls in doc_labels for l in ls})
        self._max_labels_per_doc = max(
            (len(ls) for ls in doc_labels), default=1)
        self.build_vocab(seqs)
        V = self.vocab.num_words()
        self._label_index = {l: V + i for i, l in enumerate(self.labels)}
        label_rows = [[self._label_index[l] for l in ls] for ls in doc_labels]

        total = self.vocab.total_word_occurrences * self.epochs
        done = 0.0
        for _ in range(self.epochs):
            done = self._train_corpus(
                seqs, total, label_for_sequence=lambda si: label_rows[si],
                words_done=done)
        self._finalize_losses()
        return self

    # ----------------------------------------------------------- queries
    def get_label_vector(self, label: str) -> Optional[np.ndarray]:
        i = self._label_index.get(label)
        return None if i is None else self.lookup_table.vector(i)

    def similarity_to_label(self, words: Sequence[str], label: str) -> float:
        lv = self.get_label_vector(label)
        if lv is None:
            return float("nan")
        vecs = [self.get_word_vector(w) for w in words]
        vecs = [v for v in vecs if v is not None]
        if not vecs:
            return float("nan")
        m = np.mean(vecs, axis=0)
        denom = np.linalg.norm(m) * np.linalg.norm(lv)
        return float(m @ lv / max(denom, 1e-12))

    def nearest_labels(self, text: str, top_n: int = 3) -> List[str]:
        vec = self.infer_vector(text)
        sims = []
        for l in self.labels:
            lv = self.get_label_vector(l)
            denom = np.linalg.norm(vec) * np.linalg.norm(lv)
            sims.append((float(vec @ lv / max(denom, 1e-12)), l))
        sims.sort(reverse=True)
        return [l for _, l in sims[:top_n]]

    def infer_vector(self, text: str, steps: int = 20,
                     lr: Optional[float] = None) -> np.ndarray:
        """Embed an unseen document (reference ParagraphVectors.inferVector):
        gradient steps on ONE new vector, output weights frozen."""
        toks = (self._factory.create(text).get_tokens() if self._factory
                else text.split())
        idx = np.array([i for i in (self.vocab.index_of(t) for t in toks)
                        if i >= 0], np.int32)
        if idx.size == 0:
            return np.zeros(self.layer_size, np.float32)
        lr = lr or self.learning_rate
        rng = np.random.default_rng(self.seed)
        t = self.lookup_table
        vec = torch.as_tensor(
            (rng.random(self.layer_size) - 0.5) / self.layer_size,
            dtype=t.dtype, device=t.syn0.device)
        if self.use_hs:
            codes, points, mask = (self._codes[idx], self._points[idx],
                                   self._mask[idx])
            for _ in range(steps):
                vec, _ = infer_hs_step(vec, t.syn1, codes, points, mask, lr)
        else:
            for _ in range(steps):
                negs = sample_negatives(self._cum_table,
                                        (idx.size, max(self.negative, 1)),
                                        rng)
                vec, _ = infer_sgns_step(vec, t.syn1neg, idx, negs, lr)
        return to_numpy(vec)


# Builder with the same chainable surface as Word2Vec.Builder ---------------
from deeplearning4j_tpu_torch.nlp.word2vec import Word2Vec as _W2V  # noqa: E402


class _PVBuilder(_W2V.Builder):
    def __init__(self):
        super().__init__()
        self._seq_algo = "dbow"
        self._label_iterator = None

    def sequence_learning_algorithm(self, name: str):
        self._seq_algo = "dm" if "dm" in name.lower() else "dbow"
        return self

    def label_aware_iterator(self, it: LabelAwareIterator):
        self._label_iterator = it
        return self

    def build(self) -> ParagraphVectors:
        pv = ParagraphVectors(sequence_learning_algorithm=self._seq_algo,
                              **self._kw)
        pv._iterator = self._label_iterator
        pv._factory = self._factory
        return pv


ParagraphVectors.Builder = _PVBuilder
ParagraphVectors.builder = staticmethod(lambda: _PVBuilder())
