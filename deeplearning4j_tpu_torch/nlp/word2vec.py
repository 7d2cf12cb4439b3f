"""Word2Vec — skip-gram/CBOW word embeddings (JAX counterpart
deeplearning4j_tpu/nlp/word2vec.py).

Reference: models/word2vec/Word2Vec.java:33 (extends
SequenceVectors<VocabWord>; Builder:76+ wires SentenceIterator +
TokenizerFactory → SentenceTransformer → sequence iterator).

The tables live on CUDA unless the caller passes `device="cpu"` (or
`Builder.device("cpu")`).
"""

from __future__ import annotations

from typing import Iterable, List, Optional, Sequence

from deeplearning4j_tpu_torch.nlp.sequencevectors import SequenceVectors
from deeplearning4j_tpu_torch.nlp.text import (
    CollectionSentenceIterator,
    SentenceIterator,
    SentenceTransformer,
    TokenizerFactory,
)


class Word2Vec(SequenceVectors):
    """Word embeddings over a sentence corpus. Use the Builder (API parity
    with the reference) or construct directly with keyword args."""

    class Builder:
        def __init__(self):
            self._kw = {}
            self._iterator: Optional[SentenceIterator] = None
            self._factory: Optional[TokenizerFactory] = None
            self._stop: Sequence[str] = ()

        def iterate(self, it):
            if isinstance(it, (list, tuple)):
                it = CollectionSentenceIterator(it)
            self._iterator = it
            return self

        def tokenizer_factory(self, f: TokenizerFactory):
            self._factory = f
            return self

        def stop_words(self, words: Sequence[str]):
            self._stop = words
            return self

        def layer_size(self, n):
            self._kw["layer_size"] = n
            return self

        def window_size(self, n):
            self._kw["window_size"] = n
            return self

        def min_word_frequency(self, n):
            self._kw["min_word_frequency"] = n
            return self

        def epochs(self, n):
            self._kw["epochs"] = n
            return self

        def iterations(self, n):  # reference alias
            return self.epochs(n)

        def learning_rate(self, a):
            self._kw["learning_rate"] = a
            return self

        def min_learning_rate(self, a):
            self._kw["min_learning_rate"] = a
            return self

        def negative_sample(self, k):
            self._kw["negative"] = int(k)
            return self

        def use_hierarchic_softmax(self, flag=True):
            self._kw["use_hs"] = flag
            return self

        def sampling(self, s):
            self._kw["sampling"] = s
            return self

        def batch_size(self, b):
            self._kw["batch_size"] = b
            return self

        def seed(self, s):
            self._kw["seed"] = int(s)
            return self

        def workers(self, n: int):
            """Host-parallel vocabulary counting processes (reference
            Builder.workers — its multi-threaded VocabConstructor /
            Spark TextPipeline analogue; see nlp/distributed_vocab.py)."""
            self._kw["n_workers"] = int(n)
            return self

        def use_device_pipeline(self, flag=True):
            """Whole-epoch on-device training (see nlp/device_pipeline.py)."""
            self._kw["use_device_pipeline"] = flag
            return self

        def use_engine(self, flag=True, ep: int = 1, dp: int = 1):
            """Route skip-gram training through the embedding engine
            (embedding/engine.py; on by default), which scores with the
            K13 kernel on CUDA. ep > 1 / dp > 1 (row-sharded tables, the
            sparse gradient exchange) raise NotImplementedError."""
            self._kw["use_engine"] = flag
            self._kw["engine_ep"] = int(ep)
            self._kw["engine_dp"] = int(dp)
            return self

        def share_negatives(self, flag=True):
            """Per-center negative sharing in the device pipeline (default
            on; False = strict per-pair sampling)."""
            self._kw["pipeline_share_negatives"] = flag
            return self

        def device_mesh(self, mesh, chunk: int = 512, group=None):
            """Implies use_device_pipeline with `chunk` and `group`; a
            mesh (the JAX package's sharded chunk stream) raises at fit
            until the parallel slice (ROADMAP Queue A item 7), so only
            mesh=None trains."""
            self._kw["use_device_pipeline"] = True
            self._kw["device_mesh"] = mesh
            self._kw["pipeline_chunk"] = chunk
            self._kw["pipeline_group"] = group
            return self

        def negative_oversample(self, factor: float):
            """Shared-negative variance reduction: draw factor*K shared
            negatives each weighted K/M (expectation-identical to
            per-pair SGNS; default 2.0 — see nlp/device_pipeline.py)."""
            self._kw["pipeline_neg_oversample"] = float(factor)
            return self

        def device(self, device):
            """Where the tables live and the steps run (default CUDA)."""
            self._kw["device"] = device
            return self

        def elements_learning_algorithm(self, name: str):
            self._kw["elements_learning_algorithm"] = (
                "cbow" if "cbow" in name.lower() else "skipgram")
            return self

        def build(self) -> "Word2Vec":
            w2v = Word2Vec(**self._kw)
            w2v._iterator = self._iterator
            w2v._factory = self._factory
            w2v._stop = self._stop
            return w2v

    @staticmethod
    def builder() -> "Word2Vec.Builder":
        return Word2Vec.Builder()

    def __init__(self, **kw):
        # Word2Vec is a thin front-end over the embedding engine:
        # skip-gram flushes run the engine's step (the legacy dense
        # step's math, scored by the K13 kernel on CUDA). CBOW and
        # the device pipeline keep the legacy dense tables.
        kw.setdefault("use_engine", True)
        super().__init__(**kw)
        self._iterator = None
        self._factory = None
        self._stop = ()

    def _sequences(self) -> Iterable[List[str]]:
        if self._iterator is None:
            raise ValueError("No corpus: call Builder.iterate(...) or pass "
                             "sequences to fit()")
        return SentenceTransformer(self._iterator, self._factory, self._stop)

    def fit(self, sequences=None):
        if sequences is None:
            sequences = [list(t) for t in self._sequences()]
        return super().fit(sequences)

    # reference WordVectors API naming
    def word_vector(self, word: str):
        return self.get_word_vector(word)

    @property
    def vocab_size(self) -> int:
        return self.vocab.num_words() if self.vocab else 0
