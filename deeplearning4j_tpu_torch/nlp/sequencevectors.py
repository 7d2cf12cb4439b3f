"""SequenceVectors — the generic embedding training engine (JAX
counterpart deeplearning4j_tpu/nlp/sequencevectors.py).

Reference (SURVEY.md §2.3 "SequenceVectors engine" row):
models/sequencevectors/SequenceVectors.java:47 — fit():125 builds vocab,
spawns an AsyncSequencer producer + N HogWild VectorCalculationsThread
consumers racing on shared syn0/syn1 (:773,:867), per-sequence dispatch to
pluggable learning algorithms (SkipGram/CBOW/DBOW/DM).

Batched redesign (as in the JAX package): no racing threads — the host
walks sequences and fills fixed-size pair buffers (center, context,
negatives / huffman paths); each full buffer is ONE device step
(embedding/engine.py for skip-gram, nlp/lookup.py otherwise). Alpha
decays linearly over total expected words like word2vec. Determinism by
construction: a single seeded numpy Generator replaces the reference's
racing AtomicLong nextRandom, and the host loop draws from it in
exactly the JAX package's order, so both packages train on the same
pairs and negatives.

The tables live on `device` (CUDA unless the caller names another).
"""

from __future__ import annotations

from typing import Iterable, List, Optional, Sequence

import numpy as np
import torch

from deeplearning4j_tpu_torch import resolve_device
from deeplearning4j_tpu_torch.nlp.lookup import (
    InMemoryLookupTable,
    cbow_ns_step,
    sg_hs_step,
    sgns_step,
)
from deeplearning4j_tpu_torch.nlp.vocab import (
    Huffman,
    VocabCache,
    VocabConstructor,
    keep_probabilities,
    sample_negatives,
    subsample_mask,
    unigram_table,
)


def _fetch_loss_scalars(history):
    """Resolve a list of float|device-scalar losses to floats in one
    host round trip: the device scalars are stacked on the device and
    fetched together. Already-float entries pass through, so repeated
    fits don't re-fetch."""
    dev = [l for l in history if torch.is_tensor(l)]
    vals = iter(torch.stack(dev).float().cpu().tolist() if dev else [])
    return [l if not torch.is_tensor(l) else next(vals) for l in history]


class SequenceVectors:
    """Batched embedding trainer over token sequences.

    Parameters mirror the reference Builder: layer_size (vectorLength),
    window_size, min_word_frequency, iterations→epochs, learning_rate
    (alpha 0.025 default), min_learning_rate, negative samples, use_hs
    (hierarchical softmax), sampling (frequent-word subsampling), batch_size
    (device step size), seed.
    """

    def __init__(self, layer_size: int = 100, window_size: int = 5,
                 min_word_frequency: int = 1, epochs: int = 1,
                 learning_rate: float = 0.025,
                 min_learning_rate: float = 1e-4, negative: int = 5,
                 use_hs: bool = False, sampling: float = 0.0,
                 batch_size: int = 2048, seed: int = 123,
                 elements_learning_algorithm: str = "skipgram",
                 vocab_limit: Optional[int] = None,
                 use_device_pipeline: bool = False, device_mesh=None,
                 pipeline_chunk: int = 512, pipeline_group=None,
                 pipeline_share_negatives: bool = True,
                 pipeline_neg_oversample: float = 2.0,
                 n_workers: int = 1, use_engine: bool = False,
                 engine_ep: int = 1, engine_dp: int = 1, device=None):
        self.layer_size = layer_size
        self.window_size = window_size
        self.min_word_frequency = min_word_frequency
        self.epochs = epochs
        self.learning_rate = learning_rate
        self.min_learning_rate = min_learning_rate
        self.negative = negative
        self.use_hs = use_hs or negative == 0
        self.sampling = sampling
        self.batch_size = batch_size
        self.seed = seed
        self.algorithm = elements_learning_algorithm
        self.vocab_limit = vocab_limit
        # whole-epoch on-device training (nlp/device_pipeline.py), its
        # chunk groups split over a mesh's "data" axis when one is set
        self.use_device_pipeline = use_device_pipeline
        self.device_mesh = device_mesh
        self.pipeline_chunk = pipeline_chunk
        # None = auto: 2 chunks per update (1024-token updates at the
        # default chunk, the JAX package's quality default)
        self.pipeline_group = pipeline_group
        self.pipeline_share_negatives = pipeline_share_negatives
        # shared-negative variance reduction: oversample*K shared
        # negatives per center, each weighted K/M
        self.pipeline_neg_oversample = pipeline_neg_oversample
        self.n_workers = n_workers  # host-parallel vocab counting
        # route skip-gram flushes through the embedding engine
        # (embedding/engine.py): the K13 scoring kernel on CUDA, the
        # legacy dense step's math otherwise; ep / dp shards over the
        # process group
        self.use_engine = use_engine
        self.engine_ep = engine_ep
        self.engine_dp = engine_dp
        self.device = resolve_device(device)
        self._engine = None

        self.vocab: Optional[VocabCache] = None
        self.lookup_table: Optional[InMemoryLookupTable] = None
        self._rng = np.random.default_rng(seed)
        self._cum_table = None
        self._keep_prob = None
        self._codes = self._points = self._mask = None
        self.loss_history: List[float] = []

    # ------------------------------------------------------------ vocab
    def build_vocab(self, sequences: Iterable[List[str]]):
        constructor = VocabConstructor(self.min_word_frequency,
                                       self.vocab_limit,
                                       build_huffman=self.use_hs,
                                       n_workers=self.n_workers)
        constructor.add_source(sequences)
        self.vocab = constructor.build_joint_vocabulary()
        self._init_from_vocab()
        return self

    def _init_from_vocab(self):
        V = self.vocab.num_words()
        if V == 0:
            raise ValueError("Empty vocabulary — corpus too small or "
                             "min_word_frequency too high")
        if self._engine_eligible():
            # imported here: the engine imports nlp/lookup.py, and this
            # package's __init__ imports this module
            from deeplearning4j_tpu_torch.embedding.engine import (
                EngineLookupView,
                ShardedEmbeddingEngine,
            )

            self._engine = ShardedEmbeddingEngine(
                V, self.layer_size, ep=self.engine_ep, dp=self.engine_dp,
                negative=self.negative, use_hs=self.use_hs,
                seed=self.seed, device=self.device)
            self.lookup_table = EngineLookupView(self._engine)
        else:
            self._engine = None
            self.lookup_table = InMemoryLookupTable(
                V + self._extra_rows(), self.layer_size, seed=self.seed,
                use_hs=self.use_hs, negative=self.negative,
                device=self.device)
        if self.negative > 0:
            self._cum_table = unigram_table(self.vocab)
        if self.use_hs:
            self._codes, self._points, self._mask = Huffman(
                self.vocab.vocab_words()).build().padded_arrays()
        if self.sampling > 0:
            self._keep_prob = keep_probabilities(self.vocab, self.sampling)

    def _extra_rows(self) -> int:
        """Extra syn0 rows beyond the word vocab (ParagraphVectors labels)."""
        return 0

    def _engine_eligible(self) -> bool:
        """The engine serves plain skip-gram over the word vocab; CBOW,
        label rows (ParagraphVectors), and the device pipeline keep the
        legacy dense tables."""
        return (self.use_engine and self.algorithm == "skipgram"
                and self._extra_rows() == 0
                and not self.use_device_pipeline)

    # ------------------------------------------------------------ training
    def _sequence_indices(self, tokens: List[str]) -> np.ndarray:
        idx = [self.vocab.index_of(t) for t in tokens]
        arr = np.array([i for i in idx if i >= 0], dtype=np.int32)
        if self.sampling > 0 and arr.size:
            arr = arr[subsample_mask(arr, self._keep_prob, self._rng)]
        return arr

    def _pairs_for_sequence(self, idx: np.ndarray,
                            extra_centers: Sequence[int] = ()):
        """Skip-gram pair generation with the word2vec random-shrunk window
        (reference SkipGram windows: b = random(window)). Returns
        (centers, contexts) arrays. extra_centers (e.g. a doc label) pair
        with EVERY word (PV-DBOW)."""
        n = idx.size
        if n < 2:
            cen = np.repeat(np.asarray(extra_centers, np.int32), n)
            return cen, np.tile(idx, len(extra_centers))
        centers, contexts = [], []
        shrink = self._rng.integers(0, self.window_size, size=n)
        for i in range(n):
            w = self.window_size - shrink[i]
            lo, hi = max(0, i - w), min(n, i + w + 1)
            for j in range(lo, hi):
                if j != i:
                    centers.append(idx[i])
                    contexts.append(idx[j])
        for c in extra_centers:
            centers += [c] * n
            contexts += idx.tolist()
        return (np.asarray(centers, np.int32), np.asarray(contexts, np.int32))

    def _windows_for_sequence(self, idx: np.ndarray,
                              extra_context: Sequence[int] = ()):
        """CBOW windows: (context [n,W], mask [n,W], target [n]).
        extra_context columns (PV-DM doc label) are appended to every
        window."""
        n = idx.size
        W = 2 * self.window_size + len(extra_context)
        ctx = np.zeros((n, W), np.int32)
        mask = np.zeros((n, W), bool)
        shrink = self._rng.integers(0, self.window_size, size=max(n, 1))
        for i in range(n):
            w = self.window_size - shrink[i]
            neigh = [idx[j] for j in range(max(0, i - w), min(n, i + w + 1))
                     if j != i]
            k = len(neigh)
            ctx[i, :k] = neigh
            mask[i, :k] = True
            if extra_context:
                ctx[i, -len(extra_context):] = extra_context
                mask[i, -len(extra_context):] = True
        return ctx, mask, idx.copy()

    def _alpha(self, words_done: float, total_words: float) -> float:
        frac = min(1.0, words_done / max(total_words, 1.0))
        return max(self.min_learning_rate, self.learning_rate * (1.0 - frac))

    def _flush_sg(self, centers, contexts, lr):
        if self._engine is not None:
            if self.use_hs:
                loss = self._engine.hs_step(
                    centers, self._codes[contexts],
                    self._points[contexts], self._mask[contexts], lr)
            else:
                negs = sample_negatives(
                    self._cum_table, (len(centers), self.negative),
                    self._rng)
                loss = self._engine.sgns_step(centers, contexts, negs, lr)
            self.loss_history.append(loss)
            return
        t = self.lookup_table
        if self.use_hs:
            t.syn0, t.syn1, loss = sg_hs_step(
                t.syn0, t.syn1, centers, self._codes[contexts],
                self._points[contexts], self._mask[contexts], lr)
        else:
            negs = sample_negatives(self._cum_table,
                                    (len(centers), self.negative), self._rng)
            t.syn0, t.syn1neg, loss = sgns_step(
                t.syn0, t.syn1neg, centers, contexts, negs, lr)
        # keep the device scalar — a float() here would force a host
        # round trip per batch and stall the queue of device work
        self.loss_history.append(loss)

    def _flush_cbow(self, ctx, mask, targets, lr):
        t = self.lookup_table
        negs = sample_negatives(self._cum_table,
                                (len(targets), self.negative), self._rng)
        t.syn0, t.syn1neg, loss = cbow_ns_step(
            t.syn0, t.syn1neg, ctx, mask, targets, negs, lr)
        self.loss_history.append(loss)

    def _train_corpus(self, sequences, total_words: float,
                      label_for_sequence=None, words_done: float = 0.0):
        """One pass; label_for_sequence(seq_index) -> list of extra element
        indices (ParagraphVectors hooks in here). words_done carries the
        cross-epoch word count so alpha decays over the WHOLE run."""
        B = self.batch_size
        if self.algorithm == "skipgram":
            buf_c = np.empty(0, np.int32)
            buf_x = np.empty(0, np.int32)
            for si, tokens in enumerate(sequences):
                idx = self._sequence_indices(tokens)
                if idx.size == 0:
                    continue
                extra = label_for_sequence(si) if label_for_sequence else ()
                c, x = self._pairs_for_sequence(idx, extra)
                buf_c = np.concatenate([buf_c, c])
                buf_x = np.concatenate([buf_x, x])
                words_done += idx.size
                while buf_c.size >= B:
                    lr = self._alpha(words_done, total_words)
                    self._flush_sg(buf_c[:B], buf_x[:B], lr)
                    buf_c, buf_x = buf_c[B:], buf_x[B:]
            if buf_c.size:  # tail: pad by resampling existing pairs
                pad = self._rng.integers(0, buf_c.size, B - buf_c.size)
                self._flush_sg(np.concatenate([buf_c, buf_c[pad]]),
                               np.concatenate([buf_x, buf_x[pad]]),
                               self._alpha(words_done, total_words))
        elif self.algorithm == "cbow":
            W = 2 * self.window_size + self._max_extra_context()
            buf_ctx = np.empty((0, W), np.int32)
            buf_m = np.empty((0, W), bool)
            buf_t = np.empty(0, np.int32)
            for si, tokens in enumerate(sequences):
                idx = self._sequence_indices(tokens)
                if idx.size == 0:
                    continue
                extra = label_for_sequence(si) if label_for_sequence else ()
                ctx, m, tg = self._windows_for_sequence(idx, extra)
                if ctx.shape[1] < W:  # pad width for fixed device shapes
                    pad = W - ctx.shape[1]
                    ctx = np.pad(ctx, ((0, 0), (0, pad)))
                    m = np.pad(m, ((0, 0), (0, pad)))
                buf_ctx = np.concatenate([buf_ctx, ctx])
                buf_m = np.concatenate([buf_m, m])
                buf_t = np.concatenate([buf_t, tg])
                words_done += idx.size
                while buf_t.size >= B:
                    lr = self._alpha(words_done, total_words)
                    self._flush_cbow(buf_ctx[:B], buf_m[:B], buf_t[:B], lr)
                    buf_ctx, buf_m, buf_t = buf_ctx[B:], buf_m[B:], buf_t[B:]
            if buf_t.size:
                pad = self._rng.integers(0, buf_t.size, B - buf_t.size)
                self._flush_cbow(np.concatenate([buf_ctx, buf_ctx[pad]]),
                                 np.concatenate([buf_m, buf_m[pad]]),
                                 np.concatenate([buf_t, buf_t[pad]]),
                                 self._alpha(words_done, total_words))
        else:
            raise ValueError(f"Unknown learning algorithm {self.algorithm!r}")
        return words_done

    def _max_extra_context(self) -> int:
        return 0

    def fit(self, sequences):
        """Build vocab (if needed) and train (reference fit():125).
        `sequences`: reiterable of token lists (e.g. SentenceTransformer)."""
        seq_list = sequences if isinstance(sequences, list) else None
        if seq_list is None:
            # materialize BEFORE any per-element conversion: list(str) would
            # silently explode raw sentences into characters
            seq_list = list(sequences)
        if seq_list and not isinstance(seq_list[0], (str, list)):
            seq_list = [list(s) for s in seq_list]
        if self.vocab is None:
            vocab_src = ([line.split() for line in seq_list]
                         if seq_list and isinstance(seq_list[0], str)
                         else seq_list)
            self.build_vocab(vocab_src)
        corpus = seq_list
        if self.use_device_pipeline:
            return self._fit_device_pipeline(corpus)
        if isinstance(corpus, list) and corpus and isinstance(corpus[0], str):
            # the host loop consumes token lists; raw sentences would be
            # iterated character-by-character (training nothing)
            corpus = [line.split() for line in corpus]
        total = self.vocab.total_word_occurrences * self.epochs
        done = 0.0
        for _ in range(self.epochs):
            done = self._train_corpus(corpus, total, words_done=done)
        self._finalize_losses()
        return self

    def _fit_device_pipeline(self, corpus):
        """Whole-epoch training on the device (nlp/device_pipeline.py):
        the corpus is packed and uploaded once per epoch, and pair
        generation, negative sampling and the updates run on the device.
        Skip-gram and CBOW with negative sampling only; the other modes
        raise, as in the JAX package (asking for the pipeline is
        explicit, so a silent host-loop fallback would hide another
        training path)."""
        from deeplearning4j_tpu_torch.nlp.device_pipeline import (
            build_alias_table,
            make_cbow_epoch,
            make_sgns_epoch,
            pack_corpus,
            pack_corpus_flat,
        )
        from deeplearning4j_tpu_torch.parallel.mesh import data_shards

        if (self.algorithm not in ("skipgram", "cbow") or self.use_hs
                or self.negative <= 0):
            raise ValueError(
                "device pipeline supports skip-gram/CBOW with negative "
                "sampling (use_hs=False, negative>0); use the host path "
                "otherwise")
        if self._extra_rows():
            raise ValueError("device pipeline does not support extra label "
                             "rows (ParagraphVectors) — use the host path")
        group = self.pipeline_group
        n_dev = (data_shards(self.device_mesh)[0]
                 if self.device_mesh is not None else 1)
        if group is None:
            # auto: 2 chunks an update, rounded up to a multiple of the
            # mesh's data axis; pin a group for results that do not
            # depend on the shard count
            group = -(-2 // n_dev) * n_dev
        elif group % n_dev:
            raise ValueError(
                f"pipeline_group={group} does not divide over the "
                f"{n_dev}-way mesh data axis — set pipeline_group to a "
                f"multiple of {n_dev} (or leave it None for auto)")
        if self.algorithm == "cbow":
            epoch_fn = make_cbow_epoch(
                window=self.window_size, negative=self.negative,
                chunk=self.pipeline_chunk, group=group,
                mesh=self.device_mesh)
        else:
            epoch_fn = make_sgns_epoch(
                window=self.window_size, negative=self.negative,
                chunk=self.pipeline_chunk, group=group,
                mesh=self.device_mesh,
                share_negatives=self.pipeline_share_negatives,
                neg_oversample=self.pipeline_neg_oversample)
        t = self.lookup_table
        dev = t.syn0.device
        aJ, aq = build_alias_table(np.diff(self._cum_table, prepend=0.0))
        aJ = torch.from_numpy(aJ).to(dev)
        aq = torch.from_numpy(aq).to(dev)
        total = self.vocab.total_word_occurrences * self.epochs
        per_update = self.pipeline_chunk * group
        done = 0.0
        packed = None
        losses = []
        for _ in range(self.epochs):
            if packed is None or self.sampling > 0:
                # subsampling redraws per epoch (host rng, like the
                # reference); without it the packed corpus is uploaded
                # once and reused across epochs
                flat = self._corpus_flat_indices(corpus)
                if flat is not None:
                    tokens_np, sent_np = pack_corpus_flat(*flat, per_update)
                else:
                    tokens_np, sent_np = pack_corpus(
                        self._corpus_indices_seq(corpus), per_update)
                packed = (torch.from_numpy(tokens_np).to(dev),
                          torch.from_numpy(sent_np).to(dev))
            tokens, sent_ids = packed
            lr0 = self._alpha(done, total)
            lr1 = self._alpha(done + len(tokens), total)
            gen = torch.Generator(device=dev).manual_seed(
                self.seed + int(done) % (2**31))
            _, _, ls, pairs = epoch_fn(
                t.syn0, t.syn1neg, tokens, sent_ids, aJ, aq, gen, lr0, lr1)
            losses.append((ls, pairs))
            done += len(tokens)
        # one host fetch for the whole run
        for ls, pairs in losses:
            ls = ls.cpu().numpy()
            pairs = np.maximum(pairs.cpu().numpy(), 1.0)
            self.loss_history.extend((ls / pairs).tolist())
        return self

    def _corpus_flat_indices(self, corpus):
        """Corpus -> flat (ids, sentence_ids) with OOV dropped, or None
        when only the per-sentence path applies (subsampling draws from
        the host rng; pre-tokenized corpora of 64 sentences or fewer).
        Raw-string sentences go through the native one-pass corpus
        encoder (native.encode_corpus: the whitespace split and the vocab
        hash lookups of the whole corpus in one call), as the JAX
        package's do; without the core they are split in Python, which
        gives the same ids. Pre-tokenized corpora take one dict lookup
        over the whole corpus."""
        if self.sampling != 0:
            return None
        if corpus and isinstance(corpus[0], str):
            from deeplearning4j_tpu_torch import native

            enc = native.encode_corpus(corpus, self.vocab.words())
            if enc is not None:
                ids, sent = enc
                keep = ids >= 0
                return ids[keep], sent[keep]
            corpus = [line.split() for line in corpus]
        if len(corpus) <= 64:
            return None
        get = {w: i for i, w in enumerate(self.vocab.words())}.get
        flat_ids = np.fromiter((get(w, -1) for toks in corpus for w in toks),
                               np.int32)
        lengths = np.fromiter((len(t) for t in corpus), np.int64, len(corpus))
        sent = np.repeat(np.arange(len(corpus)), lengths)
        keep = flat_ids >= 0
        return flat_ids[keep], sent[keep].astype(np.int32)

    def _corpus_indices_seq(self, corpus):
        """Per-sentence path: tokenize raw-string sentences, then the
        (rng-dependent) per-sequence indices."""
        if corpus and isinstance(corpus[0], str):
            corpus = [line.split() for line in corpus]
        return [self._sequence_indices(toks) for toks in corpus]

    def _finalize_losses(self):
        """One deferred host sync for the whole run (see _flush_sg): a
        per-scalar float() would pay one full host round trip each."""
        if not self.loss_history:
            return
        self.loss_history = _fetch_loss_scalars(self.loss_history)

    # ------------------------------------------------------- vector queries
    # (reference embeddings/wordvectors/WordVectorsImpl.java API)
    def get_word_vector(self, word: str) -> Optional[np.ndarray]:
        i = self.vocab.index_of(word)
        return None if i < 0 else self.lookup_table.vector(i)

    def has_word(self, word: str) -> bool:
        return self.vocab is not None and word in self.vocab

    def similarity(self, a: str, b: str) -> float:
        ia, ib = self.vocab.index_of(a), self.vocab.index_of(b)
        if ia < 0 or ib < 0:
            return float("nan")
        return self.lookup_table.similarity(ia, ib)

    def words_nearest(self, word_or_vec, top_n: int = 10) -> List[str]:
        if isinstance(word_or_vec, str):
            i = self.vocab.index_of(word_or_vec)
            if i < 0:
                return []
            vec, exclude = self.lookup_table.vector(i), {i}
        else:
            vec, exclude = np.asarray(word_or_vec), set()
        V = self.vocab.num_words()
        # non-word rows (e.g. ParagraphVectors labels) may dominate the
        # neighborhood — fetch enough candidates to still return top_n words
        extra = self.lookup_table.vocab_size - V
        hits = self.lookup_table.nearest(vec, top_n + len(exclude) + extra,
                                         exclude=exclude)
        return [self.vocab.word_at_index(i) for i, _ in hits if i < V][:top_n]

    def words_nearest_sum(self, positive: List[str], negative: List[str],
                          top_n: int = 10) -> List[str]:
        """Analogy queries (reference WordVectorsImpl.wordsNearest(pos,neg))."""
        vec = np.zeros(self.layer_size, np.float32)
        exclude = set()
        for w in positive:
            i = self.vocab.index_of(w)
            if i >= 0:
                vec += self.lookup_table.vector(i)
                exclude.add(i)
        for w in negative:
            i = self.vocab.index_of(w)
            if i >= 0:
                vec -= self.lookup_table.vector(i)
                exclude.add(i)
        V = self.vocab.num_words()
        extra = self.lookup_table.vocab_size - V
        hits = self.lookup_table.nearest(vec, top_n + len(exclude) + extra,
                                         exclude=exclude)
        return [self.vocab.word_at_index(i) for i, _ in hits if i < V][:top_n]
