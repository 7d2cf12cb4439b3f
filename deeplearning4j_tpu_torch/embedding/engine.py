"""The embedding engine: SGNS and hierarchical-softmax train steps over
device-resident tables, scored by the K13 kernel (JAX counterpart
deeplearning4j_tpu/embedding/engine.py).

Reference (SURVEY §2.3 / §L7): InMemoryLookupTable + SkipGram HS/NS are
the training core of the reference's embeddings library. The JAX engine
row-shards `syn0`/`syn1`/`syn1neg` over an `expert` (ep) mesh axis and
exchanges sparse (indices, values) gradients over a `data` (dp) axis;
at ep = dp = 1 every masking and psum op it adds is value-preserving, so
its step equals the legacy dense step (nlp/lookup.sgns_step /
sg_hs_step). This port runs that ep = dp = 1 engine: the gathers are
plain indexing (`table[idx]`), the scores come from
`ops/fused_neg_softmax.neg_softmax_scores` (K13 on CUDA), and the
updates are `nlp/lookup._scatter_update`'s summed, capped SGD, in place.

ep > 1 and dp > 1 need NCCL and sharded tables: they raise
NotImplementedError (ROADMAP Queue A item 7). The telemetry recorder
spans, the memory ledger and the retrace counter wait for the telemetry
port (Queue A item 9); `table_bytes_per_device` is computed from the
tensors.
"""

from __future__ import annotations

import numpy as np
import torch

from deeplearning4j_tpu_torch import resolve_device
from deeplearning4j_tpu_torch.nlp.lookup import (
    _index,
    cosine,
    init_tables,
    nearest_rows,
    sg_hs_step,
    sgns_step,
    to_numpy,
)
from deeplearning4j_tpu_torch.ops.fused_neg_softmax import neg_softmax_scores


class ShardedEmbeddingEngine:
    """Embedding tables + SGNS / hierarchical-softmax train steps.
    Construction mirrors InMemoryLookupTable (same seed -> same init);
    `EngineLookupView` adapts the query API."""

    def __init__(self, vocab_size: int, vector_length: int, *,
                 ep: int = 1, dp: int = 1, negative: int = 5,
                 use_hs: bool = False, seed: int = 123,
                 dtype=torch.float32, device=None):
        if vocab_size <= 0 or vector_length <= 0:
            raise ValueError("vocab_size and vector_length must be positive")
        if int(ep) != 1 or int(dp) != 1:
            raise NotImplementedError(
                f"ShardedEmbeddingEngine(ep={ep}, dp={dp}): row-sharded "
                "tables and the sparse gradient exchange need NCCL and wait "
                "for the parallel slice (ROADMAP Queue A item 7); the port "
                "runs ep=1, dp=1")
        self.vocab_size = int(vocab_size)
        self.vector_length = int(vector_length)
        self.negative = int(negative)
        self.use_hs = bool(use_hs)
        self.seed = int(seed)
        self.dtype = dtype
        self.device = resolve_device(device)
        self.loss_history = []
        self.reset_weights()

    # ------------------------------------------------------------- state
    def reset_weights(self):
        self.syn0, self.syn1, self.syn1neg = init_tables(
            self.vocab_size, self.vector_length, self.seed, self.dtype,
            self.device)

    def table_bytes_per_device(self) -> int:
        """Bytes of the three tables on the engine's device."""
        return sum(t.numel() * t.element_size()
                   for t in (self.syn0, self.syn1, self.syn1neg))

    # ------------------------------------------------------- train steps
    def sgns_step(self, center, context, negatives, lr):
        """One SGNS step over a fixed-shape pair batch: center [B],
        context [B], negatives [B, K], scalar lr. Returns the device
        loss scalar (no host sync)."""
        dev = self.device
        _, _, loss = sgns_step(self.syn0, self.syn1neg, _index(center, dev),
                               _index(context, dev), _index(negatives, dev),
                               lr, scores=neg_softmax_scores)
        self.loss_history.append(loss)
        return loss

    def hs_step(self, center, codes, points, mask, lr):
        """One hierarchical-softmax step: center [B], codes/points/mask
        [B, L] (Huffman rows gathered host-side, like the legacy path)."""
        _, _, loss = sg_hs_step(self.syn0, self.syn1, center, codes, points,
                                mask, lr)
        self.loss_history.append(loss)
        return loss

    # ----------------------------------------------------------- lookup
    def embed(self, ids) -> torch.Tensor:
        """Gather `syn0` rows for `ids` [n]: the device [n, D]."""
        return self.syn0[_index(ids, self.device)]


class EngineLookupView:
    """InMemoryLookupTable's query API over the engine — what
    SequenceVectors/serializers see when the engine is installed. The
    tables can be assigned through the view (weights_io copies a JAX
    table in that way)."""

    def __init__(self, engine: ShardedEmbeddingEngine):
        self._engine = engine
        self.use_hs = engine.use_hs
        self.negative = engine.negative
        self.dtype = engine.dtype

    @property
    def engine(self) -> ShardedEmbeddingEngine:
        return self._engine

    @property
    def vocab_size(self) -> int:
        return self._engine.vocab_size

    @property
    def vector_length(self) -> int:
        return self._engine.vector_length

    def _set(self, name, value):
        e = self._engine
        value = torch.as_tensor(value, dtype=e.dtype, device=e.device)
        if tuple(value.shape) != (e.vocab_size, e.vector_length):
            raise ValueError(
                f"{name} shape {tuple(value.shape)} != engine table "
                f"{(e.vocab_size, e.vector_length)}")
        setattr(e, name, value.contiguous())

    syn0 = property(lambda self: self._engine.syn0,
                    lambda self, v: self._set("syn0", v))
    syn1 = property(lambda self: self._engine.syn1,
                    lambda self, v: self._set("syn1", v))
    syn1neg = property(lambda self: self._engine.syn1neg,
                       lambda self, v: self._set("syn1neg", v))

    def reset_weights(self):
        self._engine.reset_weights()

    # vectors -------------------------------------------------------------
    def vector(self, index: int) -> np.ndarray:
        return to_numpy(self._engine.embed([index])[0])

    def vectors(self) -> np.ndarray:
        return to_numpy(self.syn0)

    def set_vectors(self, arr: np.ndarray):
        self._set("syn0", torch.as_tensor(np.asarray(arr)).clone())

    # similarity ----------------------------------------------------------
    def nearest(self, query_vec: np.ndarray, top_n: int = 10,
                exclude=()) -> list:
        return nearest_rows(self.syn0, query_vec, top_n, exclude)

    def similarity(self, i: int, j: int) -> float:
        rows = self._engine.embed([i, j])
        return cosine(rows[0], rows[1])
