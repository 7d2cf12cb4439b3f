"""The ep-sharded embedding engine: row-partitioned tables, a sparse
gather forward scored by the K13 kernel, and an (indices, values)
scatter-add backward (JAX counterpart deeplearning4j_tpu/embedding/
engine.py).

Reference (SURVEY §2.3 / §L7): InMemoryLookupTable + SkipGram HS/NS are
the training core of the reference's embeddings library; the legacy port
(nlp/lookup.py) runs them as dense single-device steps. This engine is
the mesh-native redesign, the cross-replica-sharding shape of
arXiv:2004.13336 applied to the embedding table itself:

* `syn0` / `syn1` / `syn1neg` rows are partitioned across the "expert"
  (ep) axis: the tables pad to an ep multiple and shard e holds rows
  [e * V/ep, (e + 1) * V/ep). `table_bytes_per_device` is one shard's
  three tables, so ep = 2 halves the footprint; it reads through the
  engine's memory ledger (`ledger`, telemetry/memstat.py), where the
  first shard's tables stand under "params".
* Forward is a SPARSE GATHER (`_ep_gather`): each shard takes the rows
  it owns (a masked take: other rows give zeros) and the shards' strips
  are summed into the full [B, D] strips. The K13 kernel
  (ops/fused_neg_softmax.py) then scores them, once a step whatever ep
  is.
* Backward travels as (indices, values) COO pairs — the overlap layer's
  sparse bucket (parallel/overlap.sparse_bucket_reduce) over the "data"
  (dp) axis — and each shard scatter-adds ONLY its owned rows with the
  legacy per-row trust-region cap (`_ep_scatter_update`). The gradient
  is never materialized at the table's shape on the wire.
* At ep = dp = 1 every masking and sum it adds is value-preserving, so
  the engine equals nlp/lookup.sgns_step / sg_hs_step; at ep > 1 each
  row is owned by one shard and the others add exact zeros, so ep = 2
  and 4 equal ep = 1 bit for bit on the CPU. dp > 1 sums the data
  shards' pairs in another order (f32 sum order).

Transport, as ops/shard_comm.py: by default one shard a rank over a
process group — `parallel.make_mesh({"data": dp, "expert": ep})` over a
fleet of exactly dp * ep ranks; the strips are summed by an f32
all-reduce over "expert", the pairs all-gathered over "data". With
``in_process=True`` all dp * ep shards run in this process on one
device: the strips summed in f32 in shard order, the pairs joined in
shard order, and the data shards' rows scored together in one K13
launch. ep or dp > 1 without the ranks (and without ``in_process``)
raises. Spans `scatter_add` (every step) and `gather` (`embed`) and the
`bucket_plan` event go to the telemetry recorder.
"""

from __future__ import annotations

import threading

import numpy as np
import torch

from deeplearning4j_tpu_torch import resolve_device
from deeplearning4j_tpu_torch.nlp.lookup import (  # noqa: F401
    MAX_ROW_STEP,
    DenseTables,
    _index,
    _scatter_update,
    cosine,
    init_tables,
    nearest_rows,
    sg_hs_step,
    sgns_step,
    to_numpy,
)
from deeplearning4j_tpu_torch.ops.fused_neg_softmax import neg_softmax_scores
from deeplearning4j_tpu_torch.parallel.mesh import make_mesh
from deeplearning4j_tpu_torch.telemetry import get_default
from deeplearning4j_tpu_torch.telemetry.memstat import MemoryLedger
from deeplearning4j_tpu_torch.parallel.overlap import (
    plan_sparse_bucket,
    sparse_bucket_reduce,
)

TABLES = ("syn0", "syn1", "syn1neg")

# mesh axis names of the engine's process-group layout
EP_AXIS = "expert"
DP_AXIS = "data"


def _ep_gather(shards, ep_ids, v_local, idx, ep_group=None, whole=False):
    """Sparse gather across the "expert" shards: each shard takes the
    rows of its [V/ep, D] table that `idx` names (a masked take:
    out-of-shard indices give zero rows) and the strips are summed — an
    f32 all-reduce over `ep_group`, or in shard order for the shards of
    this process. idx [...], returns [..., D]. A `whole` table (ep = 1)
    gathers by plain indexing, which gives the same values."""
    if whole:
        return shards[0][idx]
    parts = []
    for e, local in zip(ep_ids, shards):
        rel = idx - e * v_local
        owned = (rel >= 0) & (rel < v_local)
        rows = local[torch.where(owned, rel, 0)]
        parts.append(torch.where(owned[..., None], rows,
                                 rows.new_zeros(())))
    if ep_group is not None:
        from deeplearning4j_tpu_torch.ops.shard_comm import _all_reduce_f32

        return _all_reduce_f32(parts[0], ep_group)
    acc = parts[0].to(torch.float32)
    for p in parts[1:]:
        acc = acc + p.to(torch.float32)
    return acc.to(parts[0].dtype)


def _ep_scatter_update(local, lo, v_local, idx, grads, lr, whole=False):
    """Owned-rows scatter-add + SGD with the legacy per-row trust-region
    cap (nlp/lookup._scatter_update, applied to one shard — each global
    row lives on exactly one shard, so the row sums and norms match the
    dense formulation's). idx [N], grads [N, D]; in place. A whole
    table (`whole`) takes the dense update as it is."""
    if whole:
        return _scatter_update(local, idx, grads, lr)
    rel = idx - lo
    owned = (rel >= 0) & (rel < v_local)
    safe = torch.where(owned, rel, 0)
    grads = torch.where(owned[:, None], grads, grads.new_zeros(()))
    return _scatter_update(local, safe, grads, lr)


class ShardedEmbeddingEngine:
    """Row-sharded embedding tables + SGNS / hierarchical-softmax train
    steps. Construction mirrors InMemoryLookupTable (same seed -> the
    same init at every ep); `EngineLookupView` adapts the query API."""

    def __init__(self, vocab_size: int, vector_length: int, *,
                 ep: int = 1, dp: int = 1, negative: int = 5,
                 use_hs: bool = False, seed: int = 123,
                 dtype=torch.float32, device=None,
                 in_process: bool = False, recorder=None):
        if vocab_size <= 0 or vector_length <= 0:
            raise ValueError("vocab_size and vector_length must be positive")
        if int(ep) < 1 or int(dp) < 1:
            raise ValueError(f"ep and dp must be >= 1, got ep={ep} dp={dp}")
        self.vocab_size = int(vocab_size)
        self.vector_length = int(vector_length)
        self.ep = int(ep)
        self.dp = int(dp)
        self.negative = int(negative)
        self.use_hs = bool(use_hs)
        self.seed = int(seed)
        self.dtype = dtype
        # rows pad to an ep multiple so every shard owns an equal part;
        # padding rows are zero and never indexed by real ids
        self.padded_vocab = -(-self.vocab_size // self.ep) * self.ep
        self.in_process = bool(in_process) or self.ep * self.dp == 1
        if self.in_process:
            self.mesh = None
            self.device = resolve_device(device)
            self._ep_ids = tuple(range(self.ep))
            self._dp_ids = tuple(range(self.dp))
            self._ep_group = self._dp_group = None
        else:
            self.mesh = self._make_mesh(device)
            self.device = self.mesh.device
            self._ep_ids = (self.mesh.axis_index(EP_AXIS),)
            self._dp_ids = (self.mesh.axis_index(DP_AXIS),)
            self._ep_group = self.mesh.group(EP_AXIS)
            self._dp_group = self.mesh.group(DP_AXIS)
        self._recorder = recorder if recorder is not None else get_default()
        self._buckets = {}          # (kind, *shape) -> sparse bucket plans
        self._mu = threading.Lock()
        self.loss_history = []
        self.reset_weights()
        self.ledger = MemoryLedger()
        self.ledger.register("params", self._first_shards)

    def _make_mesh(self, device):
        from deeplearning4j_tpu_torch.distributed import bootstrap

        if not bootstrap.is_initialized():
            raise ValueError(
                f"ShardedEmbeddingEngine(ep={self.ep}, dp={self.dp}) runs "
                f"one shard a rank over a process group of {self.ep * self.dp} "
                "ranks, and none is up: start the ranks "
                "(distributed.launcher.launch_local, then "
                "distributed.initialize()), or pass in_process=True to run "
                "every shard in this process")
        return make_mesh({DP_AXIS: self.dp, EP_AXIS: self.ep}, device=device)

    # ------------------------------------------------------------- state
    @property
    def v_local(self) -> int:
        """Rows a shard holds."""
        return self.padded_vocab // self.ep

    def reset_weights(self):
        """syn0 = (rand - 0.5) / dim over the vocab rows (the legacy
        table's init, nlp/lookup.init_tables — so every ep starts from
        the same rows), zero padding rows, zero syn1 / syn1neg; each
        shard keeps its rows."""
        whole = init_tables(self.vocab_size, self.vector_length, self.seed,
                            self.dtype, self.device)
        self._shards = {name: self._split(t) for name, t in
                        zip(TABLES, whole)}

    def _split(self, table):
        """This process's shards of a [V or padded V, D] table."""
        pad = self.padded_vocab - table.shape[0]
        if pad:
            table = torch.cat([table, table.new_zeros(
                (pad, table.shape[1]))])
        if self.ep == 1:
            return [table.contiguous()]
        vl = self.v_local
        return [table[e * vl:(e + 1) * vl].clone() for e in self._ep_ids]

    def _whole(self, name):
        """The [padded V, D] table `name`: the live tensor when one shard
        holds it all, else the shards joined (over the process group an
        all-gather over "expert", a collective)."""
        shards = self._shards[name]
        if self.ep == 1:
            return shards[0]
        if self._ep_group is None:
            return torch.cat(shards)
        import torch.distributed as dist

        parts = [torch.empty_like(shards[0]) for _ in range(self.ep)]
        dist.all_gather(parts, shards[0].contiguous(), group=self._ep_group)
        return torch.cat(parts)

    def _set_whole(self, name, value):
        value = torch.as_tensor(value, dtype=self.dtype, device=self.device)
        if tuple(value.shape) not in ((self.vocab_size, self.vector_length),
                                      (self.padded_vocab,
                                       self.vector_length)):
            raise ValueError(
                f"{name} shape {tuple(value.shape)} != engine table "
                f"{(self.vocab_size, self.vector_length)}")
        self._shards[name] = self._split(value.contiguous())

    syn0 = property(lambda self: self._whole("syn0"),
                    lambda self, v: self._set_whole("syn0", v))
    syn1 = property(lambda self: self._whole("syn1"),
                    lambda self, v: self._set_whole("syn1", v))
    syn1neg = property(lambda self: self._whole("syn1neg"),
                       lambda self, v: self._set_whole("syn1neg", v))

    def _first_shards(self) -> list:
        """The ledger's source: the first shard's three tables (what each
        device holds)."""
        return [self._shards[n][0] for n in TABLES]

    def table_bytes_per_device(self) -> int:
        """Bytes of one shard's three tables: what each device holds,
        read through the memory ledger."""
        return int(self.ledger.attributed().get("params", 0))

    # ------------------------------------------------------- train steps
    def _gather(self, name, idx):
        return _ep_gather(self._shards[name], self._ep_ids, self.v_local,
                          idx, self._ep_group, whole=self.ep == 1)

    def _update(self, name, idx, grads, lr):
        whole = self.ep == 1
        for e, local in zip(self._ep_ids, self._shards[name]):
            _ep_scatter_update(local, e * self.v_local, self.v_local, idx,
                               grads, lr, whole=whole)

    def _local_rows(self, batch: int) -> slice:
        """The batch rows this process computes: its data shard's over a
        process group, every row in process."""
        if self._dp_group is None or self.dp == 1:
            return slice(0, batch)
        b = batch // self.dp
        d = self._dp_ids[0]
        return slice(d * b, (d + 1) * b)

    def _plans(self, kind, batch, depth, pair_rows):
        """The step's two sparse bucket plans (center rows, output rows)
        at dp > 1, built once a shape and put on the record."""
        key = (kind, batch, depth)
        with self._mu:
            plans = self._buckets.get(key)
        if plans is None:
            b_local = batch // self.dp
            names = (("sgns_syn0", "sgns_syn1neg") if kind == "sgns"
                     else ("hs_syn0", "hs_syn1"))
            plans = (plan_sparse_bucket(names[0], b_local,
                                        self.vector_length,
                                        n_participants=self.dp),
                     plan_sparse_bucket(names[1], b_local * pair_rows,
                                        self.vector_length,
                                        n_participants=self.dp))
            self._recorder.event(
                "bucket_plan", sparse=True, step=kind, ep=self.ep,
                dp=self.dp, buckets=[p.summary() for p in plans])
            with self._mu:
                plans = self._buckets.setdefault(key, plans)
        return plans

    def _exchange(self, pairs, bucket):
        """The data shards' (indices, values) pairs joined over "data":
        all-gathered over the process group, or joined in shard order in
        process. `pairs` holds this process's data shards' pairs."""
        if self.dp == 1:
            return pairs[0]
        if self._dp_group is None:
            return sparse_bucket_reduce([p[0] for p in pairs],
                                        [p[1] for p in pairs], bucket=bucket)
        (idx, vals), = pairs
        return sparse_bucket_reduce(idx, vals, self._dp_group, self.dp,
                                    bucket=bucket)

    def _data_pairs(self, batch, idx_parts, val_parts):
        """Split row-major pieces into the data shards' pairs: each shard
        takes its rows of every piece, in piece order (center rows: one
        piece; output rows: the context rows then the negatives')."""
        if self.dp == 1 or self._dp_group is not None:
            return [(torch.cat(idx_parts) if len(idx_parts) > 1
                     else idx_parts[0],
                     torch.cat(val_parts) if len(val_parts) > 1
                     else val_parts[0])]
        b = batch // self.dp
        out = []
        for d in self._dp_ids:
            ids = [p.reshape(batch, -1)[d * b:(d + 1) * b].reshape(-1)
                   for p in idx_parts]
            vals = [v.reshape(batch, -1, v.shape[-1])[d * b:(d + 1) * b]
                    .reshape(-1, v.shape[-1]) for v in val_parts]
            out.append((torch.cat(ids) if len(ids) > 1 else ids[0],
                        torch.cat(vals) if len(vals) > 1 else vals[0]))
        return out

    def _batch_sum(self, x):
        """The sum of x [B, ...] over the global batch: over the process
        group's data shards an f32 all-reduce of each shard's sum; in
        process the data shards' sums added in shard order (one sum at
        dp = 1)."""
        if self.dp == 1:
            return x.sum()
        if self._dp_group is not None:
            from deeplearning4j_tpu_torch.ops.shard_comm import (
                _all_reduce_f32,
            )

            return _all_reduce_f32(x.sum(), self._dp_group)
        parts = x.reshape(self.dp, -1).sum(1)
        acc = parts[0]
        for p in parts[1:]:
            acc = acc + p
        return acc

    def _check_batch(self, batch):
        if batch % self.dp:
            raise ValueError(f"batch {batch} does not split over dp="
                             f"{self.dp} data shards")

    def _pair_bytes(self, n_rows: int) -> int:
        """Wire bytes of an (indices, values) gradient pair."""
        itemsize = torch.empty((), dtype=self.dtype).element_size()
        return n_rows * (4 + self.vector_length * itemsize)

    def _gather_bytes(self, n_rows: int) -> int:
        """Bytes the forward sparse gather moves across the ep axis:
        each summed [rows, D] strip carries (ep-1)/ep remote rows."""
        itemsize = torch.empty((), dtype=self.dtype).element_size()
        return n_rows * self.vector_length * itemsize * (self.ep - 1) \
            // self.ep

    def _local(self, batch, *arrays):
        """This process's rows of the step's global batch arrays."""
        self._check_batch(batch)
        rows = self._local_rows(batch)
        return [a[rows] for a in arrays]

    def sgns_step(self, center, context, negatives, lr):
        """One SGNS step over a fixed-shape pair batch: center [B],
        context [B], negatives [B, K] (the global batch: over a process
        group every rank passes it whole and computes its data shard's
        rows), scalar lr. nlp/lookup.sgns_step over the shards. Returns
        the device loss scalar (no host sync)."""
        dev = self.device
        center, context, negatives = (_index(a, dev) for a in
                                      (center, context, negatives))
        batch, k = negatives.shape
        sparse_rows = batch * (2 + k)
        with self._recorder.span(
                "scatter_add", step="sgns", rows=sparse_rows,
                bytes=self._pair_bytes(sparse_rows), ep=self.ep,
                ep_gather_bytes=self._gather_bytes(sparse_rows)):
            plans = (self._plans("sgns", batch, k, 1 + k) if self.dp > 1
                     else (None, None))
            _, _, loss = sgns_step(
                "syn0", "syn1neg",
                *self._local(batch, center, context, negatives), lr,
                tables=_ShardTables(self, batch, plans))
        self.loss_history.append(loss)
        return loss

    def hs_step(self, center, codes, points, mask, lr):
        """One hierarchical-softmax step: center [B], codes/points/mask
        [B, L] (Huffman rows gathered host-side, like the legacy path;
        the global batch, as `sgns_step`). nlp/lookup.sg_hs_step over
        the shards."""
        dev = self.device
        center, points = _index(center, dev), _index(points, dev)
        codes = torch.as_tensor(np.asarray(codes), device=dev)
        mask = torch.as_tensor(np.asarray(mask), device=dev).bool()
        batch, depth = codes.shape
        sparse_rows = batch * (1 + depth)
        with self._recorder.span(
                "scatter_add", step="hs", rows=sparse_rows,
                bytes=self._pair_bytes(sparse_rows), ep=self.ep,
                ep_gather_bytes=self._gather_bytes(sparse_rows)):
            plans = (self._plans("hs", batch, depth, depth) if self.dp > 1
                     else (None, None))
            _, _, loss = sg_hs_step(
                "syn0", "syn1",
                *self._local(batch, center, codes, points, mask), lr,
                tables=_ShardTables(self, batch, plans))
        self.loss_history.append(loss)
        return loss

    # ----------------------------------------------------------- lookup
    def embed(self, ids) -> torch.Tensor:
        """Sparse-gather `syn0` rows for `ids` [n] across the ep shards
        (over a process group a collective: every rank calls it). Returns
        the device [n, D]."""
        idx = _index(ids, self.device)
        n = int(idx.shape[0])
        itemsize = torch.empty((), dtype=self.dtype).element_size()
        with self._recorder.span("gather", rows=n, ep=self.ep,
                                 bytes=n * (self.vector_length * itemsize
                                            + 4)):
            return self._gather("syn0", idx)


class _ShardTables(DenseTables):
    """The engine's tables for one step of nlp/lookup's: a table is named
    ("syn0", "syn1", "syn1neg"); it is read by the sparse gather over the
    "expert" shards and updated on its owned rows after the data shards'
    pairs are exchanged (the center rows' bucket for syn0, the output
    rows' for the others); the batch's sums and rows are the global
    batch's; the K13 kernel scores."""

    def __init__(self, engine, batch, plans):
        self._engine = engine
        self._batch = batch
        self._plans = plans

    def scores(self, h, pos, neg):
        return neg_softmax_scores(h, pos, neg)

    def device(self, table):
        return self._engine.device

    def gather(self, table, idx):
        return self._engine._gather(table, idx)

    def update(self, table, idx_parts, val_parts, lr):
        eng = self._engine
        idx, vals = eng._exchange(
            eng._data_pairs(self._batch, idx_parts, val_parts),
            self._plans[0] if table == "syn0" else self._plans[1])
        eng._update(table, idx, vals, lr)

    def batch_sum(self, x):
        return self._engine._batch_sum(x)

    def batch_rows(self, rows: int) -> int:
        return self._batch


class EngineLookupView:
    """InMemoryLookupTable's query API over the engine — what
    SequenceVectors/serializers see when the engine is installed. Reads
    slice the padding rows off (and, over a process group, gather the
    shards: a collective). The tables can be assigned through the view
    (weights_io copies a JAX table in that way)."""

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

    def _get(self, name):
        return getattr(self._engine, name)[:self._engine.vocab_size]

    def _set(self, name, value):
        setattr(self._engine, name, value)

    syn0 = property(lambda self: self._get("syn0"),
                    lambda self, v: self._set("syn0", v))
    syn1 = property(lambda self: self._get("syn1"),
                    lambda self, v: self._set("syn1", v))
    syn1neg = property(lambda self: self._get("syn1neg"),
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
