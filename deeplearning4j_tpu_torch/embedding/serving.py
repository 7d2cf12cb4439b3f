"""Vector-search serving: the embedding engine's front door (JAX
counterpart deeplearning4j_tpu/embedding/serving.py).

`EmbeddingServingEngine` plugs an embedding table (the trained
embedding/engine.py engine through its lookup view, or a published
[V, D] snapshot) and the ANN index (embedding/ann.py) into the serving
stack under the contracts the other engines honor:

* **Bucket lattice** (serving/buckets.py): request sizes are padded UP
  to the lattice's batch grid and every (bucket, k) shape runs at
  warmup under `compile` spans. PyTorch has no jit to count, so
  `trace_count` counts the first sight of each shape key (an embed
  bucket, a search (Q, k, nprobe)); it is frozen after warmup.
* **Fleet protocol** (serving/fleet.py): the single lookup worker
  exposes the heartbeat/lifecycle surface (`fleet_workers`,
  `fleet_reap`, `fleet_respawn`, `fleet_snapshot`) so a
  FleetSupervisor can reap a wedged worker and respawn it over the same
  tables.
* **Telemetry**: every lookup runs under a `gather` or `ann_probe` span
  with the bytes it moves, and each completed request emits a `request`
  event — the stream the /metrics histograms are fed from.

The HTTP routes live in serving/server.py (`POST /embed`,
`POST /search`), gated on `submit_embed` / `submit_search`.
"""

from __future__ import annotations

import queue
import threading
import time

import numpy as np

import torch

from deeplearning4j_tpu_torch import resolve_device
from deeplearning4j_tpu_torch.embedding.ann import DeviceANNIndex
from deeplearning4j_tpu_torch.serving.buckets import BucketLattice

_DEFAULT_NPROBE_LADDER = (4, 8, 16, 32, 64)


class EmbedRequest:
    """One admitted /embed or /search request: the caller waits on
    `done`; the worker fills `result` (or `error`) and stamps timing."""

    def __init__(self, kind: str, request_id=None):
        self.kind = kind
        self.request_id = request_id or f"{kind}-{id(self):x}"
        self.ids = None          # embed: [n] int ids
        self.queries = None      # search: [q, d] vectors
        self.k = None
        self.result = None
        self.error = None
        self.t_enqueue = 0.0
        self.t_done = 0.0
        self._done = threading.Event()

    def wait(self, timeout: float | None = None) -> bool:
        return self._done.wait(timeout)

    def finish(self, result=None, error=None, now=None) -> None:
        self.result = result
        self.error = error
        self.t_done = time.monotonic() if now is None else now
        self._done.set()


class _LookupWorker:
    """The single lookup thread, speaking the fleet heartbeat/lifecycle
    protocol so a FleetSupervisor can watch it. Respawn restarts the
    thread over the SAME engine (its tables and index stay)."""

    def __init__(self, engine, index: int = 0):
        self.engine = engine
        self.index = index
        self.alive = False
        self.lifecycle = "warming"
        self.last_beat = time.monotonic()
        self.current_batch = None   # the in-flight request, for reap
        # served/failed are written by the worker thread and read from
        # describe()/stats() on the caller thread — one dedicated lock
        # guards every access (the PagePool counter idiom)
        self._lock = threading.Lock()
        self.served = 0
        self.failed = 0
        self._thread: threading.Thread | None = None

    def start(self) -> None:
        self.alive = True
        self.lifecycle = "serving"
        self.last_beat = time.monotonic()
        self._thread = threading.Thread(
            target=self._run, daemon=True,
            name=f"embed-lookup-{self.index}")
        self._thread.start()

    def join(self, timeout=None) -> None:
        if self._thread is not None:
            self._thread.join(timeout)

    def describe(self, now: float) -> dict:
        with self._lock:
            served, failed = self.served, self.failed
        return {
            "index": self.index,
            "state": self.lifecycle,
            "alive": self.alive,
            "served": served,
            "failed": failed,
            "last_beat_age_s": round(now - self.last_beat, 4),
        }

    def _run(self) -> None:
        q = self.engine._queue
        while True:
            req = q.get()
            self.last_beat = time.monotonic()
            if req is None:           # drain sentinel
                self.lifecycle = "draining"
                self.alive = False
                return
            self.current_batch = req
            try:
                result = self.engine._process(req)
                with self._lock:
                    self.served += 1
                req.finish(result=result)
                ok, err = True, None
            except Exception as exc:  # noqa: BLE001 — fail loudly per req
                with self._lock:
                    self.failed += 1
                err = f"{type(exc).__name__}: {exc}"
                req.finish(error=err)
                ok = False
            finally:
                self.current_batch = None
                self.last_beat = time.monotonic()
            self.engine.recorder.event(
                "request", ok=ok, kind=req.kind, id=req.request_id,
                total_s=round(req.t_done - req.t_enqueue, 6),
                **({"error": err} if err else {}))


class EmbeddingServingEngine:
    """Serves `/embed` (id -> vector) and `/search` (vector -> ANN
    top-k) over a trained embedding table.

    `source` is an EngineLookupView (the trained ShardedEmbeddingEngine
    — lookups then read `engine.embed`, the live table on the engine's
    device) or a plain [V, D] vector array (a published snapshot, copied
    to `device`, CUDA unless named). The ANN index is built at
    construction unless one is passed in; `start()` calibrates nprobe
    against the recall floor BEFORE warmup, then warms every
    (bucket, k) search shape and every embed bucket under `compile`
    spans. After warmup the shape counter is frozen —
    `stats()["trace_count"]` growing mid-traffic is a shape the warmup
    missed, the same red flag the other engines pin."""

    def __init__(self, source, *, index: DeviceANNIndex | None = None,
                 lattice: BucketLattice | None = None,
                 n_partitions: int = 64, k_grid=(10,),
                 nprobe: int | None = None, recall_floor: float = 0.95,
                 calibration_queries: int = 64, seed: int = 0,
                 recorder=None, device=None):
        if recorder is None:
            from deeplearning4j_tpu_torch.telemetry import (NullRecorder,
                                                            Recorder,
                                                            get_default)

            recorder = get_default()
            if isinstance(recorder, NullRecorder):
                # the null default would starve the server's /metrics
                # sink (its event() never fires sinks) — an in-memory
                # recorder keeps the embedding series live out of the
                # box without forcing a telemetry file on the process
                recorder = Recorder(path=None)
        self.recorder = recorder
        self._view = source if hasattr(source, "vectors") else None
        vectors = np.asarray(
            source.vectors() if self._view is not None else source,
            np.float32)
        if vectors.ndim != 2:
            raise ValueError(f"need [V, D] vectors, got {vectors.shape}")
        self.vocab_size, self.dim = vectors.shape
        self._vectors = vectors
        self.device = (self._view.engine.device if self._view is not None
                       else resolve_device(device))
        self.index = index if index is not None else DeviceANNIndex.build(
            vectors, n_partitions=n_partitions, seed=seed,
            recorder=recorder, device=self.device)
        self.lattice = lattice or BucketLattice(batch_sizes=(1, 4, 16, 64))
        self.k_grid = tuple(sorted({int(k) for k in k_grid}))
        self.recall_floor = float(recall_floor)
        self.nprobe = int(nprobe) if nprobe is not None else None
        self._calibration_queries = int(calibration_queries)
        self._seed = seed
        self._queue: queue.Queue = queue.Queue()
        self._worker = _LookupWorker(self)
        self._draining = False
        self._started = False
        self._embed_table = None    # lazy device copy for snapshot mode
        self._embed_seen = set()    # embed bucket sizes seen
        self.warmup_s = 0.0
        self.calibrated_recall = None

    # ------------------------------------------------------------ lookup
    def _embed_rows(self, ids: np.ndarray):
        """Fixed-shape id -> vector gather under a `gather` span (the
        bytes are the rows read plus their int32 ids). Engine-backed
        sources read the engine's live table through `engine.embed`;
        snapshot sources a device-resident copy."""
        n = int(ids.shape[0])
        self._embed_seen.add(n)
        with self.recorder.span("gather", rows=n, ep=1,
                                bytes=n * (self.dim * 4 + 4)):
            if self._view is not None:
                return self._view.engine.embed(ids)
            if self._embed_table is None:
                self._embed_table = torch.from_numpy(self._vectors).to(
                    self.device)
            return self._embed_table[torch.as_tensor(
                ids, dtype=torch.long, device=self.device)]

    def _process(self, req: EmbedRequest):
        if req.kind == "embed":
            n = int(req.ids.shape[0])
            bucket = self.lattice.batch_bucket(n)
            padded = np.zeros(bucket, np.int32)
            padded[:n] = req.ids
            rows = self._embed_rows(padded)[:n]
            return {"vectors": rows.float().cpu().numpy()}
        # search: pad the query batch up to its lattice bucket; padded
        # rows are zero vectors whose results are sliced away
        q = int(req.queries.shape[0])
        bucket = self.lattice.batch_bucket(q)
        padded = np.zeros((bucket, self.dim), np.float32)
        padded[:q] = req.queries
        ids, scores = self.index.search(padded, req.k, nprobe=self.nprobe)
        return {"ids": ids[:q].cpu().numpy(),
                "scores": scores[:q].cpu().numpy()}

    # --------------------------------------------------------- lifecycle
    def start(self) -> "EmbeddingServingEngine":
        """Calibrate (if no nprobe was pinned), then warm every lattice
        shape. Calibration and warmup run BEFORE the post-warmup shape
        count is snapshotted — the zero-retrace gate measures only shapes
        first seen in traffic."""
        if self._started:
            return self
        t0 = time.perf_counter()
        if self.nprobe is None:
            rng = np.random.default_rng(self._seed)
            sample = self._vectors[rng.choice(
                self.vocab_size,
                size=min(self._calibration_queries, self.vocab_size),
                replace=False)]
            k = max(self.k_grid)
            with self.recorder.span("compile", what="ann-calibrate"):
                self.nprobe, self.calibrated_recall = \
                    self.index.calibrate_nprobe(
                        self._vectors, sample, k,
                        floor=self.recall_floor,
                        ladder=_DEFAULT_NPROBE_LADDER)
        for b in self.lattice.batch_sizes:
            with self.recorder.span("compile", what="embed", bucket=b):
                self._embed_rows(np.zeros(b, np.int32))
            for k in self.k_grid:
                with self.recorder.span("compile", what="search",
                                        bucket=b, k=k):
                    self.index.search(np.zeros((b, self.dim), np.float32),
                                      k, nprobe=self.nprobe)
        self.warmup_s = round(time.perf_counter() - t0, 4)
        self._worker.start()
        self._started = True
        return self

    def drain(self, timeout: float = 30.0) -> None:
        """Refuse new requests, flush the queue, join the worker."""
        self._draining = True
        self._queue.put(None)
        self._worker.join(timeout)
        self.recorder.event("span", name="drain", ok=True, seconds=0.0,
                            served=self.served, failed=self.failed)

    # ------------------------------------------------------------ submit
    def _admit(self, req: EmbedRequest) -> EmbedRequest:
        if self._draining:
            raise RuntimeError("draining; not admitting requests")
        req.t_enqueue = time.monotonic()
        self._queue.put(req)
        return req

    def submit_embed(self, ids, request_id=None) -> EmbedRequest:
        """Admit an id-lookup request; returns an EmbedRequest the
        caller waits on. Rejects (ValueError — the client's 400) empty
        batches, out-of-range ids, and batches over the lattice max."""
        ids = np.asarray(ids, np.int64).reshape(-1)
        if ids.size == 0:
            raise ValueError("empty id list")
        if ids.size > self.lattice.max_batch:
            raise ValueError(
                f"{ids.size} ids exceed the lattice max batch "
                f"{self.lattice.max_batch}")
        if ids.min() < 0 or ids.max() >= self.vocab_size:
            raise ValueError(
                f"ids must be in [0, {self.vocab_size}); got "
                f"[{ids.min()}, {ids.max()}]")
        req = EmbedRequest("embed", request_id)
        req.ids = ids.astype(np.int32)
        return self._admit(req)

    def submit_search(self, queries, k: int | None = None,
                      request_id=None) -> EmbedRequest:
        """Admit an ANN top-k request over one or more query vectors.
        `k` must be on the warmed k-grid (a foreign k is a new shape)."""
        queries = np.asarray(queries, np.float32)
        if queries.ndim == 1:
            queries = queries[None, :]
        if queries.ndim != 2 or queries.shape[1] != self.dim:
            raise ValueError(
                f"queries must be [q, {self.dim}], got {queries.shape}")
        if queries.shape[0] > self.lattice.max_batch:
            raise ValueError(
                f"{queries.shape[0]} queries exceed the lattice max "
                f"batch {self.lattice.max_batch}")
        k = self.k_grid[0] if k is None else int(k)
        if k not in self.k_grid:
            raise ValueError(
                f"k={k} is not on the warmed k grid {self.k_grid}")
        req = EmbedRequest("search", request_id)
        req.queries = queries
        req.k = k
        return self._admit(req)

    # ----------------------------------------------------- fleet surface
    def fleet_workers(self):
        return [self._worker]

    def fleet_reap(self, worker, reason: str = "died") -> int:
        """Fail the in-flight request loudly; queued requests stay in
        the FIFO for the respawned worker."""
        worker.alive = False
        worker.lifecycle = "dead"
        req = worker.current_batch
        if req is not None:
            with worker._lock:
                worker.failed += 1
            req.finish(error=f"worker reaped ({reason})")
            worker.current_batch = None
            return 1
        return 0

    def fleet_respawn(self, worker) -> None:
        """Restart the lookup thread over the same engine — its tables
        and index stay, so respawn warms nothing."""
        worker.start()

    def fleet_snapshot(self) -> dict:
        return {
            "queue_depth": self._queue.qsize(),
            "n_replicas": 1,
            "n_serving": 1 if self._worker.lifecycle == "serving" else 0,
        }

    # -------------------------------------------------------------- stats
    @property
    def trace_count(self) -> int:
        return self.index.trace_count + len(self._embed_seen)

    @property
    def served(self) -> int:
        with self._worker._lock:
            return self._worker.served

    @property
    def failed(self) -> int:
        with self._worker._lock:
            return self._worker.failed

    def stats(self) -> dict:
        now = time.monotonic()
        out = {
            "replicas": 1,
            "served": self.served,
            "failed": self.failed,
            "queue_depth": self._queue.qsize(),
            "trace_count": self.trace_count,
            "lattice": self.lattice.describe(),
            "fleet": [self._worker.describe(now)],
            "ann": {
                "vocab_size": self.vocab_size,
                "dim": self.dim,
                "n_partitions": self.index.n_partitions,
                "capacity": self.index.capacity,
                "nprobe": self.nprobe,
                "k_grid": list(self.k_grid),
                "recall_floor": self.recall_floor,
                "calibrated_recall": self.calibrated_recall,
            },
            "warmup_s": self.warmup_s,
        }
        if self._view is not None:
            out["memory"] = {"table_bytes_per_device":
                             self._view.engine.table_bytes_per_device()}
        return out
