"""The serving engines (JAX counterpart deeplearning4j_tpu/serving/
engine.py): `InferenceEngine`, one forward per request over dynamic
batches, and `GenerationEngine`, autoregressive generation over a paged
KV cache.

**Predict.** The `Batcher` (serving/batcher.py) coalesces requests into
bucket-shaped batches; a dispatcher thread deals them round-robin over
the replicas. One `_Replica` is one worker thread calling the net's
inference forward (`net.inference_fn()`, nn/multilayer.py and
nn/graph.py) on its own queue of batches, so host-side assembly of the
next batch overlaps the current forward. Each batch goes to the card in
one copy and comes back in one (`rows = y.float().cpu().numpy()`: numpy
has no bf16, so a bf16 net's output widens to f32 there). The replicas
share the card's default stream, so that fetch also waits for their
kernels. A worker dying mid-batch fails THAT batch's requests (each
carries the error, the HTTP layer answers 500, an `error` event keeps
the traceback) and the replica serves the next batch.

**Generation.** Each admitted request holds a decode SLOT: its prompt
prefills the slot's cache row chunk by chunk, interleaved with the
running decode batch so a long prompt never stalls the other slots'
tokens; then every decode step extends all active slots by one greedy
token. N generated tokens cost a prefill plus N single-token steps.
Page accounting, and exhaustion that queues instead of crashing, live
in serving/kvcache.py. `GenerationEngine` takes `replicas` (workers on
the one card, each with its own cache, page pool, slot machine and
thread), `speculative_k` (0, or >= 2: a fixed-shape verify step over
[n_slots, k] windows of the true last token and k-1 host-side n-gram
drafts, serving/speculative.py) and `kv_dtype` ("f32" | "int8").

**Shapes.** PyTorch has no jit to count, so `trace_count` counts the
first time each shape (a predict bucket, a prefill bucket, the decode
or verify step) reaches a worker: warmup runs every shape the traffic
can give, so after it the count is frozen, as the JAX contract says, and
the first sight runs under a `compile` span. Both engines record to
`recorder` (default `telemetry.get_default()`) with the JAX package's
span, event and field names.

**Fleet.** Every worker reads its params through the engine's
`WeightStore` (serving/fleet.py) exactly once per batch or step, so a
hot-swap flip lands between batches and each predict `request` event
names its `weight_gen`. `checkpoint` restores the net before warmup
(util/checkpoint.py); `faults` takes replica-scoped chaos specs
(distributed/faults.py); workers carry a lifecycle (warming -> serving
-> draining / dead -> retired) and a heartbeat, and the `fleet_*`
methods, `add_replica` and `retire_replica` are what
`fleet.FleetSupervisor` drives. The memory sampler and the cost book
wait for the telemetry slice (ROADMAP Queue A item A9):
`stats()["memory"]` is None and `peak_flops` 0.
"""

from __future__ import annotations

import queue
import threading
import time
import traceback
from collections import deque

import numpy as np
import torch

from deeplearning4j_tpu_torch.serving.batcher import (Batch, Batcher,
                                                      DecodeSlots, GenRequest,
                                                      _req_counter)
from deeplearning4j_tpu_torch.serving.buckets import Bucket, BucketLattice
from deeplearning4j_tpu_torch.serving.fleet import (ReplicaFaultInjector,
                                                    ReplicaKilled,
                                                    WeightStore,
                                                    restore_for_serving)
from deeplearning4j_tpu_torch.serving.kvcache import CachePlan
from deeplearning4j_tpu_torch.serving.speculative import (NgramProposer,
                                                          accept_greedy)


class QueueFullError(RuntimeError):
    """Generation admission refused: the page pool and the pending queue
    are both full — a graceful refusal (HTTP 503), never a crash."""


def _token_ids(probs: torch.Tensor) -> np.ndarray:
    """The argmax token ids of a step's output rows, fetched to the host:
    the step's one batch-boundary sync."""
    return probs.argmax(-1).to(torch.int32).cpu().numpy()


def _injector(faults, recorder):
    if faults is None or isinstance(faults, ReplicaFaultInjector):
        return faults
    return ReplicaFaultInjector(faults, recorder)


class _Replica:
    """One predict worker: its batch queue, its thread, its set of seen
    bucket shapes (the trace count). Params come from the engine's
    `WeightStore`, read once per batch. Lifecycle, heartbeat and the
    chaos injector are what `fleet.FleetSupervisor` supervises."""

    def __init__(self, index: int, net, recorder, weights: WeightStore,
                 faults: ReplicaFaultInjector | None = None):
        self.index = index
        self.net = net
        self.recorder = recorder
        self.weights = weights
        self.faults = faults
        self.queue: queue.Queue = queue.Queue()
        # guards the counters: updated on the worker thread, read by
        # describe()/stats() on the control plane
        self._mu = threading.Lock()
        self.trace_count = 0
        self.served = 0
        self.failed = 0
        self.batches_run = 0
        self.alive = True
        self.lifecycle = "warming"
        self.last_beat = 0.0
        self.current_batch: Batch | None = None
        self._seen_shapes: set = set()
        self._fwd = net.inference_fn()
        self._thread: threading.Thread | None = None

    # ----------------------------------------------------------- forward
    @staticmethod
    def _shape_key(feats: np.ndarray, mask) -> tuple:
        return (feats.shape, str(feats.dtype), mask is not None)

    def _first_sight(self, key) -> bool:
        """Whether bucket shape `key` runs for the first time on this
        replica; the first sight bumps the trace count."""
        if key in self._seen_shapes:
            return False
        self._seen_shapes.add(key)
        with self._mu:
            self.trace_count += 1
        return True

    def forward(self, ws, features: np.ndarray, mask) -> np.ndarray:
        """One padded batch through the net: one copy to the card, the
        forward, one fetch of the output rows (f32) to the host."""
        dev = self.net.device
        x = torch.as_tensor(features, device=dev)
        m = None if mask is None else torch.as_tensor(mask, device=dev)
        y = self._fwd(ws.params, ws.state, x, m)
        return y.float().cpu().numpy()  # the batch-boundary fetch

    def fail_batch(self, batch: Batch, exc_or_msg, *, clock,
                   weight_gen: int | None = None) -> None:
        """Fail every request of one batch loudly (worker death, reaped
        hang, drain with no live replica): each carries the error, and
        telemetry keeps the record."""
        with self._mu:
            self.failed += batch.n_real
        if isinstance(exc_or_msg, BaseException):
            self.recorder.error(f"replica:{self.index}", exc=exc_or_msg)
            err = "".join(traceback.format_exception_only(
                type(exc_or_msg), exc_or_msg)).strip()
        else:
            err = str(exc_or_msg)
            self.recorder.error(f"replica:{self.index}", error=err)
        t_done = clock()
        for r in batch.requests:
            r.error = err
            r.t_done = t_done
            self._request_event(r, batch, None, ok=False, error=err,
                                weight_gen=weight_gen)
            r.done.set()

    def run_batch(self, batch: Batch, *, clock, sequence: bool) -> None:
        # the correlation handoff: this batch's trace was rooted by the
        # batcher on the dispatcher thread; everything this thread emits
        # for it joins that tree (warmup batches carry no trace)
        with self.recorder.trace(batch.trace_id,
                                 parent_id=batch.parent_span):
            self._run_batch(batch, clock=clock, sequence=sequence)

    def _run_batch(self, batch: Batch, *, clock, sequence: bool) -> None:
        rec = self.recorder
        self.current_batch = batch
        self.last_beat = clock()
        with self._mu:
            self.batches_run += 1
        # the ONE read of the published weight set this batch serves
        # against; holding `ws` keeps a swapped-out set alive until the
        # batch is done
        ws = self.weights.current
        t0 = time.perf_counter()
        try:
            with rec.span("forward", bucket=list(batch.bucket.key()),
                          replica=self.index, n_real=batch.n_real):
                if self.faults is not None:
                    self.faults.check(self.index, "batch",
                                      self.batches_run)
                if self._first_sight(self._shape_key(batch.features,
                                                     batch.mask)):
                    with rec.span("compile",
                                  bucket=list(batch.bucket.key()),
                                  replica=self.index):
                        rows = self.forward(ws, batch.features, batch.mask)
                else:
                    rows = self.forward(ws, batch.features, batch.mask)
        except ReplicaKilled as exc:
            # injected death: the in-flight batch fails (the bounded
            # failure set) and the thread ends; the supervisor requeues
            # this replica's queue and respawns it. Death is marked
            # BEFORE the requests complete, so a waiter that saw the
            # failure also sees the dead replica.
            self.current_batch = None
            self.alive = False
            self.lifecycle = "dead"
            self.fail_batch(batch, exc, clock=clock,
                            weight_gen=ws.generation)
            raise
        except Exception as exc:  # a worker dying mid-batch: contain it
            self.fail_batch(batch, exc, clock=clock,
                            weight_gen=ws.generation)
            self.current_batch = None
            return
        forward_s = time.perf_counter() - t0
        t_done = clock()
        for i, r in enumerate(batch.requests):
            out = rows[i]
            if sequence:
                out = out[:r.length]  # drop the time padding
            r.result = out
            r.t_done = t_done
            with self._mu:
                self.served += 1
            self._request_event(r, batch, forward_s, ok=True,
                                weight_gen=ws.generation)
            r.done.set()
        self.current_batch = None
        self.last_beat = clock()

    def _request_event(self, r, batch: Batch, forward_s, *, ok,
                       error: str | None = None,
                       weight_gen: int | None = None) -> None:
        """The per-request record — the only source the traffic replay
        reads latency from (serving/replay.py `reconstruct`)."""
        fields = dict(
            ok=ok, bucket=list(batch.bucket.key()),
            replica=self.index, n_real=batch.n_real,
            queue_s=round(r.t_assembled - r.t_enqueue, 6),
            batch_assemble_s=round(batch.assemble_seconds, 6),
            total_s=round(r.t_done - r.t_enqueue, 6))
        fields["weight_gen"] = (self.weights.generation if weight_gen is None
                                else weight_gen)
        if forward_s is not None:
            fields["forward_s"] = round(forward_s, 6)
        if batch.bucket.seq is not None:
            fields["seq_len"] = r.length
            fields["padded_seq"] = batch.bucket.seq
        if error:
            fields["error"] = error
        self.recorder.request(r.request_id, **fields)

    # ---------------------------------------------------------- lifecycle
    def start(self, clock, sequence: bool) -> None:
        self.last_beat = clock()

        def loop():
            while True:
                batch = self.queue.get()
                if batch is None:
                    if self.lifecycle != "dead":
                        self.lifecycle = "retired"
                    return
                try:
                    self.run_batch(batch, clock=clock, sequence=sequence)
                except ReplicaKilled:
                    return  # dead: the supervisor requeues and respawns

        self.lifecycle = "serving"
        self._thread = threading.Thread(target=loop, daemon=True,
                                        name=f"serve-replica-{self.index}")
        self._thread.start()

    def join(self, timeout: float | None = None) -> None:
        if self._thread is not None:
            self._thread.join(timeout)

    def describe(self, now: float | None = None) -> dict:
        """One /healthz row: lifecycle, counters, heartbeat age."""
        with self._mu:
            out = {"index": self.index, "state": self.lifecycle,
                   "alive": self.alive, "served": self.served,
                   "failed": self.failed,
                   "batches_run": self.batches_run}
        if now is not None:
            out["last_beat_age_s"] = round(max(0.0, now - self.last_beat),
                                           3)
        return out


class InferenceEngine:
    """The predict serving core: the Batcher in front, round-robin
    replicas behind.

    `net` (a MultiLayerNetwork or a single-input, single-output
    ComputationGraph) is shared by every replica; its params are read
    through the `WeightStore`. `sequence=True` pads the first feature
    axis to the lattice's seq buckets with a [B, T] key mask.
    `checkpoint` restores the net from a checkpoint directory before
    anything runs."""

    def __init__(self, net, lattice: BucketLattice | None = None, *,
                 replicas: int = 1, max_wait_ms: float = 5.0,
                 sequence: bool = False, checkpoint: str | None = None,
                 faults=None, recorder=None):
        if recorder is None:
            from deeplearning4j_tpu_torch.telemetry import get_default

            recorder = get_default()
        self.recorder = recorder
        self.sequence = sequence
        if net.params is None:
            net.init()
        self.restored_step = 0
        if checkpoint is not None:
            self.restored_step = restore_for_serving(net, checkpoint)
        self.net = net
        # the double-buffered published weight set every replica reads;
        # a hot-swap (serving/fleet.hot_swap) flips it
        self.weights = WeightStore(net.params, net.state,
                                   step=self.restored_step)
        self.peak_flops = 0.0  # set by the telemetry slice's cost book
        self.lattice = lattice or BucketLattice()
        self.batcher = Batcher(self.lattice, max_wait_ms,
                               sequence=sequence, recorder=recorder)
        self._clock = self.batcher._clock
        self._faults = _injector(faults, recorder)
        self._rcv = threading.Condition()
        self._next_index = 0
        self._replicas = [self._new_replica()
                          for _ in range(max(1, int(replicas)))]
        self._rr = 0
        self._dispatcher: threading.Thread | None = None
        self._started = False
        self._draining = False
        self._feature_template: np.ndarray | None = None
        recorder.meta(role="serving-engine", replicas=len(self._replicas),
                      sequence=sequence, lattice=self.lattice.describe(),
                      restored_step=self.restored_step)

    def _new_replica(self) -> _Replica:
        r = _Replica(self._next_index, self.net, self.recorder,
                     self.weights, faults=self._faults)
        self._next_index += 1
        return r

    # ------------------------------------------------------------- warmup
    def warmup(self, example_features) -> int:
        """Run every lattice bucket on every replica once, BEFORE
        traffic. `example_features` is one request-shaped array (its
        trailing dims and dtype define the bucket shapes). Returns the
        number of (replica, bucket) first sights; after this the trace
        count and the compile-span count are frozen."""
        self._feature_template = np.asarray(example_features)
        return sum(self._warm_replica(r) for r in self._replicas)

    def _warm_replica(self, replica: _Replica) -> int:
        """Run every lattice bucket this replica has not yet seen
        (warmup, add_replica and the supervisor's respawn all come here;
        a respawn sees nothing new)."""
        ex = self._feature_template
        if ex is None:
            return 0
        if replica.lifecycle != "serving":
            replica.lifecycle = "warming"
        tail = ex.shape[1:] if self.sequence else ex.shape
        ws = self.weights.current
        compiles = 0
        for bucket in self.lattice.shapes():
            feats, mask = self._zeros_for(bucket, tail, ex.dtype)
            if not replica._first_sight(replica._shape_key(feats, mask)):
                continue
            with self.recorder.span("compile", bucket=list(bucket.key()),
                                    replica=replica.index, warmup=True):
                replica.forward(ws, feats, mask)
            compiles += 1
        return compiles

    def _zeros_for(self, bucket: Bucket, tail: tuple, dtype):
        if self.sequence:
            feats = np.zeros((bucket.batch, bucket.seq) + tail, dtype)
            mask = np.ones((bucket.batch, bucket.seq), np.float32)
            return feats, mask
        return np.zeros((bucket.batch,) + tail, dtype), None

    # ------------------------------------------------------------ serving
    def start(self) -> "InferenceEngine":
        if self._started:
            return self
        self._started = True
        for r in self._replicas:
            r.start(self._clock, self.sequence)

        def dispatch():
            while True:
                batch = self.batcher.next_batch()
                if batch is None:
                    break  # draining and empty
                if not self._dispatch_batch(batch):
                    # draining with no live replica left
                    self._replicas[0].fail_batch(
                        batch, "no live replica during drain",
                        clock=self._clock)
            with self._rcv:
                targets = list(self._replicas)
            for r in targets:
                r.queue.put(None)

        self._dispatcher = threading.Thread(target=dispatch, daemon=True,
                                            name="serve-dispatch")
        self._dispatcher.start()
        return self

    def _dispatch_batch(self, batch: Batch) -> bool:
        """Round-robin one batch over LIVE serving replicas only. The
        pick AND the queue put happen under the replica lock, so a
        concurrent retire's drain sentinel can never slip between them.
        Waits (notified by respawn/add) while no replica can serve;
        returns False only when draining with none coming back."""
        with self._rcv:
            while True:
                serving = [r for r in self._replicas
                           if r.alive and r.lifecycle == "serving"]
                if serving:
                    replica = serving[self._rr % len(serving)]
                    self._rr += 1
                    replica.queue.put(batch)
                    return True
                if self._draining:
                    return False
                self._rcv.wait(timeout=0.05)

    def submit(self, features, mask=None, request_id=None):
        features = np.asarray(features)
        if self._feature_template is not None:
            # the lattice fixes dtype as well as shape: a JSON round trip
            # arrives float64/int64, so cast to the warmup template's
            features = features.astype(self._feature_template.dtype,
                                       copy=False)
        return self.batcher.submit(features, mask=mask,
                                   request_id=request_id)

    def predict(self, features, mask=None, timeout: float = 30.0):
        """Synchronous convenience: submit + wait. Raises on a failed
        batch or a timeout."""
        req = self.submit(features, mask=mask)
        if not req.wait(timeout):
            raise TimeoutError(f"request {req.request_id} timed out "
                               f"after {timeout}s")
        if req.error is not None:
            raise RuntimeError(f"request {req.request_id} failed: "
                               f"{req.error}")
        return req.result

    # ---------------------------------------------------- fleet lifecycle
    def fleet_workers(self) -> list:
        with self._rcv:
            return list(self._replicas)

    def fleet_snapshot(self) -> dict:
        """The autoscale loop's engine-side signals."""
        with self._rcv:
            n_serving = sum(1 for r in self._replicas
                            if r.alive and r.lifecycle == "serving")
            n_replicas = sum(1 for r in self._replicas
                             if r.alive and r.lifecycle
                             in ("warming", "serving"))
        return {"queue_depth": self.batcher.depth,
                "n_serving": n_serving, "n_replicas": n_replicas}

    def fleet_reap(self, replica: _Replica, reason: str = "died") -> int:
        """Take a dead or hung replica out of dispatch: fail its
        in-flight batch (a wedged thread can never finish it; the kill
        path already failed its own), then drain its QUEUED batches back
        to the batcher's FIFO head. Returns the requeued request count."""
        with self._rcv:
            replica.alive = False
            replica.lifecycle = "dead"
        inflight = replica.current_batch
        if inflight is not None:
            replica.current_batch = None
            replica.fail_batch(inflight, f"replica {replica.index} "
                                         f"reaped ({reason})",
                               clock=self._clock)
        requeued = []
        while True:
            try:
                b = replica.queue.get_nowait()
            except queue.Empty:
                break
            if b is not None:
                requeued.extend(b.requests)
        if requeued:
            self.batcher.requeue(requeued)
        return len(requeued)

    def fleet_respawn(self, replica: _Replica) -> _Replica:
        """Bring a reaped replica back: a fresh queue and thread, warmup
        re-run before re-admission (no new shape: the trace count stays
        frozen), then back into dispatch."""
        replica.queue = queue.Queue()
        replica.batches_run = 0
        replica.current_batch = None
        replica.alive = True
        replica.lifecycle = "warming"
        self._warm_replica(replica)
        replica.start(self._clock, self.sequence)
        with self._rcv:
            self._rcv.notify_all()
        return replica

    def add_replica(self) -> _Replica:
        """Scale UP one replica: build, warm every lattice bucket (the
        compiles are warmup-flagged), start, admit to dispatch."""
        with self._rcv:
            replica = self._new_replica()
            self._replicas.append(replica)
        self._warm_replica(replica)
        if self._started:
            replica.start(self._clock, self.sequence)
        with self._rcv:
            self._rcv.notify_all()
        return replica

    def retire_replica(self) -> _Replica | None:
        """Scale DOWN one replica, gracefully: the newest serving
        replica stops receiving batches (`draining`), finishes what is
        already queued, and its thread ends. The last live replica is
        never retired."""
        with self._rcv:
            serving = [r for r in self._replicas
                       if r.alive and r.lifecycle == "serving"]
            if len(serving) <= 1:
                return None
            replica = serving[-1]
            replica.lifecycle = "draining"
            # the sentinel lands under the lock the dispatcher picks and
            # puts under: no batch can follow it into the queue
            replica.queue.put(None)
        return replica

    # -------------------------------------------------------------- drain
    def drain(self, timeout: float = 30.0) -> None:
        """Graceful shutdown: refuse new requests, flush every pending
        batch through the replicas, join the threads. Every admitted
        request completes (or fails loudly) before this returns."""
        self._draining = True
        with self._rcv:
            self._rcv.notify_all()
        self.batcher.close()
        if self._dispatcher is not None:
            self._dispatcher.join(timeout)
        for r in self.fleet_workers():
            if r.lifecycle == "dead":
                continue  # a wedged thread never joins; it is a daemon
            r.join(timeout)
        self.recorder.event("span", name="drain", ok=True, seconds=0.0,
                            served=self.served, failed=self.failed)

    # -------------------------------------------------------------- stats
    @property
    def trace_count(self) -> int:
        return sum(r.trace_count for r in self.fleet_workers())

    @property
    def served(self) -> int:
        return sum(r.served for r in self.fleet_workers())

    @property
    def failed(self) -> int:
        return sum(r.failed for r in self.fleet_workers())

    def stats(self) -> dict:
        now = self._clock()
        fleet = [r.describe(now) for r in self.fleet_workers()]
        return {
            "replicas": len(fleet),
            "served": self.served,
            "failed": self.failed,
            "queue_depth": self.batcher.depth,
            "trace_count": self.trace_count,
            "restored_step": self.restored_step,
            "lattice": self.lattice.describe(),
            "sequence": self.sequence,
            "fleet": fleet,
            "weights": self.weights.describe(),
            "memory": None,
            "peak_flops": self.peak_flops,
        }


# --------------------------------------------------------------- generation

class _GenWorker:
    """One generation replica: its KV-cache allocation, page pool,
    decode-slot state machine, step functions and thread.

    The loop interleaves chunked prefills into the running decode batch:
    each iteration admits what the pool allows, runs at most ONE prompt
    chunk, then one decode (or verify) step over all slots. The step's
    shape is fixed — [n_slots] tokens (or [n_slots, k] windows) against
    the [n_slots, capacity] cache; inactive rows decode a dummy token
    whose K/V write goes to the scratch position (capacity - 1), which
    any real tenant overwrites before it can be attended."""

    def __init__(self, index: int, net, lattice: BucketLattice,
                 plan: CachePlan, prefill_chunk: int, max_queue: int,
                 recorder, weights: WeightStore, speculative_k: int = 0,
                 faults: ReplicaFaultInjector | None = None):
        self.index = index
        self.net = net
        self.lattice = lattice
        self.plan = plan
        self.prefill_chunk = prefill_chunk
        self.max_queue = max_queue
        self.recorder = recorder
        self.weights = weights
        self.faults = faults
        self.pool = plan.make_pool()
        self.slots = DecodeSlots(plan.n_slots)
        self.speculative_k = int(speculative_k)
        self.cache = net.init_kv_cache(plan.n_slots, plan.capacity,
                                       plan.kv_dtype, plan.page_size)
        # guards the counters (worker-thread updates vs stats() reads);
        # never held across a device call or a queue wait
        self._mu = threading.Lock()
        self.trace_count = 0
        self.served = 0
        self.failed = 0
        self.tokens_out = 0
        self.decode_steps_run = 0
        self.verify_steps_run = 0
        self.slot_steps = 0  # (active slot, verify step) pairs
        self.accepted_tokens = 0
        self.drafted_tokens = 0
        self.draft_overhead_s = 0.0
        self.proposer = NgramProposer()
        self.alive = True
        self.lifecycle = "warming"
        self.last_beat = 0.0
        self.current_batch = None  # the active slot rows mid-step
        self._seen_shapes: set = set()
        self.pending: deque[GenRequest] = deque()
        self._cv = threading.Condition()
        self._closed = False
        self._thread: threading.Thread | None = None
        self._prefill = net.prefill_fn(plan.kv_dtype, plan.page_size)
        self._decode = net.incremental_decode_fn(plan.kv_dtype,
                                                 plan.page_size)
        self._verify = (net.verify_decode_fn(plan.kv_dtype, plan.page_size)
                        if self.speculative_k >= 2 else None)

    # ------------------------------------------------------------ steps
    def _first_sight(self, key) -> bool:
        """Whether step shape `key` runs for the first time; the first
        sight bumps the trace count (the JAX package's trace-time bump)."""
        if key in self._seen_shapes:
            return False
        self._seen_shapes.add(key)
        with self._mu:
            self.trace_count += 1
        return True

    def _run_prefill(self, ws, tokens, kmask, rows, start, last_idx):
        probs, self.cache = self._prefill(ws.params, ws.state, self.cache,
                                          tokens, kmask, rows, start,
                                          last_idx)
        return _token_ids(probs)

    def _run_decode(self, ws, tokens, pos):
        probs, self.cache = self._decode(ws.params, ws.state, self.cache,
                                         tokens, pos)
        return _token_ids(probs)

    def _run_verify(self, ws, windows, pos):
        probs, self.cache = self._verify(ws.params, ws.state, self.cache,
                                         windows, pos)
        return _token_ids(probs)  # [B, k]: the acceptance mask's input

    # ---------------------------------------------------------- planning
    def chunk_buckets(self) -> list:
        """The prefill shapes this worker ever runs."""
        return self.lattice.prefill_buckets(self.prefill_chunk)

    def _next_chunk_len(self, remaining: int) -> int:
        """Bucket-shaped length of the next prompt chunk: full chunks
        while more than a chunk remains, the bucketed remainder last."""
        if remaining >= self.prefill_chunk:
            return self.prefill_chunk
        return self.lattice.seq_bucket(remaining)

    # ------------------------------------------------------------ warmup
    def warmup(self) -> int:
        """Run every prefill bucket and the step this worker uses (decode,
        or verify in speculative mode) once before traffic — an all-zero
        key mask into row 0, dummy tokens into the scratch position — so
        the kernels are built and loaded and the trace count is frozen.
        Returns the number of shapes run."""
        ws = self.weights.current
        rows = np.zeros(1, np.int64)
        compiles = 0
        for Tb in self.chunk_buckets():
            if not self._first_sight(("prefill", Tb)):
                continue
            with self.recorder.span("compile", kind="prefill",
                                    bucket=[1, Tb], replica=self.index,
                                    warmup=True):
                self._run_prefill(ws, np.zeros((1, Tb), np.int64),
                                  np.zeros((1, Tb), np.float32), rows, rows,
                                  np.asarray([Tb - 1]))
            compiles += 1
        B = self.plan.n_slots
        scratch = np.full(B, self.plan.capacity - 1, np.int64)
        if self._verify is not None:
            if self._first_sight("verify"):
                K = self.speculative_k
                with self.recorder.span("compile", kind="verify",
                                        shape=[B, K, self.plan.capacity],
                                        replica=self.index, warmup=True):
                    self._run_verify(ws, np.zeros((B, K), np.int64), scratch)
                compiles += 1
        elif self._first_sight("decode"):
            with self.recorder.span("compile", kind="decode",
                                    shape=[B, self.plan.capacity],
                                    replica=self.index, warmup=True):
                self._run_decode(ws, np.zeros(B, np.int64), scratch)
            compiles += 1
        return compiles

    # --------------------------------------------------------- admission
    def submit(self, req: GenRequest) -> None:
        pages = self.plan.request_pages(
            self.lattice.seq_bucket(req.prompt_len), req.max_new_tokens)
        if pages > self.pool.n_pages:
            raise ValueError(
                f"request needs {pages} cache pages but the replica pool "
                f"holds {self.pool.n_pages} — prompt + max_new_tokens "
                "exceed the cache geometry")
        with self._cv:
            if self._closed:
                raise RuntimeError("engine is draining; request refused")
            if len(self.pending) >= self.max_queue:
                raise QueueFullError(
                    "generation queue full (page pool saturated and "
                    f"{self.max_queue} requests already waiting) — "
                    "retry later")
            self.pending.append(req)
            self._cv.notify_all()

    def _admit(self, clock) -> None:
        with self._cv:
            while self.pending:
                idx = self.slots.free_index()
                if idx is None:
                    return
                req = self.pending[0]
                pages = self.plan.request_pages(
                    self.lattice.seq_bucket(req.prompt_len),
                    req.max_new_tokens)
                if not self.pool.try_reserve(pages):
                    return  # pool exhausted: stays queued, not dropped
                self.pending.popleft()
                req.t_admitted = clock()
                self.slots.admit(idx, req, pages)
                self.recorder.event("page_pool", replica=self.index,
                                    **self.pool.describe())

    # ----------------------------------------------------------- compute
    def _prefill_chunk(self, slot_idx: int, clock) -> None:
        """One bucket-shaped prompt chunk for one slot, under the
        request's trace context: its spans and events correlate to the
        request id the final `request` event carries."""
        req = self.slots.slots[slot_idx].request
        with self.recorder.trace(req.request_id):
            self._prefill_chunk_inner(slot_idx, clock)

    def _prefill_chunk_inner(self, slot_idx: int, clock) -> None:
        """The chunk itself. The only host fetch is the next-token id."""
        slot = self.slots.slots[slot_idx]
        req = slot.request
        L = req.prompt_len
        Tc = self._next_chunk_len(L - slot.start)
        n_real = min(Tc, L - slot.start)
        padded_tokens = np.zeros((1, Tc), np.int64)
        padded_tokens[0, :n_real] = req.tokens[slot.start:slot.start
                                               + n_real]
        bucket_kmask = np.zeros((1, Tc), np.float32)
        bucket_kmask[0, :n_real] = 1.0
        final = slot.start + n_real >= L
        ws = self.weights.current
        args = (ws, padded_tokens, bucket_kmask, np.asarray([slot_idx]),
                np.asarray([slot.start]), np.asarray([n_real - 1]))
        try:
            with self.recorder.span("prefill_chunk", bucket=[1, Tc],
                                    start=slot.start, replica=self.index,
                                    final=final):
                if self._first_sight(("prefill", Tc)):
                    with self.recorder.span("compile", kind="prefill",
                                            bucket=[1, Tc],
                                            replica=self.index):
                        toks = self._run_prefill(*args)
                else:
                    toks = self._run_prefill(*args)
        except Exception as exc:  # the request fails; the worker serves on
            self._fail_slot(slot_idx, exc, clock)
            return
        slot.start += n_real
        if final:
            # the prompt's last forward row IS the first generated token:
            # TTFT is this chunk's completion
            slot.pos = L
            slot.last_token = int(toks[0])
            req.emit(slot.last_token, clock())
            with self._mu:
                self.tokens_out += 1
            self._maybe_complete(slot_idx, clock)

    def _decode_batch_step(self, active: list, clock) -> None:
        """One fixed-shape decode step over every slot row; `active`
        names the rows whose outputs are real. One host fetch for the
        whole [n_slots] next-token vector."""
        B = self.plan.n_slots
        padded_tokens = np.zeros(B, np.int64)
        pos = np.full(B, self.plan.capacity - 1, np.int64)  # scratch
        for i in active:
            slot = self.slots.slots[i]
            padded_tokens[i] = slot.last_token
            pos[i] = slot.pos
        ws = self.weights.current
        with self._mu:
            self.decode_steps_run += 1
        self.current_batch = list(active)
        try:
            with self.recorder.span("decode_step", replica=self.index,
                                    n_active=len(active)):
                if self.faults is not None:
                    self.faults.check(self.index, "decode",
                                      self.decode_steps_run)
                if self._first_sight("decode"):
                    with self.recorder.span("compile", kind="decode",
                                            shape=[B, self.plan.capacity],
                                            replica=self.index):
                        toks = self._run_decode(ws, padded_tokens, pos)
                else:
                    toks = self._run_decode(ws, padded_tokens, pos)
        except ReplicaKilled as exc:
            self._die(active, exc, clock)
            raise
        except Exception as exc:  # the batch's requests fail; serve on
            for i in active:
                self._fail_slot(i, exc, clock)
            self.current_batch = None
            return
        self.current_batch = None
        now = clock()
        for i in active:
            slot = self.slots.slots[i]
            slot.pos += 1
            slot.last_token = int(toks[i])
            slot.request.emit(slot.last_token, now)
            with self._mu:
                self.tokens_out += 1
            self._maybe_complete(i, clock)

    def _speculative_batch_step(self, active: list, clock) -> None:
        """One fixed-shape VERIFY step over every slot row: each active
        row's window is [last_token, d_1..d_{k-1}] (host-side n-gram
        drafts); inactive rows ride the scratch position. One host fetch
        of the [n_slots, k] argmax matrix; the greedy acceptance mask then
        emits 1..k tokens per slot. The proposer's host time is metered
        (`draft_overhead_us`) and each step's `draft` event is what the
        replay's accepted_tokens_per_step reconstructs from."""
        B, K = self.plan.n_slots, self.speculative_k
        padded_windows = np.zeros((B, K), np.int64)
        pos = np.full(B, self.plan.capacity - 1, np.int64)  # scratch
        t_draft = time.perf_counter()
        drafts: dict = {}
        for i in active:
            slot = self.slots.slots[i]
            req = slot.request
            d = self.proposer.propose(
                list(req.tokens) + list(req.emitted), K - 1)
            drafts[i] = d
            padded_windows[i, 0] = slot.last_token
            padded_windows[i, 1:] = d
            pos[i] = slot.pos
        draft_s = time.perf_counter() - t_draft
        ws = self.weights.current
        with self._mu:
            self.decode_steps_run += 1
            self.verify_steps_run += 1
        self.current_batch = list(active)
        try:
            with self.recorder.span("verify_step", replica=self.index,
                                    n_active=len(active), k=K):
                if self.faults is not None:
                    self.faults.check(self.index, "decode",
                                      self.decode_steps_run)
                if self._first_sight("verify"):
                    with self.recorder.span(
                            "compile", kind="verify",
                            shape=[B, K, self.plan.capacity],
                            replica=self.index):
                        toks = self._run_verify(ws, padded_windows, pos)
                else:
                    toks = self._run_verify(ws, padded_windows, pos)
        except ReplicaKilled as exc:
            self._die(active, exc, clock)
            raise
        except Exception as exc:
            for i in active:
                self._fail_slot(i, exc, clock)
            self.current_batch = None
            return
        self.current_batch = None
        now = clock()
        step_emitted = 0
        step_accepted = 0
        for i in active:
            slot = self.slots.slots[i]
            req = slot.request
            budget = req.max_new_tokens - len(req.emitted)
            _n_acc, emitted = accept_greedy(drafts[i], toks[i])
            take = min(len(emitted), budget)
            for t in emitted[:take]:
                req.emit(int(t), now)
                with self._mu:
                    self.tokens_out += 1
            slot.pos += take
            slot.last_token = int(emitted[take - 1])
            step_emitted += take
            step_accepted += take - 1  # drafts accepted (bonus aside)
            self._maybe_complete(i, clock)
        with self._mu:
            self.accepted_tokens += step_emitted
            self.drafted_tokens += (K - 1) * len(active)
            self.slot_steps += len(active)
            self.draft_overhead_s += draft_s
        self.recorder.event("draft", replica=self.index, k=K,
                            n_active=len(active), emitted=step_emitted,
                            accepted=step_accepted,
                            drafted=(K - 1) * len(active),
                            overhead_us=round(draft_s * 1e6, 2))

    # -------------------------------------------------------- lifecycle
    def _die(self, active: list, exc: Exception, clock) -> None:
        """An injected mid-step death: every active slot fails (pages
        released) and the worker is marked dead BEFORE the requests
        complete, so a waiter that saw the failure also sees the dead
        worker. Pending requests stay queued for the respawned thread."""
        self.current_batch = None
        self.alive = False
        self.lifecycle = "dead"
        for i in active:
            self._fail_slot(i, exc, clock)

    def _maybe_complete(self, slot_idx: int, clock) -> None:
        req = self.slots.slots[slot_idx].request
        if len(req.emitted) < req.max_new_tokens:
            return
        self.pool.release(self.slots.release(slot_idx))
        self.recorder.event("page_pool", replica=self.index,
                            **self.pool.describe())
        req.finish(clock())
        with self._mu:
            self.served += 1
        self._request_event(req, ok=True)

    def _fail_slot(self, slot_idx: int, exc: Exception, clock) -> None:
        """The slot's request fails with the error, its pages are
        released, and the worker keeps serving."""
        req = self.slots.slots[slot_idx].request
        self.pool.release(self.slots.release(slot_idx))
        self.recorder.event("page_pool", replica=self.index,
                            **self.pool.describe())
        self.recorder.error(f"gen-replica:{self.index}", exc=exc)
        err = "".join(traceback.format_exception_only(type(exc),
                                                      exc)).strip()
        req.finish(clock(), error=err)
        with self._mu:
            self.failed += 1
        self._request_event(req, ok=False, error=err)

    def _request_event(self, req: GenRequest, *, ok,
                       error: str | None = None) -> None:
        fields = dict(
            ok=ok, kind="generate", replica=self.index,
            # the generation trace key: the prefill_chunk spans carry the
            # same id
            trace_id=req.request_id,
            prompt_len=req.prompt_len,
            prompt_bucket=self.lattice.seq_bucket(req.prompt_len),
            new_tokens=len(req.emitted),
            queue_s=round(req.t_admitted - req.t_enqueue, 6),
            total_s=round(req.t_done - req.t_enqueue, 6))
        if req.t_first_token:
            fields["ttft_s"] = round(req.t_first_token - req.t_enqueue, 6)
        if error:
            fields["error"] = error
        self.recorder.request(req.request_id, **fields)

    def start(self, clock) -> None:
        self.last_beat = clock()

        def loop():
            while True:
                self.last_beat = clock()
                self._admit(clock)
                progressed = False
                try:
                    pi = self.slots.next_prefill()
                    if pi is not None:
                        self._prefill_chunk(pi, clock)
                        progressed = True
                    active = self.slots.decoding()
                    if active:
                        if self._verify is not None:
                            self._speculative_batch_step(active, clock)
                        else:
                            self._decode_batch_step(active, clock)
                        progressed = True
                except ReplicaKilled:
                    return  # dead: the fleet supervisor respawns
                if progressed:
                    continue
                with self._cv:
                    if (self._closed and not self.pending
                            and not self.slots.busy()):
                        if self.lifecycle != "dead":
                            self.lifecycle = "retired"
                        return
                    if not self.pending or self.slots.free_index() is None:
                        self._cv.wait(timeout=0.05)

        self.lifecycle = "serving"
        self._thread = threading.Thread(target=loop, daemon=True,
                                        name=f"gen-replica-{self.index}")
        self._thread.start()

    def respawn(self, clock) -> None:
        """Fleet-supervisor respawn: a fresh thread over the same step
        functions and KV cache (warmup re-runs and sees no new shape),
        pending requests continuing from the worker's own queue."""
        self.alive = True
        self.lifecycle = "warming"
        self.current_batch = None
        with self._mu:
            self.decode_steps_run = 0
        self.warmup()
        self.start(clock)
        with self._cv:
            self._cv.notify_all()

    def reap(self, reason: str, clock) -> int:
        """Fail every occupied slot (pages released) — the hang case,
        where the wedged thread can never finish them. Pending requests
        stay queued for the respawned thread. Returns 0: nothing is
        re-dispatched elsewhere, the queue is this worker's."""
        self.alive = False
        self.lifecycle = "dead"
        self.current_batch = None
        exc = RuntimeError(f"gen replica {self.index} reaped ({reason})")
        for i, s in enumerate(self.slots.slots):
            if s is not None:
                self._fail_slot(i, exc, clock)
        return 0

    def close(self) -> None:
        with self._cv:
            self._closed = True
            self._cv.notify_all()

    def join(self, timeout: float | None = None) -> None:
        if self._thread is not None:
            self._thread.join(timeout)

    @property
    def depth(self) -> int:
        with self._cv:
            return len(self.pending)

    def describe(self, now: float | None = None) -> dict:
        with self._mu:
            out = {"index": self.index, "state": self.lifecycle,
                   "alive": self.alive, "served": self.served,
                   "failed": self.failed,
                   "decode_steps_run": self.decode_steps_run}
            if self.speculative_k >= 2:
                out["verify_steps_run"] = self.verify_steps_run
                out["accepted_tokens"] = self.accepted_tokens
                out["drafted_tokens"] = self.drafted_tokens
        if now is not None:
            out["last_beat_age_s"] = round(max(0.0, now - self.last_beat),
                                           3)
        return out


class GenerationEngine:
    """Autoregressive generation serving: prefill/decode split over a
    paged KV cache, continuous batching across decode slots, greedy
    decoding (optionally speculative, optionally over an int8 cache).

    `lattice` fixes the prompt-chunk shapes; `slots` is the decode batch
    of each replica; the cache holds `slots` rows of the largest prompt
    bucket plus `max_new_tokens`, quantized to `page_size`; `pool_pages`
    (default: the whole allocation) is the page budget admission
    reserves from; `prefill_chunk` (a lattice seq length, default the
    largest) is the longest prompt piece run between two decode steps;
    `replicas` workers share the card, each with its own cache;
    `checkpoint` restores the net first; `faults` takes replica-scoped
    chaos specs (`r0:kill@decode5`)."""

    def __init__(self, net, lattice: BucketLattice, *, slots: int = 4,
                 max_new_tokens: int = 16, page_size: int = 16,
                 pool_pages: int | None = None,
                 prefill_chunk: int | None = None, max_queue: int = 64,
                 replicas: int = 1, checkpoint: str | None = None,
                 speculative_k: int = 0, kv_dtype: str = "f32",
                 faults=None, recorder=None):
        if recorder is None:
            from deeplearning4j_tpu_torch.telemetry import get_default

            recorder = get_default()
        self.recorder = recorder
        if lattice.seq_lens is None:
            raise ValueError("generation needs a sequence lattice "
                             "(BucketLattice with seq_lens)")
        if net.params is None:
            net.init()
        self.restored_step = 0
        if checkpoint is not None:
            self.restored_step = restore_for_serving(net, checkpoint)
        self.net = net
        self.weights = WeightStore(net.params, net.state,
                                   step=self.restored_step)
        self._faults = _injector(faults, recorder)
        self.lattice = lattice
        chunk = (lattice.max_seq if prefill_chunk is None
                 else int(prefill_chunk))
        lattice.prefill_buckets(chunk)  # raises on a non-lattice chunk
        self.prefill_chunk = chunk
        self.speculative_k = int(speculative_k)
        if self.speculative_k == 1 or self.speculative_k < 0:
            raise ValueError(
                "speculative_k is 0 (off) or >= 2 (a window of the true "
                f"last token plus k-1 drafts); got {speculative_k}")
        if self.speculative_k > int(max_new_tokens):
            raise ValueError(
                f"speculative_k {speculative_k} exceeds max_new_tokens "
                f"{max_new_tokens} — a window can never be used whole")
        self.plan = CachePlan(lattice.max_seq, max_new_tokens,
                              max(1, int(slots)), page_size,
                              pool_pages=pool_pages, kv_dtype=kv_dtype)
        self._clock = time.monotonic
        self._workers = [
            _GenWorker(i, net, lattice, self.plan, chunk, max_queue,
                       recorder, self.weights,
                       speculative_k=self.speculative_k,
                       faults=self._faults)
            for i in range(max(1, int(replicas)))]
        # set by the telemetry slice (cost book, memory sampler)
        self.peak_flops = 0.0
        self._rr = 0
        self._rr_lock = threading.Lock()
        self._started = False
        recorder.meta(role="generation-engine",
                      replicas=len(self._workers),
                      lattice=lattice.describe(),
                      cache=self.plan.describe(),
                      prefill_chunk=chunk,
                      speculative_k=self.speculative_k,
                      restored_step=self.restored_step)

    # ------------------------------------------------------------- warmup
    def warmup(self) -> int:
        """Run every (replica, prefill bucket) and (replica, step) shape
        once; returns the count. After this the trace count is frozen."""
        return sum(w.warmup() for w in self._workers)

    # ------------------------------------------------------------ serving
    def start(self) -> "GenerationEngine":
        if self._started:
            return self
        self._started = True
        for w in self._workers:
            w.start(self._clock)
        return self

    def submit_generate(self, tokens, max_new_tokens: int | None = None,
                        request_id: str | None = None) -> GenRequest:
        """Admit one generation request. Validates the prompt against
        the lattice (a too-long prompt is the client's 400) and the
        output budget against the cache geometry; a saturated pool and
        full queue raise QueueFullError (HTTP 503)."""
        toks = np.asarray(tokens)
        if toks.ndim != 1:
            raise ValueError(
                f"generation takes a [T] token prompt; got {toks.shape}")
        self.lattice.seq_bucket(int(toks.shape[0]))  # raises if too long
        max_new = (self.plan.max_new_tokens if max_new_tokens is None
                   else int(max_new_tokens))
        if not 1 <= max_new <= self.plan.max_new_tokens:
            raise ValueError(
                f"max_new_tokens must be in [1, "
                f"{self.plan.max_new_tokens}]; got {max_new}")
        req = GenRequest(tokens=toks.astype(np.int64),
                         max_new_tokens=max_new,
                         request_id=request_id or f"g{next(_req_counter)}",
                         t_enqueue=self._clock())
        with self._rr_lock:  # HTTP handler threads submit concurrently
            worker = self._workers[self._rr % len(self._workers)]
            self._rr += 1
        worker.submit(req)
        return req

    def generate(self, tokens, max_new_tokens: int | None = None,
                 timeout: float = 60.0) -> list:
        """Synchronous convenience: submit + wait; returns the emitted
        token list. Raises on failure or timeout."""
        req = self.submit_generate(tokens, max_new_tokens)
        if not req.wait(timeout):
            raise TimeoutError(f"request {req.request_id} timed out "
                               f"after {timeout}s")
        if req.error is not None:
            raise RuntimeError(f"request {req.request_id} failed: "
                               f"{req.error}")
        return list(req.emitted)

    # ---------------------------------------------------- fleet lifecycle
    def fleet_workers(self) -> list:
        return list(self._workers)

    def fleet_snapshot(self) -> dict:
        n_serving = sum(1 for w in self._workers
                        if w.alive and w.lifecycle == "serving")
        return {"queue_depth": sum(w.depth for w in self._workers),
                "n_serving": n_serving, "n_replicas": n_serving}

    def fleet_reap(self, worker, reason: str = "died") -> int:
        return worker.reap(reason, self._clock)

    def fleet_respawn(self, worker) -> None:
        worker.respawn(self._clock)

    def drain(self, timeout: float = 30.0) -> None:
        """Refuse new requests, finish the admitted and queued ones, and
        stop the worker threads."""
        for w in self._workers:
            w.close()
        for w in self._workers:
            if w.lifecycle == "dead":
                continue  # a wedged daemon thread never joins
            w.join(timeout)
        self.recorder.event("span", name="drain", ok=True, seconds=0.0,
                            served=self.served, failed=self.failed)

    # -------------------------------------------------------------- stats
    @property
    def trace_count(self) -> int:
        return sum(w.trace_count for w in self._workers)

    @property
    def served(self) -> int:
        return sum(w.served for w in self._workers)

    @property
    def failed(self) -> int:
        return sum(w.failed for w in self._workers)

    def describe(self) -> dict:
        """The engine's configuration: replicas, lattice, cache plan,
        prefill chunk and speculation width."""
        return {"replicas": len(self._workers),
                "lattice": self.lattice.describe(),
                "cache": self.plan.describe(),
                "prefill_chunk": self.prefill_chunk,
                "speculative_k": self.speculative_k}

    def stats(self) -> dict:
        now = self._clock()
        return {
            "replicas": len(self._workers),
            "served": self.served,
            "failed": self.failed,
            "tokens_out": sum(w.tokens_out for w in self._workers),
            "queue_depth": sum(w.depth for w in self._workers),
            "trace_count": self.trace_count,
            "restored_step": self.restored_step,
            "lattice": self.lattice.describe(),
            "cache": self.plan.describe(),
            "page_pools": [w.pool.describe() for w in self._workers],
            "fleet": [w.describe(now) for w in self._workers],
            "weights": self.weights.describe(),
            "generate": True,
            "speculative": self._speculative_stats(),
            "memory": None,
            "peak_flops": self.peak_flops,
        }

    def _speculative_stats(self) -> dict:
        """Emitted tokens per verify step per active slot (the headline),
        the draft acceptance rate and the proposer's host overhead — off
        when speculative decoding is."""
        if self.speculative_k < 2:
            return {"enabled": False, "k": 0}
        steps = sum(w.verify_steps_run for w in self._workers)
        slot_steps = sum(w.slot_steps for w in self._workers)
        accepted = sum(w.accepted_tokens for w in self._workers)
        drafted = sum(w.drafted_tokens for w in self._workers)
        # tokens beyond the 1-per-slot-step a plain decode would emit
        bonus = accepted - slot_steps
        overhead = sum(w.draft_overhead_s for w in self._workers)
        return {
            "enabled": True, "k": self.speculative_k,
            "verify_steps": steps,
            "accepted_tokens_per_step": (round(accepted / slot_steps, 4)
                                         if slot_steps else 0.0),
            "draft_acceptance_rate": (round(bonus / drafted, 4)
                                      if drafted else 0.0),
            "draft_overhead_us_total": round(overhead * 1e6, 1),
        }
