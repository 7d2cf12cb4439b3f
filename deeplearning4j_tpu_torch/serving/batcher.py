"""Dynamic batching and the generation-side slot state (JAX counterpart
deeplearning4j_tpu/serving/batcher.py).

The predict half: single requests coalesce into bucket-shaped batches
under a max-wait deadline.

    submit() appends a PendingRequest to a FIFO ->
    the dispatcher blocks in next_batch() ->
      CUT a batch when the compatible FIFO prefix fills the largest
      batch bucket, OR when the OLDEST pending request has waited
      max_wait (latency bound beats batch efficiency), OR on drain
      (close() flushes leftovers) ->
    assemble() pads the group into its lattice bucket (zero padding +
    a validity mask) and hands a Batch to the engine.

`plan_batch` — the cut decision — is a pure function of (pending, now),
so the deadline and coalescing logic is tested on a fake clock with no
sleeps; `Batcher` wraps it in a condition variable for the live
threaded path. Assembly is host-side numpy: the card sees only the
padded bucket batch, copied once.

The generation half: `GenRequest`, `_Slot` and the `DecodeSlots` state
machine that `GenerationEngine`'s workers own.
"""

from __future__ import annotations

import itertools
import queue
import threading
import time
from collections import deque
from dataclasses import dataclass, field

import numpy as np

from deeplearning4j_tpu_torch.serving.buckets import Bucket, BucketLattice

_req_counter = itertools.count()


@dataclass
class PendingRequest:
    """One admitted predict request: the raw (unpadded) features, timing
    marks, and the completion event the front end blocks on."""

    features: np.ndarray
    mask: np.ndarray | None = None
    request_id: str = ""
    t_enqueue: float = 0.0
    # filled by the engine on completion
    t_assembled: float = 0.0
    t_done: float = 0.0
    result: np.ndarray | None = None
    error: str | None = None
    done: threading.Event = field(default_factory=threading.Event)

    def wait(self, timeout: float | None = None) -> bool:
        return self.done.wait(timeout)

    @property
    def length(self) -> int:
        """Time length for sequence requests (first axis)."""
        return int(self.features.shape[0])


@dataclass
class Batch:
    """One assembled bucket batch: padded arrays plus the requests whose
    rows they carry (row i of `features` is requests[i] for i < n_real;
    rows beyond are padding and are dropped after the forward)."""

    bucket: Bucket
    features: np.ndarray
    mask: np.ndarray | None
    requests: list
    t_cut: float = 0.0
    assemble_seconds: float = 0.0
    # correlation handoff (telemetry/recorder.py): the trace this batch
    # roots and the span the replica thread's `forward` parents to, so
    # the cut's queue -> batch_assemble chain and the replica's forward
    # and request events form one tree across the thread boundary
    trace_id: str | None = None
    parent_span: str | None = None

    @property
    def n_real(self) -> int:
        return len(self.requests)


def _compatible(a: PendingRequest, b: PendingRequest,
                sequence: bool) -> bool:
    """Whether two requests can share a batch: same dtype and same
    trailing feature dims (sequence models may differ in length — the
    first axis — which padding absorbs; fixed-shape models must match
    exactly)."""
    if a.features.dtype != b.features.dtype:
        return False
    if sequence:
        return a.features.shape[1:] == b.features.shape[1:]
    return a.features.shape == b.features.shape


def plan_batch(pending, now: float, max_wait_s: float,
               lattice: BucketLattice, *, sequence: bool = False,
               closed: bool = False) -> int:
    """The cut decision — how many requests to take off the head of the
    FIFO right now (0 = keep waiting). A pure function of its arguments.

    Cuts happen when (in priority order):
      1. the compatible FIFO prefix fills the LARGEST batch bucket
         (a full batch never waits);
      2. the oldest pending request has waited `max_wait_s`;
      3. the batcher is draining (`closed`): flush what is there.
    """
    if not pending:
        return 0
    head = pending[0]
    take = 1
    for req in itertools.islice(pending, 1, None):
        if take >= lattice.max_batch:
            break
        if not _compatible(head, req, sequence):
            break  # FIFO order kept: an incompatible request ends the
            # group rather than being skipped over
        take += 1
    if take >= lattice.max_batch:
        return lattice.max_batch
    if closed:
        return take
    if now - head.t_enqueue >= max_wait_s:
        return take
    return 0


def assemble(requests: list, lattice: BucketLattice, *,
             sequence: bool = False) -> Batch:
    """Pad a compatible group into its bucket: zero padding on the batch
    axis (rows dropped after the forward: inference forwards are
    row-independent) and, for sequence models, zero padding on the time
    axis with a [B, T] f32 validity mask (1 = real token) so masked
    attention never reads a padded key."""
    if not requests:
        raise ValueError("cannot assemble an empty batch")
    n = len(requests)
    feat0 = requests[0].features
    if sequence:
        bucket = lattice.select(n, max(r.length for r in requests))
        features = np.zeros((bucket.batch, bucket.seq) + feat0.shape[1:],
                            dtype=feat0.dtype)
        mask = np.zeros((bucket.batch, bucket.seq), dtype=np.float32)
        for i, r in enumerate(requests):
            features[i, :r.length] = r.features
            if r.mask is not None:
                mask[i, :r.length] = np.asarray(r.mask, np.float32)
            else:
                mask[i, :r.length] = 1.0
        # padding ROWS keep an all-zero mask: a fully masked row is a
        # valid (if degenerate) sequence and its output is discarded
        return Batch(bucket, features, mask, list(requests))
    bucket = lattice.select(n, None)
    features = np.zeros((bucket.batch,) + feat0.shape, dtype=feat0.dtype)
    for i, r in enumerate(requests):
        features[i] = r.features
    return Batch(bucket, features, None, list(requests))


@dataclass
class GenRequest:
    """One admitted generation request: the raw prompt tokens, the
    output budget, timing marks and the emitted-token record. `stream`
    carries each token as it is emitted and ends with None at `finish`:
    the HTTP handler drains it into the streamed body."""

    tokens: np.ndarray            # [L] int prompt
    max_new_tokens: int = 16
    request_id: str = ""
    t_enqueue: float = 0.0
    t_admitted: float = 0.0
    t_first_token: float = 0.0    # TTFT mark: prefill's last chunk done
    t_done: float = 0.0
    emitted: list = field(default_factory=list)
    error: str | None = None
    # fused_sample's keywords for a sampled request, None for greedy
    sampling: dict | None = None
    done: threading.Event = field(default_factory=threading.Event)
    stream: queue.Queue = field(default_factory=queue.Queue)

    @property
    def prompt_len(self) -> int:
        return int(self.tokens.shape[0])

    def wait(self, timeout: float | None = None) -> bool:
        return self.done.wait(timeout)

    def emit(self, token: int, now: float) -> None:
        if not self.emitted:
            self.t_first_token = now
        self.emitted.append(int(token))
        self.stream.put(int(token))

    def finish(self, now: float, error: str | None = None) -> None:
        self.error = error
        self.t_done = now
        self.stream.put(None)  # end-of-stream sentinel
        self.done.set()


class _Slot:
    """One decode slot's live state: the request it carries, how far its
    prompt has prefilled (`start`), the position its NEXT token writes
    (`pos`), and the pages it holds."""

    __slots__ = ("request", "start", "pos", "pages", "last_token")

    def __init__(self, request: GenRequest, pages: int):
        self.request = request
        self.start = 0            # prompt tokens already prefilled
        self.pages = pages
        self.pos = 0              # next write position once decoding
        self.last_token: int | None = None


class DecodeSlots:
    """The decode-slot state machine: a fixed number of slots — the
    decode step's batch rows — each FREE, PREFILLING (start <
    prompt_len) or DECODING (prompt in cache, output budget unspent).
    Admission binds a free slot to a request (the caller reserves its
    pages first); `next_prefill` picks the OLDEST prefilling slot so the
    engine interleaves exactly one prompt chunk between decode steps;
    completion frees the slot and reports the pages to release. Pure
    bookkeeping — no locks, no device state — owned by one engine worker
    thread."""

    def __init__(self, n_slots: int):
        if n_slots < 1:
            raise ValueError(f"need n_slots >= 1, got {n_slots}")
        self.slots: list = [None] * int(n_slots)

    @property
    def n_slots(self) -> int:
        return len(self.slots)

    def free_index(self) -> int | None:
        for i, s in enumerate(self.slots):
            if s is None:
                return i
        return None

    def admit(self, index: int, request: GenRequest, pages: int) -> _Slot:
        if self.slots[index] is not None:
            raise ValueError(f"slot {index} is occupied")
        slot = _Slot(request, pages)
        self.slots[index] = slot
        return slot

    def next_prefill(self) -> int | None:
        """Index of the oldest slot still prefilling (FIFO by admission
        time), or None."""
        best, best_t = None, None
        for i, s in enumerate(self.slots):
            if s is None or s.start >= s.request.prompt_len:
                continue
            if best_t is None or s.request.t_admitted < best_t:
                best, best_t = i, s.request.t_admitted
        return best

    def decoding(self) -> list:
        """Indices of slots with their whole prompt in cache and output
        budget left — the decode step's active rows."""
        return [i for i, s in enumerate(self.slots)
                if s is not None and s.start >= s.request.prompt_len
                and len(s.request.emitted) < s.request.max_new_tokens]

    def busy(self) -> bool:
        return any(s is not None for s in self.slots)

    def release(self, index: int) -> int:
        """Free a slot; returns the pages to hand back to the pool."""
        slot = self.slots[index]
        if slot is None:
            raise ValueError(f"slot {index} is already free")
        self.slots[index] = None
        return slot.pages


class Batcher:
    """The live threaded coalescer around `plan_batch` / `assemble`.

    Producers (`submit`, from HTTP handler threads) and one consumer
    (`next_batch`, the engine's dispatcher). `clock` is injectable for
    tests; the default is time.monotonic."""

    def __init__(self, lattice: BucketLattice, max_wait_ms: float = 5.0,
                 *, sequence: bool = False, clock=time.monotonic,
                 recorder=None):
        self.lattice = lattice
        self.max_wait_s = float(max_wait_ms) / 1000.0
        self.sequence = sequence
        self._clock = clock
        self._recorder = recorder
        self._pending: deque[PendingRequest] = deque()
        self._cv = threading.Condition()
        self._closed = False

    # ------------------------------------------------------------ producer
    def submit(self, features, mask=None,
               request_id: str | None = None) -> PendingRequest:
        """Admit one request. Checks the shape against the lattice up
        front (a too-long prompt is the client's 400, not a mid-batch
        crash) and wakes the dispatcher."""
        feats = np.asarray(features)
        if self.sequence:
            if feats.ndim < 1:
                raise ValueError("sequence request needs at least a "
                                 "[T] feature array")
            self.lattice.seq_bucket(int(feats.shape[0]))  # raises if too long
        req = PendingRequest(
            features=feats,
            mask=None if mask is None else np.asarray(mask),
            request_id=request_id or f"r{next(_req_counter)}",
            t_enqueue=self._clock())
        with self._cv:
            if self._closed:
                raise RuntimeError("batcher is draining; request refused")
            self._pending.append(req)
            self._cv.notify_all()
        return req

    # ------------------------------------------------------------ consumer
    def next_batch(self, timeout: float | None = None):
        """Block until a batch cuts (full bucket / deadline / drain
        flush). Returns None when draining finished (closed and empty)
        or `timeout` elapsed with nothing to cut."""
        deadline = None if timeout is None else self._clock() + timeout
        with self._cv:
            while True:
                now = self._clock()
                take = plan_batch(self._pending, now, self.max_wait_s,
                                  self.lattice, sequence=self.sequence,
                                  closed=self._closed)
                if take:
                    group = [self._pending.popleft() for _ in range(take)]
                    break
                if self._closed:
                    return None
                waits = []
                if self._pending:
                    waits.append(self._pending[0].t_enqueue
                                 + self.max_wait_s - now)
                if deadline is not None:
                    remaining = deadline - now
                    if remaining <= 0:
                        return None
                    waits.append(remaining)
                # bounded wait: re-plan on submit()/close() notify or when
                # the head request's deadline arrives
                self._cv.wait(timeout=max(min(waits), 0.0005)
                              if waits else None)
        t0 = time.perf_counter()
        batch = assemble(group, self.lattice, sequence=self.sequence)
        batch.t_cut = self._clock()
        batch.assemble_seconds = time.perf_counter() - t0
        for r in group:
            r.t_assembled = batch.t_cut
        if self._recorder is not None:
            # `queue` is the head request's wait (what the deadline
            # bounds), `batch_assemble` the host-side padding; the cut
            # roots a trace the replica thread's events join
            rec = self._recorder
            batch.trace_id = f"b{next(_req_counter)}"
            q_sid = rec.new_span_id()
            a_sid = rec.new_span_id()
            batch.parent_span = a_sid
            rec.event(
                "span", name="queue", ok=True,
                seconds=round(batch.t_cut - group[0].t_enqueue, 6),
                n_requests=len(group), trace_id=batch.trace_id,
                span_id=q_sid)
            rec.event(
                "span", name="batch_assemble", ok=True,
                seconds=round(batch.assemble_seconds, 6),
                bucket=list(batch.bucket.key()), n_real=batch.n_real,
                trace_id=batch.trace_id, span_id=a_sid, parent_id=q_sid)
        return batch

    def requeue(self, requests) -> None:
        """Put already-admitted requests BACK at the FIFO head — the
        dead-replica queue drain (serving/fleet.py): batches a reaped
        replica never ran dissolve back into pending requests, keeping
        their enqueue times, and live replicas pick them up on the next
        cut. Works while draining too: these requests were admitted
        before the close and the drain flush owes them a completion."""
        with self._cv:
            for r in reversed(list(requests)):
                self._pending.appendleft(r)
            self._cv.notify_all()

    # ------------------------------------------------------------- drain
    def close(self) -> None:
        """Begin draining: refuse new submits, flush pending groups on
        the next next_batch() calls (which return None once empty)."""
        with self._cv:
            self._closed = True
            self._cv.notify_all()

    @property
    def depth(self) -> int:
        with self._cv:
            return len(self._pending)
