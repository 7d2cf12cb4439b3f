"""Autoregressive generation serving: `GenerationEngine` and its worker
(JAX counterpart deeplearning4j_tpu/serving/engine.py `GenerationEngine`,
`_GenWorker`).

Each admitted request holds a decode SLOT: its prompt prefills the slot's
cache row chunk by chunk, interleaved with the running decode batch so a
long prompt never stalls the other slots' tokens; then every decode step
extends all active slots by one greedy token. N generated tokens cost a
prefill plus N single-token steps, not N full-sequence forwards. Page
accounting, and exhaustion that queues instead of crashing, live in
serving/kvcache.py.

Left out of this slice: `InferenceEngine`, the HTTP `ServingServer`,
replicas and the fleet (hot-swap, reap/respawn, fault injection),
speculative decoding, the int8 cache, and the telemetry recorder with its
cost and memory books. A plain dict of counters (`stats()`) takes the
recorder's place.
"""

from __future__ import annotations

import threading
import time
import traceback
from collections import deque

import numpy as np
import torch

from deeplearning4j_tpu_torch.serving.batcher import (DecodeSlots, GenRequest,
                                                      _req_counter)
from deeplearning4j_tpu_torch.serving.buckets import BucketLattice
from deeplearning4j_tpu_torch.serving.kvcache import CachePlan


class QueueFullError(RuntimeError):
    """Generation admission refused: the page pool and the pending queue
    are both full — a graceful refusal, never a crash."""


class _GenWorker:
    """The generation worker: its KV-cache allocation, page pool,
    decode-slot state machine and the prefill and decode steps.

    The loop interleaves chunked prefills into the running decode batch:
    each iteration admits what the pool allows, runs at most ONE prompt
    chunk, then one decode step over all slots. The decode step's shape
    is fixed — [n_slots] tokens and positions against the [n_slots,
    capacity] cache; inactive rows decode a dummy token whose K/V write
    goes to the scratch position (capacity - 1), which any real tenant
    overwrites before it can be attended (a token's own K/V lands at its
    position in the same step that reads it)."""

    def __init__(self, net, lattice: BucketLattice, plan: CachePlan,
                 prefill_chunk: int, max_queue: int):
        self.net = net
        self.lattice = lattice
        self.plan = plan
        self.prefill_chunk = prefill_chunk
        self.max_queue = max_queue
        self.pool = plan.make_pool()
        self.slots = DecodeSlots(plan.n_slots)
        self.cache = net.init_kv_cache(plan.n_slots, plan.capacity)
        self._prefill = net.prefill_fn()
        self._decode = net.incremental_decode_fn()
        # guards the counters (worker-thread updates vs stats() reads);
        # never held across a device call or a queue wait
        self._mu = threading.Lock()
        self.counters = {"served": 0, "failed": 0, "tokens_out": 0,
                         "prefill_chunks": 0, "decode_steps": 0}
        self.pending: deque[GenRequest] = deque()
        self._cv = threading.Condition()
        self._closed = False
        self._thread: threading.Thread | None = None

    def _count(self, key: str, n: int = 1) -> None:
        with self._mu:
            self.counters[key] += n

    def _dev(self, a, dtype=torch.long) -> torch.Tensor:
        return torch.as_tensor(np.asarray(a), dtype=dtype,
                               device=self.net.device)

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
        """Run every prefill bucket and the decode step once before
        traffic (an all-zero key mask into row 0, dummy tokens into the
        scratch position), so the kernels are built and loaded and the
        allocator holds its working set. Returns the number of calls."""
        net = self.net
        rows = self._dev([0])
        start = self._dev([0])
        calls = 0
        for Tb in self.chunk_buckets():
            probs, self.cache = self._prefill(
                net.params, net.state, self.cache, self._dev(
                    np.zeros((1, Tb))), self._dev(np.zeros((1, Tb)),
                                                  torch.float32),
                rows, start, self._dev([Tb - 1]))
            probs.argmax(-1).cpu()
            calls += 1
        B = self.plan.n_slots
        probs, self.cache = self._decode(
            net.params, net.state, self.cache, self._dev(np.zeros(B)),
            self._dev(np.full(B, self.plan.capacity - 1)))
        probs.argmax(-1).cpu()
        return calls + 1

    # --------------------------------------------------------- admission
    def submit(self, req: GenRequest) -> None:
        pages = self.plan.request_pages(
            self.lattice.seq_bucket(req.prompt_len), req.max_new_tokens)
        if pages > self.pool.n_pages:
            raise ValueError(
                f"request needs {pages} cache pages but the pool holds "
                f"{self.pool.n_pages} — prompt + max_new_tokens exceed "
                "the cache geometry")
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

    # ----------------------------------------------------------- compute
    def _prefill_chunk(self, slot_idx: int, clock) -> None:
        """One bucket-shaped prompt chunk for one slot. The only host
        fetch is the next-token id."""
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
        net = self.net
        try:
            probs, self.cache = self._prefill(
                net.params, net.state, self.cache, self._dev(padded_tokens),
                self._dev(bucket_kmask, torch.float32),
                self._dev([slot_idx]), self._dev([slot.start]),
                self._dev([n_real - 1]))
            tok = int(probs.argmax(-1).cpu()[0])
        except Exception as exc:  # the request fails; the worker serves on
            self._fail_slot(slot_idx, exc, clock)
            return
        self._count("prefill_chunks")
        slot.start += n_real
        if final:
            # the prompt's last forward row IS the first generated token:
            # TTFT is this chunk's completion
            slot.pos = L
            slot.last_token = tok
            req.emit(tok, clock())
            self._count("tokens_out")
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
        net = self.net
        try:
            probs, self.cache = self._decode(
                net.params, net.state, self.cache, self._dev(padded_tokens),
                self._dev(pos))
            toks = probs.argmax(-1).cpu().numpy()
        except Exception as exc:  # the batch's requests fail; serve on
            for i in active:
                self._fail_slot(i, exc, clock)
            return
        self._count("decode_steps")
        now = clock()
        for i in active:
            slot = self.slots.slots[i]
            slot.pos += 1
            slot.last_token = int(toks[i])
            slot.request.emit(slot.last_token, now)
            self._count("tokens_out")
            self._maybe_complete(i, clock)

    # -------------------------------------------------------- lifecycle
    def _maybe_complete(self, slot_idx: int, clock) -> None:
        req = self.slots.slots[slot_idx].request
        if len(req.emitted) < req.max_new_tokens:
            return
        self.pool.release(self.slots.release(slot_idx))
        req.finish(clock())
        self._count("served")

    def _fail_slot(self, slot_idx: int, exc: Exception, clock) -> None:
        """The slot's request fails with the error, its pages are
        released, and the worker keeps serving."""
        req = self.slots.slots[slot_idx].request
        self.pool.release(self.slots.release(slot_idx))
        req.finish(clock(), error="".join(
            traceback.format_exception(type(exc), exc,
                                       exc.__traceback__)).strip())
        self._count("failed")

    def start(self, clock) -> None:
        def loop():
            while True:
                self._admit(clock)
                progressed = False
                pi = self.slots.next_prefill()
                if pi is not None:
                    self._prefill_chunk(pi, clock)
                    progressed = True
                active = self.slots.decoding()
                if active:
                    self._decode_batch_step(active, clock)
                    progressed = True
                if progressed:
                    continue
                with self._cv:
                    if (self._closed and not self.pending
                            and not self.slots.busy()):
                        return
                    if not self.pending or self.slots.free_index() is None:
                        self._cv.wait(timeout=0.05)

        self._thread = threading.Thread(target=loop, daemon=True,
                                        name="gen-worker")
        self._thread.start()

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


class GenerationEngine:
    """Autoregressive generation serving: prefill/decode split over a
    paged KV cache, continuous batching across decode slots, greedy
    decoding.

    `lattice` fixes the prompt-chunk shapes; `slots` is the decode
    batch; the cache holds `slots` rows of the largest prompt bucket plus
    `max_new_tokens`, quantized to `page_size`; `pool_pages` (default:
    the whole allocation) is the page budget admission reserves from;
    `prefill_chunk` (a lattice seq length, default the largest) is the
    longest prompt piece run between two decode steps."""

    def __init__(self, net, lattice: BucketLattice, *, slots: int = 4,
                 max_new_tokens: int = 16, page_size: int = 16,
                 pool_pages: int | None = None,
                 prefill_chunk: int | None = None, max_queue: int = 64):
        if lattice.seq_lens is None:
            raise ValueError("generation needs a sequence lattice "
                             "(BucketLattice with seq_lens)")
        if net.params is None:
            net.init()
        self.net = net
        self.lattice = lattice
        chunk = (lattice.max_seq if prefill_chunk is None
                 else int(prefill_chunk))
        lattice.prefill_buckets(chunk)  # raises on a non-lattice chunk
        self.prefill_chunk = chunk
        self.plan = CachePlan(lattice.max_seq, max_new_tokens,
                              max(1, int(slots)), page_size,
                              pool_pages=pool_pages)
        self._clock = time.monotonic
        self._worker = _GenWorker(net, lattice, self.plan, chunk, max_queue)
        self._started = False

    def warmup(self) -> int:
        """Run every prefill bucket and the decode step once; returns the
        number of warmup calls."""
        return self._worker.warmup()

    def start(self) -> "GenerationEngine":
        if not self._started:
            self._started = True
            self._worker.start(self._clock)
        return self

    def submit_generate(self, tokens, max_new_tokens: int | None = None,
                        request_id: str | None = None) -> GenRequest:
        """Admit one generation request. Validates the prompt against
        the lattice and the output budget against the cache geometry; a
        saturated pool + full queue raises QueueFullError."""
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
        self._worker.submit(req)
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

    def drain(self, timeout: float = 30.0) -> None:
        """Refuse new requests, finish the admitted and queued ones, and
        stop the worker thread."""
        self._worker.close()
        self._worker.join(timeout)

    @property
    def served(self) -> int:
        return self.stats()["served"]

    @property
    def failed(self) -> int:
        return self.stats()["failed"]

    def stats(self) -> dict:
        w = self._worker
        with w._mu:
            counters = dict(w.counters)
        return {**counters,
                "queue_depth": w.depth,
                "lattice": self.lattice.describe(),
                "cache": self.plan.describe(),
                "page_pool": w.pool.describe(),
                "prefill_chunk": self.prefill_chunk}
