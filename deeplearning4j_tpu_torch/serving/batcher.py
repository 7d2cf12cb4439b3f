"""Generation-side request and decode-slot state (JAX counterpart
deeplearning4j_tpu/serving/batcher.py: `GenRequest`, `_Slot`,
`DecodeSlots`). The predict-side dynamic batcher (`Batcher`,
`plan_batch`, `assemble`) belongs to `InferenceEngine`, which comes with
a later slice.
"""

from __future__ import annotations

import itertools
import queue
import threading
from dataclasses import dataclass, field

import numpy as np

_req_counter = itertools.count()


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
