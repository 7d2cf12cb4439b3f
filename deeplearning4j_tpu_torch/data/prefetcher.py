"""Event-driven background prefetch (JAX counterpart
deeplearning4j_tpu/data/prefetcher.py, whose pure-stdlib code this
module repeats so that the port imports nothing of the JAX package).

`Channel` is a Condition-based bounded buffer where every wait is
event-driven (no CPU while blocked) and every shutdown path wakes the
other side exactly once:

- producer EOS / error -> ``close()`` marks the channel; a consumer
  blocked in ``get()`` wakes and sees EOS (or the producer's exception)
  the moment the buffer drains.
- consumer ``stop()`` (reset/teardown) -> a producer blocked on a full
  buffer wakes, observes the stop, and exits; buffered items are
  discarded under the same lock, so a reset can never race a late put.

`Prefetcher` runs a daemon thread that fills a `Channel` from a source;
the sentence iterators (nlp/text.py) and the embedding engine's pair
feed (embedding/corpus.py) ride it.
"""

from __future__ import annotations

import threading
from collections import deque
from typing import Callable, Iterable, Optional


class _Eos:
    """End-of-stream marker returned by ``Channel.get``/``Prefetcher.get``
    (an identity token, never a valid item)."""

    def __repr__(self):  # pragma: no cover - debugging nicety
        return "<EOS>"


EOS = _Eos()


class Channel:
    """Bounded producer/consumer buffer with event-driven blocking.

    One producer, one consumer (the prefetch topology). ``put`` blocks
    on a Condition while the buffer is full; ``get`` blocks while it is
    empty and neither closed nor stopped. There are no timeouts anywhere
    — wakeups come only from the opposite side's notify.
    """

    def __init__(self, depth: int):
        if depth < 1:
            raise ValueError(f"channel depth must be >= 1, got {depth}")
        self._buf: deque = deque()
        self._depth = depth
        lock = threading.Lock()
        self._not_full = threading.Condition(lock)
        self._not_empty = threading.Condition(lock)
        self._closed = False
        self._stopped = False
        self._error: Optional[BaseException] = None

    def put(self, item) -> bool:
        """Producer side: block until there is room (or the consumer
        stopped the channel). Returns False when stopped — the producer
        must exit without retrying."""
        with self._not_full:
            while len(self._buf) >= self._depth and not self._stopped:
                self._not_full.wait()
            if self._stopped:
                return False
            self._buf.append(item)
            self._not_empty.notify()
            return True

    def close(self, error: Optional[BaseException] = None) -> None:
        """Producer side: no more items will arrive. With ``error``, the
        consumer re-raises it (once) after draining what's buffered —
        the step loop sees the producer's exception at the point it
        would have consumed the missing batch."""
        with self._not_full:
            self._error = error
            self._closed = True
            self._not_empty.notify_all()

    def get(self):
        """Consumer side: next item, else the producer's exception, else
        EOS. Blocks event-driven while the channel is open and empty."""
        with self._not_empty:
            while not self._buf and not self._closed and not self._stopped:
                self._not_empty.wait()
            if self._buf and not self._stopped:
                item = self._buf.popleft()
                self._not_full.notify()
                return item
            if self._error is not None:
                error, self._error = self._error, None
                raise error
            return EOS

    def stop(self) -> None:
        """Consumer side: abort the producer and discard the buffer —
        the reset path. Wakes a producer blocked on a full buffer (it
        observes the stop and exits) and any concurrent ``get``."""
        with self._not_full:
            self._stopped = True
            self._buf.clear()
            self._not_full.notify_all()
            self._not_empty.notify_all()

    def __len__(self) -> int:
        with self._not_full:
            return len(self._buf)


class Prefetcher:
    """A daemon thread filling a `Channel` from ``source``.

    ``source``: an iterable, or a zero-arg callable returning one (the
    callable form defers work — e.g. a backend ``reset()`` — into the
    thread). ``transform`` runs per item ON the prefetch thread,
    overlapping the consumer's work.

    ``get()`` returns the next (transformed) item, raises the producer's
    exception, or returns EOS. ``stop()`` aborts the producer, discards
    buffered items, and joins the thread — the reset protocol every
    adapter (PrefetchingSentenceIterator, embedding/corpus.prefetched)
    shares.
    """

    def __init__(self, source: Iterable | Callable[[], Iterable], *,
                 depth: int = 2, transform: Optional[Callable] = None,
                 name: str = "prefetch"):
        self._chan = Channel(depth)
        chan = self._chan

        def run():
            try:
                items = source() if callable(source) else source
                for item in items:
                    if transform is not None:
                        item = transform(item)
                    if not chan.put(item):
                        return  # stopped by the consumer
            except BaseException as exc:  # surfaced at the next get()
                chan.close(error=exc)
                return
            chan.close()

        self._thread = threading.Thread(target=run, daemon=True, name=name)
        self._thread.start()

    def get(self):
        return self._chan.get()

    def buffered(self) -> int:
        """Items currently queued (the bench's queue-occupancy signal)."""
        return len(self._chan)

    def stop(self, join_timeout: float = 5.0) -> bool:
        """Abort the producer and join its thread; True when the thread
        exited within ``join_timeout``."""
        self._chan.stop()
        self._thread.join(timeout=join_timeout)
        return not self._thread.is_alive()

    @property
    def alive(self) -> bool:
        return self._thread.is_alive()
