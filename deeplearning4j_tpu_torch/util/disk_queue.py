"""Disk-backed FIFO queue (JAX counterpart
deeplearning4j_tpu/util/disk_queue.py, the port's own copy; reference
util/DiskBasedQueue.java).

Spills queued items to one pickle file each so arbitrarily large streams
(e.g. pre-tokenized corpora feeding a fit loop) don't live in RAM. The
reference drains adds to disk on a background thread with a 1s poll; here
writes are synchronous — simpler, race-free, and fast enough for the
host-side data path this serves.
"""

from __future__ import annotations

import os
import pickle
import shutil
import tempfile
import uuid
from collections import deque
from typing import Any, Iterable, Optional


class DiskBasedQueue:
    """add/offer + poll/peek FIFO; items round-trip through pickle."""

    _MARKER = ".dl4j-queue"

    def __init__(self, path: Optional[str] = None):
        if path is None:
            path = tempfile.mkdtemp(prefix="dl4j-queue-")
        self.dir = path
        if os.path.exists(self.dir) and not os.path.isdir(self.dir):
            raise ValueError("queue path must be a directory")
        if os.path.isdir(self.dir) and os.listdir(self.dir):
            # only reclaim a directory a previous queue created (marker
            # file present) — never wipe arbitrary user data
            if not os.path.exists(os.path.join(self.dir, self._MARKER)):
                raise ValueError(
                    f"refusing to clear non-empty directory {self.dir!r}: "
                    f"not a {type(self).__name__} directory")
            shutil.rmtree(self.dir)
        os.makedirs(self.dir, exist_ok=True)
        with open(os.path.join(self.dir, self._MARKER), "w"):
            pass
        self._paths: deque = deque()

    # -------------------------------------------------------------- writes
    def add(self, item: Any) -> bool:
        p = os.path.join(self.dir, uuid.uuid4().hex)
        with open(p, "wb") as f:
            pickle.dump(item, f, protocol=pickle.HIGHEST_PROTOCOL)
        self._paths.append(p)
        return True

    offer = add

    def add_all(self, items: Iterable[Any]) -> bool:
        for it in items:
            self.add(it)
        return True

    # --------------------------------------------------------------- reads
    def __len__(self) -> int:
        return len(self._paths)

    def is_empty(self) -> bool:
        return not self._paths

    def peek(self) -> Any:
        if not self._paths:
            return None
        with open(self._paths[0], "rb") as f:
            return pickle.load(f)

    def poll(self) -> Any:
        """Remove and return the head, or None when empty."""
        if not self._paths:
            return None
        p = self._paths.popleft()
        with open(p, "rb") as f:
            item = pickle.load(f)
        os.remove(p)
        return item

    def clear(self) -> None:
        while self._paths:
            os.remove(self._paths.popleft())

    def close(self) -> None:
        self.clear()
        shutil.rmtree(self.dir, ignore_errors=True)
