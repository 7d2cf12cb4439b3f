"""Session-scoped UI storage (reference: ui/storage/{SessionStorage,
HistoryStorage}.java — maps keyed by (sessionId, objectType) with history).

Thread-safe: listeners post from training threads while the HTTP server
reads from request threads.

The port's copy of the JAX package's ui/storage.py (numpy on the host, the
same results on the same input); the port imports nothing of that package.
"""

from __future__ import annotations

import threading
import time
from collections import defaultdict
from typing import Any, Dict, List, Optional, Tuple


class SessionStorage:
    """Latest-value store keyed by (session_id, object_type)
    (storage/SessionStorage.java)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._data: Dict[Tuple[str, str], Any] = {}
        self._update_time: Dict[Tuple[str, str], float] = {}

    def put(self, session_id: str, object_type: str, value: Any) -> None:
        with self._lock:
            self._data[(session_id, object_type)] = value
            self._update_time[(session_id, object_type)] = time.time()

    def get(self, session_id: str, object_type: str) -> Optional[Any]:
        with self._lock:
            return self._data.get((session_id, object_type))

    def sessions(self) -> List[str]:
        with self._lock:
            return sorted({k[0] for k in self._data})

    def object_types(self, session_id: str) -> List[str]:
        with self._lock:
            return sorted({t for (s, t) in self._data if s == session_id})

    def last_update(self, session_id: str, object_type: str) -> float:
        with self._lock:
            return self._update_time.get((session_id, object_type), 0.0)


class HistoryStorage(SessionStorage):
    """Appends every put to a bounded history list
    (storage/HistoryStorage.java)."""

    def __init__(self, max_history: int = 1000):
        super().__init__()
        self.max_history = max_history
        self._history: Dict[Tuple[str, str], List[Any]] = defaultdict(list)

    def put(self, session_id: str, object_type: str, value: Any) -> None:
        super().put(session_id, object_type, value)
        with self._lock:
            h = self._history[(session_id, object_type)]
            h.append(value)
            if len(h) > self.max_history:
                del h[: len(h) - self.max_history]

    def history(self, session_id: str, object_type: str) -> List[Any]:
        with self._lock:
            return list(self._history.get((session_id, object_type), []))
