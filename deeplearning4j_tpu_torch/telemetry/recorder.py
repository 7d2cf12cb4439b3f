"""Structured run telemetry: typed JSONL events (JAX counterpart
deeplearning4j_tpu/telemetry/recorder.py).

One JSON object per line, every event carrying ``{"event": <type>,
"ts": <unix seconds>, "run": <run id>, "seq": <n>}`` and the same field
names as the JAX package's events, so a log from either package reads
alike (serving/replay.py `reconstruct_generation` is the scoreboard of
both). The kinds the serving path emits:

| event | payload |
|---|---|
| `meta` | run header: argv, pid, free-form fields |
| `span` | a timed region: `name`, `seconds` (host wall clock), `ok`, caller fields |
| `error` | `where`, `error` (repr), `traceback` (the full string) |
| `request` | one served request. Generation: `id`, `ok`, `kind` ("generate"), `replica`, `prompt_len`, `prompt_bucket`, `new_tokens`, `queue_s`, `ttft_s`, `total_s`, `trace_id`. Predict: `id`, `ok`, `bucket`, `replica`, `n_real`, `queue_s`, `batch_assemble_s`, `total_s`, `forward_s`, `weight_gen`, and `seq_len` / `padded_seq` for sequence models; `error` when it failed |
| `fault` | an injected replica fault firing (`replica-kill`, `replica-hang`, emitted before it acts) and the fleet supervisor's records (`replica-dead` with `requeued`, `replica-respawn` with `respawn_ms`) |
| `weight_swap` | one hot-swap attempt (serving/fleet.py): `ok`, `step`, `restore_ms`, `generation`, `error` |
| `autoscale` | one supervisor autoscale tick: `n_serving`, `n_replicas`, `queue_depth`, `p99_ms`, `action` (+1 / -1 / 0), `max_replicas` |
| `page_pool` | KV-cache page accounting on every reserve/release: `replica`, `pages_total`, `page_size`, `pages_in_use`, `pages_peak` |
| `draft` | one speculative verify step: `replica`, `k`, `n_active`, `emitted`, `accepted`, `drafted`, `overhead_us` |

Generation serving names the spans `compile` (the first run of each step
shape, flagged `warmup` during warmup), `prefill_chunk`, `decode_step`
and `verify_step`; predict serving `queue`, `batch_assemble`, `forward`
and `compile`. A span times host wall clock around a step that ends in
its one batch-boundary fetch to the host, so it covers the device work.

**Correlation.** Every event may carry `trace_id` / `span_id` /
`parent_id`: `span()` allocates a span id and stamps `parent_id` from
the thread-local span stack, and `trace(trace_id)` installs a trace
context on the thread (generation requests trace by their request id).

The file is append-only JSONL at the path `$DL4J_TPU_TELEMETRY` names
(`get_default`), suffixed `.p<id>` per process when
`$DL4J_TPU_PROCESS_ID` is set, so processes that share one setting keep
separate logs.

The device-memory, cost-book and kernel-tune events (`memory`, `cost`,
`cost_drift`, `kernel_tune`) wait for the port's telemetry slice: their
methods raise NotImplementedError.
"""

from __future__ import annotations

import contextlib
import io
import json
import os
import sys
import threading
import time
import traceback as _tb
from collections import deque

ENV_VAR = "DL4J_TPU_TELEMETRY"
ENV_PROCESS_ID = "DL4J_TPU_PROCESS_ID"

# ring-buffer length of the in-memory mirror of emitted events
DEFAULT_KEEP = 4096

_TELEMETRY_SLICE = ("waits for the port's telemetry slice (ROADMAP Queue A "
                    "item 9)")


class Recorder:
    """Appends typed JSONL events to a per-run file (and an in-memory
    ring buffer, `.events`). `path=None` records in memory only."""

    def __init__(self, path: str | None = None, run_id: str | None = None,
                 keep: int = DEFAULT_KEEP):
        self.path = path
        self.run_id = run_id or f"{os.getpid():x}-{int(time.time()):x}"
        self.events: deque[dict] = deque(maxlen=keep)
        # serializes seq assignment, the ring buffer and the file handle;
        # sinks run outside it (a sink that takes its own lock, the
        # /metrics registry, must never run under this one)
        self._lock = threading.Lock()
        self._seq = 0
        self._span_seq = 0
        self._fh: io.TextIOBase | None = None
        # thread-local correlation context: the trace id and the stack of
        # open span ids on this thread
        self._tloc = threading.local()
        self._sinks: list = []

    # ------------------------------------------------- correlation context
    def _stack(self) -> list:
        stack = getattr(self._tloc, "stack", None)
        if stack is None:
            stack = self._tloc.stack = []
        return stack

    def new_span_id(self) -> str:
        """A span id unique within this run."""
        with self._lock:
            self._span_seq += 1
            return f"s{self._span_seq:x}"

    @contextlib.contextmanager
    def trace(self, trace_id: str | None, parent_id: str | None = None):
        """Install a trace context on this thread: events emitted inside
        carry `trace_id`; `parent_id` seeds the span stack with a span of
        another thread. `trace_id=None` is a no-op."""
        if trace_id is None:
            yield
            return
        prev = getattr(self._tloc, "trace_id", None)
        self._tloc.trace_id = trace_id
        stack = self._stack()
        pushed = parent_id is not None
        if pushed:
            stack.append(parent_id)
        try:
            yield
        finally:
            if pushed and stack and stack[-1] == parent_id:
                stack.pop()
            self._tloc.trace_id = prev

    def add_sink(self, fn) -> None:
        """Subscribe a live event callback, called with each emitted event
        dict on the emitting thread (the /metrics registry's feed)."""
        with self._lock:
            self._sinks.append(fn)

    # ------------------------------------------------------------- core
    # `kind` is positional-only so a payload field may itself be named
    # "kind" (generation `request` events carry one)
    def event(self, kind: str, /, **fields) -> dict:
        rec = {"event": kind, "ts": round(time.time(), 3),
               "run": self.run_id}
        trace_id = getattr(self._tloc, "trace_id", None)
        if trace_id is not None and "trace_id" not in fields:
            rec["trace_id"] = trace_id
        stack = getattr(self._tloc, "stack", None)
        if stack and "parent_id" not in fields and "span_id" not in fields:
            rec["parent_id"] = stack[-1]
        rec.update(fields)
        with self._lock:
            rec["seq"] = self._seq
            self._seq += 1
            self.events.append(rec)
            self._write(rec)
            sinks = list(self._sinks)
        for sink in sinks:
            try:
                sink(rec)
            except Exception:  # a broken sink must never break recording
                pass
        return rec

    def _write(self, rec: dict) -> None:
        # the caller holds `_lock`: seq order on disk matches assignment
        if self.path is None:
            return
        if self._fh is None:
            self._fh = open(self.path, "a")
        # one whole line per write: O_APPEND keeps concurrent writers'
        # lines intact in a shared log
        self._fh.write(json.dumps(rec, default=_jsonable) + "\n")
        self._fh.flush()

    def close(self) -> None:
        with self._lock:
            if self._fh is not None:
                self._fh.close()
                self._fh = None

    # ------------------------------------------------------ typed events
    def meta(self, **fields) -> dict:
        fields.setdefault("argv", list(sys.argv))
        fields.setdefault("pid", os.getpid())
        return self.event("meta", **fields)

    def error(self, where: str, exc: BaseException | None = None,
              traceback_str: str | None = None, **fields) -> dict:
        """An `error` event with the full traceback string."""
        if traceback_str is None and exc is not None:
            traceback_str = "".join(_tb.format_exception(
                type(exc), exc, exc.__traceback__))
        return self.event(
            "error", where=where,
            error=repr(exc) if exc is not None else fields.pop("error", ""),
            traceback=traceback_str or "", **fields)

    def request(self, request_id: str, *, ok: bool = True,
                **fields) -> dict:
        """A `request` event: one served request, the traffic replay's
        only scoreboard source."""
        return self.event("request", id=request_id, ok=bool(ok), **fields)

    def fault(self, kind: str, **fields) -> dict:
        """A `fault` event: an injected failure firing, or a fleet
        supervisor's reap/respawn record. Emitted BEFORE the fault acts
        (`_write` flushes per line), so the fault -> recovery timeline
        reads from the JSONL alone."""
        return self.event("fault", kind=kind, **fields)

    def memory(self, **fields) -> dict:
        raise NotImplementedError(f"Recorder.memory {_TELEMETRY_SLICE}")

    def cost(self, entry: str, shape, **fields) -> dict:
        raise NotImplementedError(f"Recorder.cost {_TELEMETRY_SLICE}")

    def cost_drift(self, **fields) -> dict:
        raise NotImplementedError(f"Recorder.cost_drift {_TELEMETRY_SLICE}")

    def kernel_tune(self, kernel: str, key: str, params: dict,
                    seconds: float | None = None, role: str = "candidate",
                    **fields) -> dict:
        raise NotImplementedError(f"Recorder.kernel_tune {_TELEMETRY_SLICE}")

    # -------------------------------------------------------------- spans
    @contextlib.contextmanager
    def span(self, name: str, **fields):
        """Time a region: emits a `span` event with wall-clock `seconds`
        on exit. The yielded dict can be mutated to attach result fields.
        An exception inside emits an `error` event and the span with
        `ok: false`, then re-raises. The region gets a fresh `span_id`,
        its `parent_id` is the enclosing open span on this thread, and
        events emitted inside parent to it."""
        stack = self._stack()
        parent = fields.pop("parent_id", None) or (stack[-1] if stack
                                                   else None)
        sid = fields.pop("span_id", None) or self.new_span_id()
        ids = {"span_id": sid}
        if parent is not None:
            ids["parent_id"] = parent
        t0 = time.perf_counter()
        stack.append(sid)
        try:
            yield fields
        except BaseException as exc:
            self.error(f"span:{name}", exc=exc)
            stack.pop()
            self.event("span", name=name, ok=False,
                       seconds=round(time.perf_counter() - t0, 6),
                       **ids, **fields)
            raise
        stack.pop()
        self.event("span", name=name, ok=True,
                   seconds=round(time.perf_counter() - t0, 6),
                   **ids, **fields)


class NullRecorder(Recorder):
    """Telemetry off: every emit is a no-op; `span` still runs the body,
    recording nothing."""

    def __init__(self):
        super().__init__(path=None, run_id="null", keep=1)

    def event(self, kind: str, /, **fields) -> dict:  # noqa: D102
        return {}

    @contextlib.contextmanager
    def span(self, name: str, **fields):
        yield fields


def _jsonable(obj):
    """json.dumps fallback: tensors and numpy scalars as float, else
    repr, instead of failing the log write."""
    try:
        return float(obj)
    except Exception:
        return repr(obj)


# ------------------------------------------------------- process default
_NULL = NullRecorder()
_default: Recorder | None = None


def set_default(recorder: Recorder | None) -> Recorder | None:
    """Install the process-global recorder; returns the previous one
    (None if the env-var/null fallback was in effect)."""
    global _default
    prev, _default = _default, recorder
    return prev


def _process_scoped(path: str) -> str:
    """`<path>.p<id>` when `$DL4J_TPU_PROCESS_ID` names this process,
    else `path`."""
    process_id = os.environ.get(ENV_PROCESS_ID)
    return path if process_id is None else f"{path}.p{process_id}"


def get_default() -> Recorder:
    """The process-global recorder: an explicit `set_default`, else a
    file recorder appending to `$DL4J_TPU_TELEMETRY` (created on first
    use, suffixed per process), else a no-op NullRecorder."""
    global _default
    if _default is not None:
        return _default
    path = os.environ.get(ENV_VAR)
    if path:
        _default = Recorder(_process_scoped(path))
        return _default
    return _NULL
