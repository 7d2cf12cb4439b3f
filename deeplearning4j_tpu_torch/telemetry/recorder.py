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
| `fault` | an injected replica or process fault firing (`replica-kill`, `replica-hang`; `kill`, `hang`, `delay-connect`, `drop-heartbeat` with `process_id`, `step`, `spec`, `fired`), emitted before it acts; the launcher's exit classes (`observed_exit`); the fleet supervisor's records (`replica-dead` with `requeued`, `replica-respawn` with `respawn_ms`) and the elastic supervisor's (`reform`, `peer-loss-exit`) |
| `step` | one completed training step of `fit_steps`: `iteration`, `trace_id` ("step-N") |
| `anomaly` | one detector finding put on the record live (telemetry/trace.py `StragglerWatch`, `MemoryWatch`): `kind` and the finding's fields |
| `weight_swap` | one hot-swap attempt (serving/fleet.py): `ok`, `step`, `restore_ms`, `generation`, `error` |
| `autoscale` | one supervisor autoscale tick: `n_serving`, `n_replicas`, `queue_depth`, `p99_ms`, `action` (+1 / -1 / 0), `max_replicas` |
| `page_pool` | KV-cache page accounting on every reserve/release: `replica`, `pages_total`, `page_size`, `pages_in_use`, `pages_peak` |
| `draft` | one speculative verify step: `replica`, `k`, `n_active`, `emitted`, `accepted`, `drafted`, `overhead_us` |
| `metric` | a bench metric line verbatim (any dict with a `metric` key) |
| `eval` | evaluation results: `stats` (accuracy / precision / recall / f1, or the dict given) |
| `memory` | a device-memory snapshot (telemetry/memstat.py): `live_array_bytes` and `live_array_count` (the card's allocated bytes and active blocks; off the card, the ledger's attributed bytes), `devices` ({id: `bytes_in_use`, `peak_bytes_in_use`, `bytes_limit`} from `torch.cuda.memory_stats`, `max_memory_allocated` and `mem_get_info`; empty off the card), and from a sampler `ledger` ({params, opt_state, kv_pages, prefetch, activations, other} bytes), `ledger_total_bytes` and `source` ("warmup", "stats_tick", "fit", "sampler") |
| `cost` | one cost-book entry (telemetry/costbook.py), counted once per (entry, shape) at warmup or a fit's first step: `entry`, `shape`, `flops`, `torch_flops`, `kernel_flops`, `peak_temp_bytes` (on the card), `argument_bytes`, `output_bytes` |
| `cost_drift` | the placement cost model's predicted per-device bytes against a measured peak: `predicted_bytes`, `measured_bytes`, `ratio`, `factor`, `source` |

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

The kernel-tune event (`kernel_tune`) records one measurement of a
kernel's launch-parameter variant by `port_tools/kerneltune.py`, and an
entry of the tuning table that `ops/autotune.py` rejected.
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

# ------------------------------------------------------ registered schema
# The closed set of event kinds and span names the port emits, the JAX
# package's sets (its telemetry/recorder.py): telemetry/trace.py
# classifies every record it merges by them, and
# tests/test_torch_telemetry_schema.py holds every string-literal
# `event("...")` / `span("...")` of the port to them. A new kind or name
# is registered here first.
EVENT_KINDS = frozenset({
    "meta", "step", "span", "metric", "eval", "memory", "error", "fault",
    "bucket_plan", "kernel_tune", "request", "page_pool", "draft",
    "reshard_plan",
    "placement_search", "host_gather", "weight_swap", "autoscale",
    "anomaly", "cost", "cost_drift",
})

SPAN_NAMES = frozenset({
    # compile/step spine (nn/, the profiler)
    "compile", "step_scan", "profiler_trace",
    # serving batch pipeline (serving/batcher.py, engine.py)
    "queue", "batch_assemble", "forward", "prefill_chunk", "decode_step",
    "verify_step", "drain",
    # input pipeline (data/pipeline.py)
    "input_wait",
    # resharding + placement (reshard/)
    "reshard",
    # distributed runtime + elastic recovery (distributed/)
    "distributed_init", "distributed_launch", "elastic_generation",
    "elastic_resume",
    # bench harness spans
    "bucket_reduce", "bucket_reduce_capped", "overlap_sweep", "ab_repeat",
    # embedding engine + ANN serving (embedding/)
    "gather", "scatter_add", "ann_probe",
})

# ring-buffer length of the in-memory mirror of emitted events
DEFAULT_KEEP = 4096

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

    def step(self, iteration: int, score=None, **fields) -> dict:
        """A `step` event: one completed training step
        (`nn/training.fit_steps`). Every fleet member's step N carries
        the trace id ``step-N``, the key on which the merged timeline
        joins step completions (telemetry/trace.py's straggler
        detector)."""
        if score is not None:
            fields["score"] = float(score)
        fields.setdefault("trace_id", f"step-{int(iteration)}")
        return self.event("step", iteration=int(iteration), **fields)

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

    def metric(self, line: dict) -> dict:
        """A bench metric line verbatim, flattened into the event."""
        return self.event("metric", **line)

    def eval(self, stats, **fields) -> dict:
        """An `eval` event. `stats` is a dict, or an Evaluation-like
        object whose accuracy / precision / recall / f1 are taken (one
        that fails to give one leaves it out)."""
        if not isinstance(stats, dict):
            summary = {}
            for name in ("accuracy", "precision", "recall", "f1"):
                fn = getattr(stats, name, None)
                if callable(fn):
                    try:
                        summary[name] = float(fn())
                    except Exception:
                        pass
            stats = summary
        return self.event("eval", stats=stats, **fields)

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

    def anomaly(self, kind: str, **fields) -> dict:
        """An `anomaly` event: one detector finding (telemetry/trace.py)
        put on the record live — the elastic supervisor's straggler
        watch emits these while a generation still runs."""
        return self.event("anomaly", kind=kind, **fields)

    def memory(self, **fields) -> dict:
        """A device-memory snapshot without a ledger: the card's
        allocated bytes and its per-device stats (telemetry/memstat.py);
        off the card no device stats and nothing live. Reads allocator
        counters only — no device sync — so it is safe between steps."""
        from deeplearning4j_tpu_torch.telemetry.memstat import (
            device_memory_stats,
            live_array_totals,
        )

        live_bytes, count = live_array_totals()
        return self.event("memory", live_array_bytes=int(live_bytes),
                          live_array_count=count,
                          devices=device_memory_stats(), **fields)

    def cost(self, entry: str, shape, **fields) -> dict:
        """A `cost` event: one cost-book entry (telemetry/costbook.py),
        counted at warmup or a fit's first step, never in the steady
        state."""
        return self.event("cost", entry=entry, shape=shape, **fields)

    def cost_drift(self, *, predicted_bytes: int, measured_bytes: int,
                   factor: float, source: str = "placement",
                   **fields) -> dict:
        """A `cost_drift` event: the placement cost model's predicted
        per-device bytes against a measured peak. `ratio`
        (measured/predicted) outside [1/factor, factor] is the
        detector's trigger (telemetry/trace.py `detect_cost_drift`)."""
        predicted = max(1, int(predicted_bytes))
        ratio = float(measured_bytes) / float(predicted)
        return self.event("cost_drift",
                          predicted_bytes=int(predicted_bytes),
                          measured_bytes=int(measured_bytes),
                          ratio=round(ratio, 6), factor=float(factor),
                          source=source, **fields)

    def kernel_tune(self, kernel: str, key: str, params: dict,
                    seconds: float | None = None, role: str = "candidate",
                    **fields) -> dict:
        """A `kernel_tune` event: one micro-bench measurement of a
        kernel's launch-parameter variant (port_tools/kerneltune.py), or
        a tuning entry that ops/autotune.py rejected (role "rejected").
        The telemetry log is the provenance trail behind
        ops/tuning_table.json: every candidate's timing survives even if
        the sweep crashes before writing the table."""
        if seconds is not None:
            fields["seconds"] = round(float(seconds), 9)
        return self.event("kernel_tune", kernel=kernel, key=key,
                          params=dict(params), role=role, **fields)

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

    def eval(self, stats, **fields) -> dict:
        return {}  # skip the stats-dict build, not just the write

    def memory(self, **fields) -> dict:
        return {}  # skip the allocator reads

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
    """`<path>.p<id>` when the rendezvous contract's process-id variable
    (distributed/bootstrap.py ENV_PROCESS_ID, its one spelling) names
    this process, else `path`."""
    from deeplearning4j_tpu_torch.distributed.bootstrap import ENV_PROCESS_ID

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
