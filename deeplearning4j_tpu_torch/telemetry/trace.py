"""Fleet-wide trace timeline: shard merge, span statistics, anomaly
detection, and Chrome-trace/Perfetto export over telemetry JSONL.

A production fleet writes N disjoint logs — the multi-process runtime
suffixes `DL4J_TPU_TELEMETRY` per process (`<path>.pN`,
recorder._process_scoped), serving replicas thread their events through
one shared file — and until this module nothing merged, correlated, or
watched them. This is the arXiv:1810.11112 characterization discipline
(know WHERE each step's time goes, across every process) applied to the
whole fleet:

* **merge** — `load_timeline` discovers `<path>.pN` shards (or takes
  the single file), tags every event with its `process` label, and
  orders the union causally: timestamp-major, then per-process `seq`
  (two events from ONE process never reorder, however close their
  clock stamps).
* **correlate** — spans carry `trace_id`/`span_id`/`parent_id`
  (recorder.py stamps them); `span_tree` rebuilds the per-trace tree
  (request → queue → batch_assemble → forward → compile), and `step`
  events join across processes by their shared `step-<n>` trace id.
* **analyze** — `span_stats` gives p50/p99/count per (process, span
  name); `detect_anomalies` emits typed findings:
    - `straggler`: cross-process step-completion skew past a threshold,
      or a process that STOPPED advancing while its peers continued
      (the `pN:hang@stepK` fault signature, from the JSONL alone);
    - `retrace`: a post-warmup `compile` span — a process that emitted
      warmup-flagged compiles and later compiles WITHOUT the flag broke
      the zero-retrace contract (the runtime witness of the bucket
      lattice's guarantee);
    - `input_wait_spike`: a pipelined input dequeue stalling past the
      threshold (the starve-proof contract's runtime witness);
    - `queue_spike`: a serving batch whose head request waited far past
      the batcher deadline, or an autoscale tick whose queue depth blew
      through the spike threshold;
    - `leak`: monotonic steady-state growth of a process's live device
      bytes across its `memory` snapshots (retained batches, an
      unbounded cache) past a growth floor;
    - `headroom`: a device's backend-reported `bytes_in_use` past the
      watermark fraction of `bytes_limit` (off-TPU runs carry no limit
      and never flag);
    - `cost_drift`: the placement cost model's predicted per-device
      memory vs a measured peak outside the documented factor — from
      typed `cost_drift` events (the costbook's reconcile loop) or the
      placement_search/memory join as a fallback.
* **export** — `to_perfetto` emits Chrome trace-event JSON
  (`ui.perfetto.dev` opens it directly): spans as complete ("X")
  slices, requests as slices over their `total_s`, instants ("i") for
  faults/steps/anomalies, counter ("C") tracks from `memory` events
  (live bytes + the per-subsystem ledger), one track per
  (process, replica).

Pure stdlib: the port's copy of the JAX package's trace tools
(deeplearning4j_tpu/telemetry/trace.py), over the same event schema.
`MemoryWatch` and the leak, headroom and cost-drift detectors read
the `memory` events of telemetry/memstat.py and the `cost_drift`
events of telemetry/costbook.py `reconcile`.
"""

from __future__ import annotations

import glob
import json
import os
import re
from dataclasses import dataclass, field


# ---------------------------------------------------------------- loading

def discover_shards(path: str) -> list:
    """[(process_label, path), ...] for a telemetry path: the file
    itself when it exists (label "main"), plus/or every `<path>.pN`
    shard in process order. A sharded fleet run usually has ONLY the
    suffixed files; a bench sweep has the unsuffixed parent log AND the
    fleet modes' shards."""
    out = []
    if os.path.exists(path):
        out.append(("main", path))
    shards = []
    for cand in glob.glob(glob.escape(path) + ".p*"):
        m = re.match(r"\.p(\d+)$", cand[len(path):])
        if m:
            shards.append((int(m.group(1)), cand))
    out.extend((f"p{n}", p) for n, p in sorted(shards))
    if not out:
        raise FileNotFoundError(
            f"no telemetry at {path} (and no {path}.p* shards)")
    return out


def parse_events(text: str, process: str = "main") -> list:
    """JSONL text -> event dicts tagged with their `process` label.
    Non-JSON and truncated lines are skipped (the append-only contract
    means only the final line of a crashed writer can be partial)."""
    events = []
    for raw in text.splitlines():
        raw = raw.strip()
        if not raw.startswith("{"):
            continue
        try:
            ev = json.loads(raw)
        except json.JSONDecodeError:
            continue
        if not isinstance(ev, dict) or "event" not in ev:
            continue
        ev.setdefault("process", process)
        events.append(ev)
    return events


@dataclass
class Timeline:
    """The merged, causally-ordered fleet timeline."""

    events: list = field(default_factory=list)

    @property
    def processes(self) -> list:
        seen, out = set(), []
        for ev in self.events:
            p = ev.get("process", "main")
            if p not in seen:
                seen.add(p)
                out.append(p)
        return out

    def spans(self, name=None, process=None) -> list:
        return [ev for ev in self.events
                if ev.get("event") == "span"
                and (name is None or ev.get("name") == name)
                and (process is None or ev.get("process") == process)]

    def of_kind(self, kind: str) -> list:
        return [ev for ev in self.events if ev.get("event") == kind]


def merge_events(events: list) -> Timeline:
    """Causal order: timestamp-major; ties (and clock jitter inside one
    process) break on (process, seq) so a single process's stream never
    reorders."""
    ordered = sorted(
        events,
        key=lambda ev: (float(ev.get("ts", 0.0)), str(ev.get("process")),
                        int(ev.get("seq", 0))))
    return Timeline(events=ordered)


def timeline_from_events(events, process: str = "main") -> Timeline:
    """A Timeline from in-memory recorder events (`rec.events`) — the
    unit-test and single-process path; events lacking a `process` tag
    get the given label."""
    tagged = []
    for ev in events:
        ev = dict(ev)
        ev.setdefault("process", process)
        tagged.append(ev)
    return merge_events(tagged)


def load_timeline(path: str) -> Timeline:
    """Path (or its `.pN` shard family) -> merged Timeline."""
    events = []
    for label, shard in discover_shards(path):
        with open(shard) as fh:
            events.extend(parse_events(fh.read(), process=label))
    return merge_events(events)


# ------------------------------------------------------------- statistics

def _percentile(sorted_vals, q: float) -> float:
    if not sorted_vals:
        return 0.0
    k = min(len(sorted_vals) - 1,
            max(0, int(round(q / 100.0 * (len(sorted_vals) - 1)))))
    return float(sorted_vals[k])


def span_stats(timeline: Timeline) -> dict:
    """{(process, span name): {count, p50_ms, p99_ms, max_ms, total_s}}
    — where each process's time went, per span kind."""
    groups: dict = {}
    for ev in timeline.spans():
        if "seconds" not in ev:
            continue
        key = (ev.get("process", "main"), str(ev.get("name")))
        groups.setdefault(key, []).append(1000.0 * float(ev["seconds"]))
    out = {}
    for key, ms in groups.items():
        ms.sort()
        out[key] = {
            "count": len(ms),
            "p50_ms": round(_percentile(ms, 50), 3),
            "p99_ms": round(_percentile(ms, 99), 3),
            "max_ms": round(ms[-1], 3),
            "total_s": round(sum(ms) / 1000.0, 6),
        }
    return out


# ----------------------------------------------------------- span trees

def span_tree(timeline: Timeline, trace_id: str) -> list:
    """The span tree of one trace: roots (no parent, or parent outside
    the trace) with nested `children` lists. Events are grouped per
    process — `span_id`s are only unique within one — and non-span
    events that carry the trace (request, page_pool, error) attach as
    leaves under their parent span."""
    members = [ev for ev in timeline.events
               if ev.get("trace_id") == trace_id]
    nodes = {}
    for ev in members:
        sid = ev.get("span_id")
        key = (ev.get("process", "main"), sid)
        node = {"event": ev, "children": []}
        if sid is not None:
            nodes[key] = node
    roots = []
    for ev in members:
        sid = ev.get("span_id")
        node = (nodes[(ev.get("process", "main"), sid)]
                if sid is not None else {"event": ev, "children": []})
        parent = ev.get("parent_id")
        pkey = (ev.get("process", "main"), parent)
        if parent is not None and pkey in nodes \
                and nodes[pkey] is not node:
            nodes[pkey]["children"].append(node)
        else:
            roots.append(node)
    return roots


def trace_ids(timeline: Timeline) -> list:
    seen, out = set(), []
    for ev in timeline.events:
        tid = ev.get("trace_id")
        if tid is not None and tid not in seen:
            seen.add(tid)
            out.append(tid)
    return out


def render_tree(roots, indent: int = 0) -> str:
    """Human-readable tree (tracetool `tree`)."""
    lines = []
    for node in roots:
        ev = node["event"]
        name = (ev.get("name") if ev.get("event") == "span"
                else ev.get("event"))
        extra = ""
        if "seconds" in ev:
            extra = f" {1000.0 * float(ev['seconds']):.3f}ms"
        if ev.get("event") == "request":
            extra = f" id={ev.get('id')} total={ev.get('total_s')}s"
        lines.append("  " * indent
                     + f"{ev.get('process', 'main')}: {name}{extra}")
        lines.append(render_tree(node["children"], indent + 1))
    return "\n".join(l for l in lines if l)


# ------------------------------------------------------ anomaly detection

@dataclass(frozen=True)
class AnomalyConfig:
    """Detection thresholds. Defaults are deliberately generous — a
    contended CPU host must not read as a production incident; tighten
    per-deployment via tracetool flags."""

    straggler_skew_ms: float = 2000.0   # cross-process step-completion skew
    stall_factor: float = 3.0           # a process is stalled when silent
    #                                     for stall_factor x the fleet's
    #                                     median step gap (and past skew_ms)
    input_wait_spike_ms: float = 250.0  # pipelined dequeue stall
    input_wait_warmup: int = 2          # dequeues skipped per process
    #                                     (the first fills ride the
    #                                     producer's cold start)
    queue_spike_ms: float = 1000.0      # serving head-request wait
    queue_depth_spike: int = 64         # autoscale-tick queue depth
    # memory detectors (telemetry/memstat.py's `memory` events)
    leak_warmup: int = 2                # memory samples skipped per
    #                                     process (warmup allocations,
    #                                     compile-time temps)
    leak_min_samples: int = 4           # steady-state samples needed
    #                                     before monotonic growth reads
    #                                     as a leak
    leak_min_growth_bytes: float = 1 << 20  # total growth floor (1 MiB)
    headroom_watermark: float = 0.92    # live/limit past this is a
    #                                     headroom breach
    cost_drift_factor: float = 8.0      # predicted-vs-measured memory
    #                                     ratio band (see telemetry/
    #                                     costbook.DEFAULT_DRIFT_FACTOR)


def _step_completions(timeline: Timeline) -> dict:
    """{process: {iteration: ts}} over `step` events."""
    steps: dict = {}
    for ev in timeline.of_kind("step"):
        it = ev.get("iteration")
        if it is None:
            continue
        steps.setdefault(ev.get("process", "main"), {})[int(it)] = float(
            ev.get("ts", 0.0))
    return steps


def detect_stragglers(timeline: Timeline,
                      config: AnomalyConfig = AnomalyConfig()) -> list:
    """Cross-process step-completion skew + stalled-process (hang)
    findings. Only meaningful with >= 2 step-emitting processes."""
    steps = _step_completions(timeline)
    procs = [p for p, s in steps.items() if s]
    if len(procs) < 2:
        return []
    findings = []
    all_steps = sorted({s for per in steps.values() for s in per})
    # skew on steps every process completed
    for s in all_steps:
        done = {p: steps[p][s] for p in procs if s in steps[p]}
        if len(done) != len(procs):
            continue
        skew_ms = 1000.0 * (max(done.values()) - min(done.values()))
        if skew_ms > config.straggler_skew_ms:
            slowest = max(done, key=done.get)
            findings.append({
                "anomaly": "straggler", "mode": "skew", "step": s,
                "process": slowest,
                "skew_ms": round(skew_ms, 3),
                "threshold_ms": config.straggler_skew_ms})
    # stalled processes: stopped advancing while the fleet continued
    fleet_last = max(max(per) for per in steps.values())
    gaps = []
    for per in steps.values():
        ordered = sorted(per)
        gaps.extend(per[b] - per[a]
                    for a, b in zip(ordered, ordered[1:]))
    gaps.sort()
    median_gap_s = _percentile(gaps, 50) if gaps else 0.0
    for p in procs:
        last = max(steps[p])
        if last >= fleet_last:
            continue
        # a peer completed a LATER step — how long after this process
        # went silent?
        later = [ts for q in procs if q != p
                 for s, ts in steps[q].items() if s > last]
        if not later:
            continue
        silent_ms = 1000.0 * (max(later) - steps[p][last])
        if silent_ms > max(config.straggler_skew_ms,
                           1000.0 * config.stall_factor * median_gap_s):
            findings.append({
                "anomaly": "straggler", "mode": "stall",
                "process": p, "step": last + 1,
                "last_step": last,
                "fleet_step": fleet_last,
                "skew_ms": round(silent_ms, 3),
                "threshold_ms": config.straggler_skew_ms})
    return findings


def detect_retraces(timeline: Timeline) -> list:
    """Post-warmup retraces, per process: once a process has emitted a
    warmup-flagged `compile` span (the serving warmup discipline is in
    effect), any LATER `compile` without the flag is a shape that
    escaped the bucket lattice — the zero-retrace contract's runtime
    witness. Training runs never set the flag and never flag here
    (their first-dispatch compiles are the expected cost)."""
    warmed: set = set()
    findings = []
    for ev in timeline.events:
        if ev.get("event") != "span" or ev.get("name") != "compile":
            continue
        p = ev.get("process", "main")
        # one process file can hold many runs (the bench sweep's shared
        # log): warmup discipline is scoped per (process, run)
        scope = (p, ev.get("run"))
        if ev.get("warmup"):
            warmed.add(scope)
        elif scope in warmed:
            findings.append({
                "anomaly": "retrace", "process": p,
                "run": ev.get("run"),
                "bucket": ev.get("bucket"),
                "replica": ev.get("replica"),
                "seconds": ev.get("seconds"),
                "ts": ev.get("ts")})
    return findings


def detect_input_wait_spikes(timeline: Timeline,
                             config: AnomalyConfig = AnomalyConfig()
                             ) -> list:
    """Pipelined `input_wait` dequeues stalling past the threshold —
    the producer fell behind the step loop. The synchronous fallback's
    spans (pipelined=false) measure the whole conversion and are
    exempt; the first `input_wait_warmup` dequeues per process ride the
    producer's cold start and are skipped."""
    findings = []
    seen: dict = {}
    for ev in timeline.events:
        if ev.get("event") != "span" or ev.get("name") != "input_wait":
            continue
        if not ev.get("pipelined"):
            continue
        p = ev.get("process", "main")
        seen[p] = seen.get(p, 0) + 1
        if seen[p] <= config.input_wait_warmup:
            continue
        wait_ms = 1000.0 * float(ev.get("seconds", 0.0))
        if wait_ms > config.input_wait_spike_ms:
            findings.append({
                "anomaly": "input_wait_spike", "process": p,
                "wait_ms": round(wait_ms, 3),
                "threshold_ms": config.input_wait_spike_ms,
                "ts": ev.get("ts")})
    return findings


def detect_queue_spikes(timeline: Timeline,
                        config: AnomalyConfig = AnomalyConfig()) -> list:
    """Serving queue pathologies: a batch whose head request waited far
    past the batcher's deadline (`queue` span), or an autoscale tick
    that sampled a queue depth past the spike threshold."""
    findings = []
    for ev in timeline.events:
        if ev.get("event") == "span" and ev.get("name") == "queue":
            wait_ms = 1000.0 * float(ev.get("seconds", 0.0))
            if wait_ms > config.queue_spike_ms:
                findings.append({
                    "anomaly": "queue_spike", "kind": "wait",
                    "process": ev.get("process", "main"),
                    "wait_ms": round(wait_ms, 3),
                    "threshold_ms": config.queue_spike_ms,
                    "ts": ev.get("ts")})
        elif ev.get("event") == "autoscale":
            depth = int(ev.get("queue_depth", 0))
            if depth > config.queue_depth_spike:
                findings.append({
                    "anomaly": "queue_spike", "kind": "depth",
                    "process": ev.get("process", "main"),
                    "queue_depth": depth,
                    "threshold": config.queue_depth_spike,
                    "ts": ev.get("ts")})
    return findings


def _memory_samples(timeline: Timeline) -> dict:
    """{process: [memory event, ...]} in timeline order."""
    out: dict = {}
    for ev in timeline.of_kind("memory"):
        out.setdefault(ev.get("process", "main"), []).append(ev)
    return out


def detect_leaks(timeline: Timeline,
                 config: AnomalyConfig = AnomalyConfig()) -> list:
    """Monotonic steady-state live-bytes growth, per process: after the
    first `leak_warmup` samples (warmup allocations and compile temps
    ride those), `leak_min_samples`+ snapshots whose `live_array_bytes`
    never decreases AND grows by `leak_min_growth_bytes` total is a
    leak — something (retained batches, an unbounded cache) is pinning
    device memory every step. One finding per process."""
    findings = []
    for process, samples in _memory_samples(timeline).items():
        vals = [int(ev.get("live_array_bytes", 0) or 0)
                for ev in samples][config.leak_warmup:]
        if len(vals) < config.leak_min_samples:
            continue
        if any(b < a for a, b in zip(vals, vals[1:])):
            continue  # any release breaks the monotonic-growth signature
        growth = vals[-1] - vals[0]
        if growth < config.leak_min_growth_bytes:
            continue
        findings.append({
            "anomaly": "leak", "process": process,
            "samples": len(vals),
            "first_bytes": vals[0], "last_bytes": vals[-1],
            "growth_bytes": growth,
            "threshold_bytes": int(config.leak_min_growth_bytes),
            "ts": samples[-1].get("ts")})
    return findings


def detect_headroom(timeline: Timeline,
                    config: AnomalyConfig = AnomalyConfig()) -> list:
    """HBM headroom breaches: any device whose backend-reported
    `bytes_in_use / bytes_limit` passed the watermark (off-TPU runs
    carry no `bytes_limit` and never flag here — live-array accounting
    has no ceiling to breach). One finding per (process, device): the
    FIRST breach is the evidence; repeats add nothing."""
    findings = []
    seen: set = set()
    for ev in timeline.of_kind("memory"):
        process = ev.get("process", "main")
        for dev_id, stats in (ev.get("devices") or {}).items():
            limit = int(stats.get("bytes_limit", 0) or 0)
            in_use = int(stats.get("bytes_in_use", 0) or 0)
            if limit <= 0:
                continue
            ratio = in_use / limit
            if ratio <= config.headroom_watermark:
                continue
            key = (process, dev_id)
            if key in seen:
                continue
            seen.add(key)
            findings.append({
                "anomaly": "headroom", "process": process,
                "device": dev_id, "bytes_in_use": in_use,
                "bytes_limit": limit, "ratio": round(ratio, 4),
                "watermark": config.headroom_watermark,
                "ts": ev.get("ts")})
    return findings


def detect_cost_drift(timeline: Timeline,
                      config: AnomalyConfig = AnomalyConfig()) -> list:
    """Cost-model drift: the placement search's predicted per-device
    memory vs a measured peak, outside the documented factor band.

    Two evidence paths. Preferred: typed `cost_drift` events (the
    costbook's reconcile loop already computed predicted/measured/ratio
    — each event carries its own `factor`, falling back to the config's
    band). Fallback, for timelines where nothing reconciled live: join
    each (process, run)'s LAST `placement_search.winner_memory_bytes`
    against the max measured bytes from that same (process, run)'s
    later `memory` events."""
    findings = []
    reconciled: set = set()
    for ev in timeline.of_kind("cost_drift"):
        process = ev.get("process", "main")
        reconciled.add((process, ev.get("run")))
        ratio = float(ev.get("ratio", 0.0) or 0.0)
        factor = float(ev.get("factor", 0) or config.cost_drift_factor)
        if ratio <= 0 or factor <= 1:
            continue
        if 1.0 / factor <= ratio <= factor:
            continue
        findings.append({
            "anomaly": "cost_drift", "process": process,
            "predicted_bytes": ev.get("predicted_bytes"),
            "measured_bytes": ev.get("measured_bytes"),
            "ratio": round(ratio, 4), "factor": factor,
            "source": ev.get("source", "event"),
            "ts": ev.get("ts")})
    # fallback join, scoped per (process, run) — a shared bench log
    # holds many modes' runs and a search in one must never reconcile
    # against another's memory samples
    searches: dict = {}
    for ev in timeline.of_kind("placement_search"):
        predicted = int(ev.get("winner_memory_bytes", 0) or 0)
        if predicted > 0:
            searches[(ev.get("process", "main"), ev.get("run"))] = ev
    for scope, search in searches.items():
        if scope in reconciled:
            continue
        process, run = scope
        measured = 0
        last_ts = None
        for ev in timeline.of_kind("memory"):
            if (ev.get("process", "main"), ev.get("run")) != scope:
                continue
            if float(ev.get("ts", 0.0)) < float(search.get("ts", 0.0)):
                continue
            per_dev = [int(s.get("peak_bytes_in_use", 0) or 0)
                       for s in (ev.get("devices") or {}).values()]
            cand = max(per_dev) if any(per_dev) \
                else int(ev.get("live_array_bytes", 0) or 0)
            if cand > measured:
                measured = cand
                last_ts = ev.get("ts")
        if measured <= 0:
            continue
        predicted = int(search.get("winner_memory_bytes", 0) or 0)
        ratio = measured / predicted
        factor = config.cost_drift_factor
        if 1.0 / factor <= ratio <= factor:
            continue
        findings.append({
            "anomaly": "cost_drift", "process": process, "run": run,
            "predicted_bytes": predicted, "measured_bytes": measured,
            "ratio": round(ratio, 4), "factor": factor,
            "source": "join", "ts": last_ts})
    return findings


def detect_anomalies(timeline: Timeline,
                     config: AnomalyConfig = AnomalyConfig()) -> list:
    """All detectors, in timeline order of evidence. Each finding is a
    typed dict whose `anomaly` field names the kind — the same payload
    `Recorder.anomaly` puts on a live record."""
    return (detect_stragglers(timeline, config)
            + detect_retraces(timeline)
            + detect_input_wait_spikes(timeline, config)
            + detect_queue_spikes(timeline, config)
            + detect_leaks(timeline, config)
            + detect_headroom(timeline, config)
            + detect_cost_drift(timeline, config))


# -------------------------------------------------------- live watching

class StragglerWatch:
    """Incremental straggler detection for a LIVE fleet — the elastic
    supervisor's heartbeat-path consumer. Each `poll()` re-reads the
    fleet's telemetry shards (small, append-only files), runs
    `detect_stragglers`, and emits each NEW finding exactly once as a
    typed `anomaly` event through the recorder — so a skewing or hung
    worker is in the supervisor's journal while the generation is still
    running, not just after the launcher reaps it."""

    def __init__(self, path: str, recorder=None,
                 config: AnomalyConfig = AnomalyConfig(),
                 min_interval_s: float = 1.0, clock=None):
        import time as _time

        self.path = path
        self.config = config
        self.min_interval_s = min_interval_s
        self._clock = clock or _time.monotonic
        self._last_poll = float("-inf")
        self._seen: set = set()
        self.findings: list = []
        if recorder is None:
            from deeplearning4j_tpu_torch.telemetry.recorder import get_default
            recorder = get_default()
        self.recorder = recorder

    def poll(self, force: bool = False) -> list:
        now = self._clock()
        if not force and now - self._last_poll < self.min_interval_s:
            return []
        self._last_poll = now
        try:
            timeline = load_timeline(self.path)
        except (FileNotFoundError, OSError):
            return []  # no shards yet: the fleet has not started writing
        fresh = []
        for f in detect_stragglers(timeline, self.config):
            key = (f.get("mode"), f.get("process"), f.get("step"))
            if key in self._seen:
                continue
            self._seen.add(key)
            self.findings.append(f)
            fresh.append(f)
            payload = {k: v for k, v in f.items() if k != "anomaly"}
            self.recorder.anomaly(f["anomaly"], **payload)
        return fresh


class MemoryWatch:
    """Incremental memory-anomaly detection for a LIVE fleet — the
    elastic supervisor and fleet autoscaler consume this exactly the
    way they consume `StragglerWatch`: each `poll()` re-reads the
    telemetry shards, runs the leak / headroom / cost-drift detectors,
    and emits each NEW finding exactly once as a typed `anomaly` event
    — so a leaking or HBM-starved worker is in the journal while the
    run is still alive. Its detectors read `memory` and `cost_drift`
    events (telemetry/memstat.py, telemetry/costbook.py)."""

    def __init__(self, path: str, recorder=None,
                 config: AnomalyConfig = AnomalyConfig(),
                 min_interval_s: float = 1.0, clock=None):
        import time as _time

        self.path = path
        self.config = config
        self.min_interval_s = min_interval_s
        self._clock = clock or _time.monotonic
        self._last_poll = float("-inf")
        self._seen: set = set()
        self.findings: list = []
        if recorder is None:
            from deeplearning4j_tpu_torch.telemetry.recorder import get_default
            recorder = get_default()
        self.recorder = recorder

    @staticmethod
    def _key(f: dict) -> tuple:
        kind = f.get("anomaly")
        if kind == "headroom":
            return (kind, f.get("process"), f.get("device"))
        if kind == "cost_drift":
            return (kind, f.get("process"), f.get("run"),
                    f.get("predicted_bytes"))
        return (kind, f.get("process"))  # leak: one per process

    def poll(self, force: bool = False) -> list:
        now = self._clock()
        if not force and now - self._last_poll < self.min_interval_s:
            return []
        self._last_poll = now
        try:
            timeline = load_timeline(self.path)
        except (FileNotFoundError, OSError):
            return []
        found = (detect_leaks(timeline, self.config)
                 + detect_headroom(timeline, self.config)
                 + detect_cost_drift(timeline, self.config))
        fresh = []
        for f in found:
            key = self._key(f)
            if key in self._seen:
                continue
            self._seen.add(key)
            self.findings.append(f)
            fresh.append(f)
            payload = {k: v for k, v in f.items() if k != "anomaly"}
            self.recorder.anomaly(f["anomaly"], **payload)
        return fresh


# ---------------------------------------------------------------- export

def to_perfetto(timeline: Timeline) -> dict:
    """Chrome trace-event JSON (the Perfetto UI's legacy-but-universal
    format): spans and requests become complete ("X") slices placed at
    their START time (`ts - seconds`), everything else an instant
    ("i"). One pid per process, one tid per replica (0 when absent),
    process_name metadata rows so the Perfetto tracks are labelled."""
    events = []
    pid_of = {p: i for i, p in enumerate(timeline.processes)}
    if not pid_of:
        return {"traceEvents": [], "displayTimeUnit": "ms"}
    def start_of(ev) -> float:
        # spans and requests stamp COMPLETION time; their slice begins
        # `seconds`/`total_s` earlier — the base must cover the earliest
        # start or the first slice would sit at a negative timestamp
        ts = float(ev.get("ts", 0.0))
        if ev.get("event") == "span" and "seconds" in ev:
            return ts - float(ev["seconds"])
        if ev.get("event") == "request" and "total_s" in ev:
            return ts - float(ev["total_s"])
        return ts

    base = min((start_of(ev) for ev in timeline.events), default=0.0)

    def us(ts: float) -> float:
        return round(1e6 * (ts - base), 1)

    for p, pid in pid_of.items():
        events.append({"name": "process_name", "ph": "M", "pid": pid,
                       "tid": 0, "args": {"name": f"telemetry:{p}"}})
    for ev in timeline.events:
        pid = pid_of[ev.get("process", "main")]
        tid = int(ev.get("replica", 0) or 0)
        ts = float(ev.get("ts", 0.0))
        args = {k: v for k, v in ev.items()
                if k not in ("event", "ts", "process")
                and isinstance(v, (str, int, float, bool))}
        kind = ev.get("event")
        if kind == "span" and "seconds" in ev:
            dur = max(0.0, 1e6 * float(ev["seconds"]))
            events.append({"name": str(ev.get("name", "span")), "ph": "X",
                           "pid": pid, "tid": tid,
                           "ts": us(ts - float(ev["seconds"])),
                           "dur": round(dur, 1), "args": args})
        elif kind == "request" and "total_s" in ev:
            dur = max(0.0, 1e6 * float(ev["total_s"]))
            events.append({"name": f"request:{ev.get('id', '?')}",
                           "ph": "X", "pid": pid, "tid": tid,
                           "ts": us(ts - float(ev["total_s"])),
                           "dur": round(dur, 1), "args": args})
        elif kind == "memory":
            # counter tracks: live bytes + the ledger breakdown render
            # as stacked area series in the Perfetto UI
            series = {"live_array_bytes":
                      int(ev.get("live_array_bytes", 0) or 0)}
            for subsystem, nbytes in (ev.get("ledger") or {}).items():
                series[f"ledger_{subsystem}"] = int(nbytes or 0)
            events.append({"name": "device_memory", "ph": "C",
                           "pid": pid, "tid": 0, "ts": us(ts),
                           "args": series})
        else:
            events.append({"name": str(kind), "ph": "i", "pid": pid,
                           "tid": tid, "ts": us(ts), "s": "p",
                           "args": args})
    return {"traceEvents": events, "displayTimeUnit": "ms"}


# --------------------------------------------------------- memory report

def memory_report(timeline: Timeline) -> dict:
    """The `tracetool mem` report: per-process memory timeline summary
    (sample count, first/last/peak live bytes, the last ledger
    breakdown, device limits when the backend reported them) plus the
    compiled-cost book (per-entry flops / bytes accessed / peak temp
    from `cost` events) and every `cost_drift` reconciliation."""
    processes = {}
    for process, samples in sorted(_memory_samples(timeline).items()):
        vals = [int(ev.get("live_array_bytes", 0) or 0) for ev in samples]
        last = samples[-1]
        limits = {}
        for ev in samples:
            for dev_id, stats in (ev.get("devices") or {}).items():
                if stats.get("bytes_limit"):
                    limits[dev_id] = int(stats["bytes_limit"])
        processes[process] = {
            "samples": len(samples),
            "first_bytes": vals[0], "last_bytes": vals[-1],
            "peak_bytes": max(vals),
            "growth_bytes": vals[-1] - vals[0],
            "ledger": dict(last.get("ledger") or {}),
            "sources": sorted({str(ev.get("source", "?"))
                               for ev in samples}),
            "device_limits": limits,
        }
    book = {}
    for ev in timeline.of_kind("cost"):
        key = f"{ev.get('entry', '?')}::{ev.get('shape')}"
        book[key] = {k: ev[k] for k in
                     ("flops", "bytes_accessed", "peak_temp_bytes",
                      "argument_bytes", "output_bytes") if k in ev}
    drifts = [{k: ev.get(k) for k in
               ("process", "predicted_bytes", "measured_bytes",
                "ratio", "factor", "source")}
              for ev in timeline.of_kind("cost_drift")]
    return {"processes": processes, "cost_book": book,
            "cost_drift": drifts}


# ------------------------------------------------------- TRACE artifacts

def metric_lines(timeline: Timeline, anomalies: list,
                 prefix: str = "trace") -> list:
    """Benchdiff-diffable TRACE rows: per-(process, span) p50/p99 as
    lower-is-better latency rows, plus `anomaly_count` and
    `straggler_skew_ms` which regress on ANY increase (tools/
    benchdiff.py — an anomaly appearing is never an improvement)."""
    lines = []
    stats = span_stats(timeline)
    for (process, name), row in sorted(stats.items()):
        for q in ("p50", "p99"):
            lines.append({
                "metric": f"{prefix}_span_{q}_ms::{process}::{name}",
                "value": row[f"{q}_ms"], "unit": "ms",
                "lower_is_better": True, "count": row["count"]})
    skews = [f.get("skew_ms", 0.0) for f in anomalies
             if f.get("anomaly") == "straggler"]
    by_kind: dict = {}
    for f in anomalies:
        by_kind[f["anomaly"]] = by_kind.get(f["anomaly"], 0) + 1
    lines.append({"metric": f"{prefix}_anomaly_count",
                  "value": len(anomalies), "unit": "count",
                  "lower_is_better": True, **{f"n_{k}": v
                                              for k, v in by_kind.items()}})
    lines.append({"metric": f"{prefix}_straggler_skew_ms",
                  "value": round(max(skews), 3) if skews else 0.0,
                  "unit": "ms", "lower_is_better": True})
    # memory rows: leak_count / cost_drift_ratio regress on ANY increase
    # (the retrace rise-from-zero rule — a leak appearing is never an
    # improvement); hbm_peak_bytes rides only when samples exist, so
    # memory-less timelines keep their row set unchanged
    lines.append({"metric": f"{prefix}_leak_count",
                  "value": sum(1 for f in anomalies
                               if f.get("anomaly") == "leak"),
                  "unit": "count", "lower_is_better": True})
    drift_ratios = [max(float(f.get("ratio", 0.0) or 0.0),
                        (1.0 / float(f["ratio"]))
                        if float(f.get("ratio", 0.0) or 0.0) > 0 else 0.0)
                    for f in anomalies
                    if f.get("anomaly") == "cost_drift"]
    lines.append({"metric": f"{prefix}_cost_drift_ratio",
                  "value": round(max(drift_ratios), 4) if drift_ratios
                  else 0.0,
                  "unit": "ratio", "lower_is_better": True})
    mem = [int(ev.get("live_array_bytes", 0) or 0)
           for ev in timeline.of_kind("memory")]
    if mem:
        lines.append({"metric": f"{prefix}_hbm_peak_bytes",
                      "value": max(mem), "unit": "bytes",
                      "lower_is_better": True, "samples": len(mem)})
    return lines
