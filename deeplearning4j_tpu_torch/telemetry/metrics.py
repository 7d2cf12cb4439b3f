"""Live metrics: a pure-stdlib rolling-histogram registry rendering
Prometheus text exposition format (version 0.0.4). A copy of the JAX
package's telemetry/metrics.py, which the port may not import.

The serving server's GET /metrics (serving/server.py) is backed by one
`MetricsRegistry`: counters and gauges for the fleet state scraped at
collection time (queue depth, page-pool occupancy, weight generation,
per-replica liveness), and `RollingHistogram`s fed LIVE from the
telemetry event stream (`Recorder.add_sink`) for request latency — so
the scrape path costs a lock and a render, never a device sync or a
log parse.

"Rolling" means two things at once, both Prometheus-legal:

* the `_bucket`/`_sum`/`_count` series are CUMULATIVE (the exposition
  contract — rate() and histogram_quantile() work unmodified);
* a bounded ring of recent observations backs the registry's own
  `<name>_p50`/`<name>_p99` gauges, the live quantiles the autoscaler
  and a human under pager duress read directly without a PromQL
  engine in the loop.

Everything here is thread-safe under one registry lock; `render()` is
the only reader and every writer is O(#buckets).
"""

from __future__ import annotations

import threading
from collections import deque

CONTENT_TYPE = "text/plain; version=0.0.4; charset=utf-8"

# default latency buckets (seconds): sub-ms to 10s, the serving envelope
DEFAULT_BUCKETS = (0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25,
                   0.5, 1.0, 2.5, 5.0, 10.0)

DEFAULT_WINDOW = 512


def _fmt(v) -> str:
    if v == float("inf"):
        return "+Inf"
    f = float(v)
    return repr(int(f)) if f == int(f) else repr(f)


def _labels(labels: dict) -> str:
    if not labels:
        return ""
    inner = ",".join(f'{k}="{v}"' for k, v in sorted(labels.items()))
    return "{" + inner + "}"


class Counter:
    """Monotonic counter with optional labels (one child per label
    set)."""

    def __init__(self, name: str, help_text: str):
        self.name = name
        self.help = help_text
        self._values: dict = {}

    def inc(self, amount: float = 1.0, **labels) -> None:
        key = tuple(sorted(labels.items()))
        self._values[key] = self._values.get(key, 0.0) + amount

    def render(self) -> list:
        lines = [f"# HELP {self.name} {self.help}",
                 f"# TYPE {self.name} counter"]
        for key, v in sorted(self._values.items()):
            lines.append(f"{self.name}{_labels(dict(key))} {_fmt(v)}")
        if not self._values:
            lines.append(f"{self.name} 0")
        return lines


class Gauge:
    """Point-in-time value with optional labels."""

    def __init__(self, name: str, help_text: str):
        self.name = name
        self.help = help_text
        self._values: dict = {}

    def set(self, value: float, **labels) -> None:
        self._values[tuple(sorted(labels.items()))] = float(value)

    def clear(self) -> None:
        self._values.clear()

    def render(self) -> list:
        lines = [f"# HELP {self.name} {self.help}",
                 f"# TYPE {self.name} gauge"]
        for key, v in sorted(self._values.items()):
            lines.append(f"{self.name}{_labels(dict(key))} {_fmt(v)}")
        return lines


class RollingHistogram:
    """Cumulative Prometheus histogram + a bounded ring of recent
    observations for live p50/p99 gauges."""

    def __init__(self, name: str, help_text: str,
                 buckets=DEFAULT_BUCKETS, window: int = DEFAULT_WINDOW):
        self.name = name
        self.help = help_text
        self.buckets = tuple(sorted(buckets))
        self._counts = [0] * (len(self.buckets) + 1)  # +Inf tail
        self._sum = 0.0
        self._count = 0
        self._window: deque = deque(maxlen=window)

    def observe(self, value: float) -> None:
        v = float(value)
        self._sum += v
        self._count += 1
        self._window.append(v)
        for i, edge in enumerate(self.buckets):
            if v <= edge:
                self._counts[i] += 1
                return
        self._counts[-1] += 1

    def quantile(self, q: float) -> float:
        """Exact quantile over the rolling window (not the cumulative
        buckets) — the live signal the p50/p99 gauges expose."""
        if not self._window:
            return 0.0
        vals = sorted(self._window)
        k = min(len(vals) - 1,
                max(0, int(round(q / 100.0 * (len(vals) - 1)))))
        return vals[k]

    def render(self) -> list:
        lines = [f"# HELP {self.name} {self.help}",
                 f"# TYPE {self.name} histogram"]
        cum = 0
        for i, edge in enumerate(self.buckets):
            cum += self._counts[i]
            lines.append(f'{self.name}_bucket{{le="{_fmt(edge)}"}} {cum}')
        cum += self._counts[-1]
        lines.append(f'{self.name}_bucket{{le="+Inf"}} {cum}')
        lines.append(f"{self.name}_sum {_fmt(round(self._sum, 9))}")
        lines.append(f"{self.name}_count {self._count}")
        for q, suffix in ((50, "p50"), (99, "p99")):
            lines.append(f"# HELP {self.name}_{suffix} rolling window "
                         f"quantile of {self.name}")
            lines.append(f"# TYPE {self.name}_{suffix} gauge")
            lines.append(f"{self.name}_{suffix} "
                         f"{_fmt(round(self.quantile(q), 9))}")
        return lines


class MetricsRegistry:
    """Thread-safe metric set + scrape-time collectors. `render()` first
    runs every registered collector (the engine-state scrape: queue
    depth, pool occupancy, replica liveness) with NO lock held — a
    collector reaches into engine/batcher/pool locks, and calling it
    under `_lock` couples this lock to all of theirs (the G026/D002
    fan-out-under-lock shape) — then renders every metric in
    registration order under the lock."""

    def __init__(self):
        self._lock = threading.Lock()
        self._metrics: list = []
        self._collectors: list = []

    def register(self, metric):
        with self._lock:
            self._metrics.append(metric)
        return metric

    def counter(self, name, help_text) -> Counter:
        return self.register(Counter(name, help_text))

    def gauge(self, name, help_text) -> Gauge:
        return self.register(Gauge(name, help_text))

    def histogram(self, name, help_text, buckets=DEFAULT_BUCKETS,
                  window: int = DEFAULT_WINDOW) -> RollingHistogram:
        return self.register(RollingHistogram(name, help_text, buckets,
                                              window))

    def add_collector(self, fn) -> None:
        """`fn()` runs at every scrape, before rendering — set gauges
        from live state there. A collector failure is contained (the
        scrape must answer under incident conditions)."""
        with self._lock:
            self._collectors.append(fn)

    def observe(self, metric: RollingHistogram, value: float) -> None:
        with self._lock:
            metric.observe(value)

    def inc(self, metric: Counter, amount: float = 1.0, **labels) -> None:
        with self._lock:
            metric.inc(amount, **labels)

    def render(self) -> str:
        with self._lock:
            collectors = list(self._collectors)
        for fn in collectors:
            try:
                fn()
            except Exception:
                pass
        with self._lock:
            lines = []
            for m in self._metrics:
                lines.extend(m.render())
        return "\n".join(lines) + "\n"


def parse_exposition(text: str) -> dict:
    """Exposition text -> {metric_or_series: float} — the round-trip
    half the tests (and any stdlib-only scraper) use. `# HELP`/`# TYPE`
    lines are skipped; label sets stay part of the series key."""
    out = {}
    for line in text.splitlines():
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        name, _, value = line.rpartition(" ")
        try:
            out[name] = float(value.replace("+Inf", "inf"))
        except ValueError:
            continue
    return out
