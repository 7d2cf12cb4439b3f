"""Live in-browser training views.

The reference UI *renders* — histogram/weights pages fed by
HistogramIterationListener (ui/weights/HistogramIterationListener.java:206),
the flow topology view (ui/flow/FlowIterationListener.java +
beans/ModelInfo.java), activation and tsne pages served by UiServer.java
with bundled JS assets. Here the same listener payloads are turned into
the declarative chart components (ui/components.py) and rendered by the
self-contained SVG renderer (ui/standalone.py) — a browser pointed at
/weights, /flow, /activations or /tsne sees live charts (auto-refresh),
with zero external JS dependencies.

The port's copy of the JAX package's ui/views.py (numpy on the host, the
same results on the same input); the port imports nothing of that package.
"""

from __future__ import annotations

import json
from typing import Optional

from deeplearning4j_tpu_torch.ui.components import (
    ChartHistogram,
    ChartLine,
    ChartScatter,
    ComponentDiv,
    ComponentTable,
    ComponentText,
    DecoratorAccordion,
)
from deeplearning4j_tpu_torch.ui.standalone import StaticPageUtil

REFRESH_SECONDS = 3


def _fmt_score(payload: dict) -> str:
    s = payload.get("score")
    return f"{s:.6g}" if isinstance(s, (int, float)) else "n/a"


def _score_chart(history) -> Optional[ChartLine]:
    pts = [(h.get("iteration", i), h.get("score"))
           for i, h in enumerate(history) if h.get("score") is not None]
    if not pts:
        return None
    c = ChartLine(title="score")
    c.add_series("score", [p[0] for p in pts], [p[1] for p in pts])
    return c


def weights_page(payload: Optional[dict], history, sid: str) -> str:
    """Param/gradient histogram view (HistogramIterationListener data)."""
    comps = []
    score = _score_chart(history)
    if score is not None:
        comps.append(score)
    if not payload:
        comps.append(ComponentText(
            text="no weights data yet — attach a HistogramIterationListener"))
    else:
        comps.append(ComponentText(
            text=f"iteration {payload.get('iteration')}, "
                 f"score {_fmt_score(payload)}"))
        for pname in sorted(payload.get("parameters", {})):
            h = payload["parameters"][pname]
            chart = ChartHistogram(title=pname)
            bins, counts = h.get("bins", []), h.get("counts", [])
            for i, cnt in enumerate(counts):
                chart.add_bin(bins[i], bins[i + 1], cnt)
            comps.append(DecoratorAccordion(
                title=pname, default_collapsed=True, components=[chart]))
    return StaticPageUtil.render_html(
        comps, title=f"weights — session {sid}",
        refresh_seconds=REFRESH_SECONDS)


def flow_page(payload: Optional[dict], history, sid: str) -> str:
    """Network topology view (FlowIterationListener's ModelInfo beans)."""
    comps = []
    if not payload:
        comps.append(ComponentText(
            text="no flow data yet — attach a FlowIterationListener"))
    else:
        comps.append(ComponentText(
            text=f"iteration {payload.get('iteration')}, "
                 f"score {_fmt_score(payload)}"))
        rows = [[str(l.get("index")), l.get("name"),
                 str(l.get("num_params")),
                 ", ".join(l.get("param_names", []))]
                for l in payload.get("layers", [])]
        comps.append(ComponentTable(
            header=["#", "layer", "params", "param names"], content=rows))
        sizes = [l.get("num_params", 0) for l in payload.get("layers", [])]
        if sizes:
            bar = ChartLine(title="parameters per layer")
            bar.add_series("num_params", list(range(len(sizes))),
                           [float(s) for s in sizes])
            comps.append(bar)
    score = _score_chart(history)
    if score is not None:
        comps.append(score)
    return StaticPageUtil.render_html(
        comps, title=f"flow — session {sid}", refresh_seconds=REFRESH_SECONDS)


def activations_page(history, sid: str) -> str:
    """Mean |activation| per layer over iterations
    (ActivationMeanIterationListener data)."""
    comps = []
    if not history:
        comps.append(ComponentText(
            text="no activation data yet — attach an "
                 "ActivationMeanIterationListener"))
    else:
        series = {}
        iters = []
        for h in history:
            iters.append(h.get("iteration", len(iters)))
            for name, v in h.get("activation_means", {}).items():
                series.setdefault(name, []).append(float(v))
        chart = ChartLine(title="mean |activation| per layer")
        for name in sorted(series):
            vals = series[name]
            chart.add_series(name, iters[-len(vals):], vals)
        comps.append(chart)
    return StaticPageUtil.render_html(
        comps, title=f"activations — session {sid}",
        refresh_seconds=REFRESH_SECONDS)


def timeline_page(timeline, anomalies, source: str) -> str:
    """The fleet trace-timeline view: rendered from the
    MERGED per-process telemetry shards (telemetry/trace.py), not a
    listener feed — per-process span lanes, the per-(process, span)
    p50/p99 table, and the anomaly findings table. `timeline` is a
    trace.Timeline, `anomalies` the detect_anomalies findings."""
    from deeplearning4j_tpu_torch.telemetry import trace as trace_mod

    comps = []
    if timeline is None or not timeline.events:
        comps.append(ComponentText(
            text="no telemetry yet — start the UI server with "
                 "telemetry_path= (or set DL4J_TPU_TELEMETRY) and run "
                 "a fleet"))
        return StaticPageUtil.render_html(
            comps, title="fleet timeline",
            refresh_seconds=REFRESH_SECONDS)
    procs = timeline.processes
    comps.append(ComponentText(
        text=f"{len(timeline.events)} events from {len(procs)} "
             f"process(es) [{', '.join(procs)}] — source {source}"))
    # anomaly findings first: the reason a human opens this page
    if anomalies:
        rows = [[f.get("anomaly", ""), str(f.get("process", "")),
                 json.dumps({k: v for k, v in f.items()
                             if k not in ("anomaly", "process")})]
                for f in anomalies]
        comps.append(ComponentTable(
            header=["anomaly", "process", "evidence"], content=rows))
    else:
        comps.append(ComponentText(text="0 anomalies"))
    # span lanes: one scatter series per span name, x = seconds into
    # the run, y = process lane index
    lane = {p: i for i, p in enumerate(procs)}
    base = min(float(ev.get("ts", 0.0)) for ev in timeline.events)
    by_name: dict = {}
    for ev in timeline.spans():
        by_name.setdefault(str(ev.get("name")), []).append(ev)
    top = sorted(by_name, key=lambda n: -len(by_name[n]))[:8]
    chart = ChartScatter(title="span starts by process lane "
                               "(top span kinds)")
    for name in top:
        evs = by_name[name]
        xs = [float(ev.get("ts", 0.0)) - float(ev.get("seconds", 0.0))
              - base for ev in evs]
        ys = [float(lane[ev.get("process", "main")]) for ev in evs]
        chart.add_series(name, xs, ys)
    comps.append(chart)
    stats = trace_mod.span_stats(timeline)
    rows = [[p, n, str(row["count"]), f"{row['p50_ms']:.3f}",
             f"{row['p99_ms']:.3f}", f"{row['max_ms']:.3f}"]
            for (p, n), row in sorted(stats.items())]
    comps.append(DecoratorAccordion(
        title="per-span p50/p99 (ms) per process",
        default_collapsed=False,
        components=[ComponentTable(
            header=["process", "span", "count", "p50_ms", "p99_ms",
                    "max_ms"], content=rows)]))
    return StaticPageUtil.render_html(
        comps, title="fleet timeline", refresh_seconds=REFRESH_SECONDS)


def tsne_page(payload, sid: str) -> str:
    """2-D embedding scatter (tsne/coords data: [[x, y], ...] or
    {"coords": [[x, y], ...], "labels": [...]})."""
    comps = []
    coords = payload
    if isinstance(payload, dict):
        coords = payload.get("coords")
    if not coords:
        comps.append(ComponentText(
            text="no tsne coords yet — POST /tsne/coords?sid=..."))
    else:
        chart = ChartScatter(title="t-SNE embedding")
        chart.add_series("points", [float(p[0]) for p in coords],
                         [float(p[1]) for p in coords])
        comps.append(chart)
    return StaticPageUtil.render_html(
        comps, title=f"tsne — session {sid}", refresh_seconds=REFRESH_SECONDS)
