"""Bench-artifact parsing and the truncation-proof summary line. A copy
of the JAX package's telemetry/artifact.py, which the port may not
import.

* `build_summary` folds every gate field into the one summary line
  an artifact ends with, under `gates[<metric>]`, plus the
  `regressed_metrics` name list — so a tail cut that spares only the
  final line loses no gate decision.
* `parse_metric_lines` + `merge_summary` reconstruct per-metric rows
  from whatever survived: full JSONL, a `{"tail": ...}` capture wrapper,
  a telemetry JSONL log (`metric` events carry the same dict), or a
  bare summary line.

The port's traffic replays (serving/replay.py `write_artifact`) end
their artifacts with this summary. Pure stdlib.
"""

from __future__ import annotations

import json

# Per-metric fields that carry a GATE decision (or the context needed to
# audit one). Everything listed here survives truncation via the summary
# line's `gates` object.
GATE_FIELDS = (
    "quality_ratio_vs_host", "quality_gate_min_ratio",
    "gate_scale", "vs_dense_ratio", "ratio_floor",
    "mfu_vs_achievable", "mfu_executed",
    "ratio_median", "ratio_spread",
)

# Summary-line bookkeeping keys that are NOT metric names (parsers must
# skip them when recovering per-metric rows) — includes telemetry event
# envelope keys so a telemetry log parses identically.
SUMMARY_BOOKKEEPING = {"metric", "value", "unit", "vs_baseline",
                       "regressions", "regressed_metrics", "gates",
                       "event", "ts", "run", "seq"}


def read_artifact_text(path: str) -> str:
    """File -> raw metric-line text. Accepts bench stdout (JSONL),
    a telemetry log, or a capture's wrapper object whose `tail` field
    holds the captured stdout.

    Sharded inputs: a multi-process fleet leaves `<path>.pN` shards and
    often NO unsuffixed file (telemetry/recorder._process_scoped) —
    when `path` is absent, the shards are read and concatenated in
    process order instead (JSONL concatenation is parse-equivalent to
    one shared log; the committed `telemetry_bench.jsonl.p0/.p1` pair
    is the fixture)."""
    try:
        with open(path) as fh:
            text = fh.read()
    except FileNotFoundError:
        text = _read_shards(path)
    try:
        wrapper = json.loads(text)
        if isinstance(wrapper, dict) and "tail" in wrapper:
            return wrapper["tail"]
    except json.JSONDecodeError:
        pass
    return text


def _read_shards(path: str) -> str:
    """Concatenated `<path>.p*` shard text, numeric process order.
    Raises the original FileNotFoundError shape when no shards exist
    either."""
    import glob as _glob
    import re as _re

    shards = []
    for cand in _glob.glob(_glob.escape(path) + ".p*"):
        m = _re.match(r"\.p(\d+)$", cand[len(path):])
        if m:
            shards.append((int(m.group(1)), cand))
    if not shards:
        raise FileNotFoundError(
            f"no artifact at {path} (and no {path}.p* shards)")
    parts = []
    for _, shard in sorted(shards):
        with open(shard) as fh:
            text = fh.read()
        parts.append(text if text.endswith("\n") or not text
                     else text + "\n")
    return "".join(parts)


def parse_metric_lines(text: str):
    """-> ({metric: line}, summary_line_or_None). Non-JSON lines, partial
    (truncated) lines, and non-metric telemetry events are skipped; a
    telemetry `metric` event parses as the bench line it carries."""
    lines: dict[str, dict] = {}
    summary = None
    for raw in text.splitlines():
        raw = raw.strip()
        if not raw.startswith("{"):
            continue
        try:
            line = json.loads(raw)
        except json.JSONDecodeError:
            continue
        if line.get("event") not in (None, "metric"):
            continue
        if line.get("metric") == "summary":
            summary = line
        elif "metric" in line:
            lines[line["metric"]] = line
    return lines, summary


def merge_summary(lines: dict, summary: dict | None) -> dict:
    """Reconstruct truncated rows from the summary line, in place.

    Numeric summary keys become bare `{value, from_summary}` rows for
    metrics the tail lost; `gates[<metric>]` fields and the
    `regressed_metrics` flags merge non-destructively (a surviving
    detail line always wins over its summary restatement)."""
    if not summary:
        return lines
    for key, val in summary.items():
        if key not in SUMMARY_BOOKKEEPING and key not in lines \
                and isinstance(val, (int, float)) \
                and not isinstance(val, bool):
            lines[key] = {"metric": key, "value": val, "from_summary": True}
    for metric, gate in (summary.get("gates") or {}).items():
        row = lines.setdefault(metric, {"metric": metric,
                                        "from_summary": True})
        for k, v in gate.items():
            row.setdefault(k, v)
    for metric in summary.get("regressed_metrics") or []:
        row = lines.setdefault(metric, {"metric": metric,
                                        "from_summary": True})
        row.setdefault("regression", True)
    return lines


def load(path: str) -> dict:
    """Artifact path -> {metric: line} with summary recovery applied —
    the one loader both tools share."""
    lines, summary = parse_metric_lines(read_artifact_text(path))
    return merge_summary(lines, summary)


def build_summary(collected) -> dict:
    """Fold a run's metric lines (dicts or raw JSON strings) into the
    single gate-carrying summary line. An artifact ends with this line
    so a tail capture always keeps it; `merge_summary` is its inverse."""
    summary = {"metric": "summary", "value": None, "unit": "",
               "vs_baseline": None, "regressions": 0,
               "regressed_metrics": [], "gates": {}}
    for item in collected:
        if isinstance(item, str):
            try:
                line = json.loads(item)
            except json.JSONDecodeError:
                continue
        else:
            line = item
        metric = line.get("metric")
        if not metric or metric == "summary":
            continue
        if isinstance(line.get("value"), (int, float)):
            summary[metric] = line["value"]
        if line.get("regression"):
            summary["regressions"] += 1
            summary["regressed_metrics"].append(metric)
        gate = {k: line[k] for k in GATE_FIELDS if k in line}
        if line.get("regression"):
            gate["regression"] = True
        if gate:
            summary["gates"][metric] = gate
        if str(metric).startswith("transformer_lm_mfu"):
            # headline fields: the north-star MFU metric, so a parser
            # taking the LAST line still sees a well-formed metric
            summary["value"] = line.get("value")
            summary["unit"] = line.get("unit", "")
            summary["vs_baseline"] = line.get("vs_baseline")
    return summary
