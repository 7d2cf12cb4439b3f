#!/usr/bin/env python
"""benchdiff for the port — the twin of tools/benchdiff.py, the
bench-artifact regression detector, reading artifacts without JAX.

    python3 port_tools/benchdiff.py OLD NEW
    python3 port_tools/benchdiff.py OLD NEW --threshold 0.05
    python3 port_tools/benchdiff.py OLD NEW --json

Compares two artifacts and names EVERY changed metric with old/new/
delta. It reads whatever the port's `telemetry/artifact.py` parses: a
capture's `{"tail": ...}` wrapper (the committed `BENCH_r*.json`), raw
bench stdout (JSONL), the port's recorder JSONL (`metric` events) and
`port_tools/trafficreplay.py`'s SERVE artifacts, tail-truncated ones
included (their rows are rebuilt from the gate-carrying summary line).
Exit codes: 0 no regression, 1 a regression past the threshold, 2 a
usage error. It imports neither torch nor anything of the JAX package:
the port's telemetry module loads under package stubs.

Kernel tuning tables (deeplearning4j_tpu_torch/ops/tuning_table.json,
`{"version", "entries"}` on both sides) diff entry by entry: every
changed entry is named with its old and new params and its best-timing
delta. A table regresses where an entry's `best_us` grows past the
threshold (timings are lower-is-better), or where `best_us` exceeds the
entry's own `default_us` (port_tools/kerneltune.py never writes one).

Metrics are higher-is-better, save the rows the JAX tool inverts:
a line carrying `lower_is_better: true`, and names that match the
latency, bytes and count rules below (`*_p50_ms`, `*_ms`, `*_us`,
`*_ttft_*`, `*recompiles`, `*occupancy`, `*failed_requests`, the PLAN,
TRACE, memory and embedding rows). These regress when they GROW past
the threshold, and a count rising from 0 always regresses (a retrace,
a leak, an anomaly). Also a regression: a `regression: true` flag new
in NEW, and a gated quality ratio falling below its floor. A new line
carrying `gate_scale` (a measured throttle) widens the allowed drop by
that throttle.
"""

from __future__ import annotations

import argparse
import importlib
import json
import os
import re
import sys
import types

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

DEFAULT_THRESHOLD = 0.10

# Serving latency metrics are LOWER-is-better: their lines carry
# `lower_is_better: true` (serving/replay.py), and the name pattern
# covers rows reconstructed from a summary line (which keeps only the
# value) — p50/p99/_ms latency and retrace counts from SERVE artifacts,
# plus RESHARD artifact rows (cli reshard dry run): bytes_moved /
# bytes_lower_bound / plan-time _us growth is the regression direction,
# INPUT artifact rows (bench input_pipeline): input_wait stall
# percentiles growing past threshold is the starvation regression,
# and FLEET rows (trafficreplay --fleet, SERVE_r03): swap_ms /
# respawn_ms ride the _ms rule, autoscale occupancy the occupancy rule,
# and failed_requests growing is dropped traffic — never an improvement.
# SPECULATIVE rows (SERVE_r04) ride the _us rule (sample_us /
# draft_overhead_us) and add _mismatches: the parity gates count greedy
# token-stream divergences vs the baseline arm — while
# accepted_tokens_per_step stays higher-is-better (no pattern match).
# MEM/COST rows (bench.py _memory_rows, tracetool TRACE artifacts,
# PLAN plan_measured_bytes) are byte headlines: hbm_peak_bytes /
# mem_*_bytes / peak_temp_bytes growing is a memory regression —
# while mfu_live stays higher-is-better (no pattern match).
_LOWER_IS_BETTER_RE = re.compile(
    r"(_p\d+_ms$|_ms$|latency|recompiles|bytes_moved$|bytes_lower_bound$"
    r"|_us$|_ttft_|occupancy|input_wait|failed_requests$|_mismatches$"
    r"|plan_predicted|plan_winner|plan_score|plan_measured"
    r"|rank_violations$|anomaly_count$|trace_span_"
    r"|hbm_peak_bytes|mem_\w*_bytes|peak_temp_bytes|leak_count"
    r"|cost_drift_ratio|ep_gather_bytes)")

# leak_count and cost_drift_ratio regress on ANY increase (below): a
# run that introduces its FIRST leak or its first out-of-band
# cost-model drift moved 0 -> n, which a percentage threshold on a
# zero baseline would wave through — the retrace rise-from-zero rule.

# Metrics where ANY growth regresses regardless of threshold: a
# predicted-vs-measured rank violation (PLAN artifacts, bench.py
# placement_search) means the cost model confidently ordered a pair
# against the measurement — like a retrace count, there is no
# acceptable increase. TRACE artifacts add the detector rows: one new
# anomaly, or any growth in the fleet's step-completion skew, is a
# health regression however small the percentage. Parity mismatches
# (SERVE_r04 speculative/quantized arms) are the same class: greedy
# output is bit-identical by construction, so a single divergence is a
# correctness break, not a tolerable drift.
_ALWAYS_REGRESS_RE = re.compile(
    r"(rank_violations$|anomaly_count$|straggler_skew_ms$"
    r"|_parity_mismatches$|leak_count$|cost_drift_ratio)")


def _lower_is_better(metric: str, old: dict, new: dict) -> bool:
    if old.get("lower_is_better") or new.get("lower_is_better"):
        return True
    return bool(_LOWER_IS_BETTER_RE.search(str(metric)))

# gate fields that are themselves higher-is-better measurements worth
# diffing (context fields like gate_scale/floors are reported, not judged)
_JUDGED_GATE_FIELDS = ("quality_ratio_vs_host", "vs_dense_ratio",
                       "mfu_vs_achievable", "mfu_executed")
_GATED_PAIRS = (("quality_ratio_vs_host", "quality_gate_min_ratio"),
                ("vs_dense_ratio", "ratio_floor"))


def _artifact_mod():
    """Import the port's telemetry.artifact without the package root
    (which pulls in torch and the whole nn stack): stub packages whose
    path is the port's directories, as port_tools/tracetool.py does; a
    fully imported real package (the test environment) is left alone."""
    sys.path.insert(0, ROOT)
    for name in ("deeplearning4j_tpu_torch",
                 "deeplearning4j_tpu_torch.telemetry"):
        if name not in sys.modules:
            mod = types.ModuleType(name)
            mod.__path__ = [os.path.join(ROOT, *name.split("."))]
            sys.modules[name] = mod
    return importlib.import_module(
        "deeplearning4j_tpu_torch.telemetry.artifact")


def _num(line, key):
    v = line.get(key)
    return v if isinstance(v, (int, float)) and not isinstance(v, bool) \
        else None


# ------------------------------------------------------- tuning tables

def load_tuning_table(path: str) -> dict | None:
    """The parsed table when `path` is a kerneltune artifact, else
    None (fall through to the bench-artifact parser)."""
    try:
        with open(path) as fh:
            obj = json.load(fh)
    except (OSError, ValueError):
        return None
    if isinstance(obj, dict) and "version" in obj and \
            isinstance(obj.get("entries"), dict):
        return obj
    return None


def _entry_params(entry: dict) -> dict:
    meta = ("best_us", "default_us", "candidates", "source")
    return {k: v for k, v in entry.items() if k not in meta}


def diff_tables(old: dict, new: dict,
                threshold: float = DEFAULT_THRESHOLD) -> dict:
    """Entry-wise tuning-table diff, same result shape as diff() so
    render()/--json consumers are shared. Timings are lower-is-better:
    best_us GROWING past the threshold is the regression direction, and
    a match-or-beat violation (best_us > default_us in NEW) always
    regresses — kerneltune never writes one."""
    o_e, n_e = old.get("entries", {}), new.get("entries", {})
    regressions, changes = [], []
    added = sorted(k for k in n_e if k not in o_e)
    removed = sorted(k for k in o_e if k not in n_e)
    for key in sorted(set(o_e) & set(n_e)):
        oe, ne = o_e[key], n_e[key]
        op, np_ = _entry_params(oe), _entry_params(ne)
        if op != np_:
            changes.append({"metric": key, "field": "params",
                            "old": op, "new": np_, "delta_pct": None})
        o_us, n_us = _num(oe, "best_us"), _num(ne, "best_us")
        if o_us is not None and n_us is not None and o_us != n_us:
            delta_pct = round(100.0 * (n_us - o_us) / abs(o_us), 2) \
                if o_us else None
            row = {"metric": key, "field": "best_us", "old": o_us,
                   "new": n_us, "delta_pct": delta_pct}
            if o_us > 0 and (n_us - o_us) / o_us > threshold:
                row["reason"] = (f"best_us grew {delta_pct:.1f}% "
                                 f"(> {100 * threshold:.0f}% allowed — "
                                 "timings are lower-is-better)")
                regressions.append(row)
            else:
                changes.append(row)
        n_dflt = _num(ne, "default_us")
        if n_us is not None and n_dflt is not None and n_us > n_dflt:
            regressions.append({
                "metric": key, "field": "best_us", "old": n_dflt,
                "new": n_us, "delta_pct": None,
                "reason": f"match-or-beat violated: best_us {n_us} > "
                          f"default_us {n_dflt}"})
    return {"regressions": regressions, "changes": changes,
            "added": added, "removed": removed}


def diff(old_lines: dict, new_lines: dict,
         threshold: float = DEFAULT_THRESHOLD) -> dict:
    """{metric: line} x2 -> {regressions, changes, added, removed}.

    Every entry in `regressions`/`changes` names the metric and field
    with old/new/delta_pct; `regressions` alone drives the exit code."""
    regressions, changes = [], []
    added = sorted(m for m in new_lines if m not in old_lines
                   and m != "summary")
    removed = sorted(m for m in old_lines if m not in new_lines
                     and m != "summary")
    for metric in sorted(set(old_lines) & set(new_lines) - {"summary"}):
        old, new = old_lines[metric], new_lines[metric]
        gate_scale = _num(new, "gate_scale")
        slack = max(0.0, 1.0 - gate_scale) if gate_scale is not None else 0.0
        lower_better = _lower_is_better(metric, old, new)
        for field in ("value",) + _JUDGED_GATE_FIELDS:
            o, n = _num(old, field), _num(new, field)
            if o is None or n is None or o == n:
                continue
            delta_pct = round(100.0 * (n - o) / abs(o), 2) if o else None
            row = {"metric": metric, "field": field, "old": o, "new": n,
                   "delta_pct": delta_pct}
            if lower_better and field == "value":
                # lower-is-better (SERVE latency/retraces): GROWTH past
                # the threshold is the regression direction; a retrace
                # count rising from 0 always regresses (no ratio exists
                # for a zero base — any retrace means the bucket lattice
                # leaked), and rank-violation counts regress on ANY
                # increase (the placement cost model ordered a
                # confidently-separated pair against the measurement)
                grew_past = ((o > 0 and (n - o) / o > threshold + slack)
                             or (o == 0 and n > 0)
                             or (n > o
                                 and _ALWAYS_REGRESS_RE.search(str(metric))))
                if grew_past:
                    row["reason"] = (
                        f"{field} grew"
                        + (f" {delta_pct:.1f}%" if delta_pct is not None
                           else f" {o} -> {n}")
                        + f" (> {100 * (threshold + slack):.0f}% allowed "
                          "— lower is better)")
                    regressions.append(row)
                else:
                    changes.append(row)
                continue
            dropped_past = (o > 0 and (o - n) / o > threshold + slack)
            if field == "value" and slack and o > 0 and (o - n) / o > threshold:
                row["gate_scale"] = gate_scale
            if dropped_past:
                row["reason"] = (f"{field} fell {-delta_pct:.1f}% "
                                 f"(> {100 * (threshold + slack):.0f}% "
                                 "allowed)")
                regressions.append(row)
            else:
                changes.append(row)
        # PLAN artifacts carry the winning placement as a string field:
        # a changed winner is always NAMED (a change, not a regression —
        # the scores decide regressions)
        o_win, n_win = old.get("winner"), new.get("winner")
        if isinstance(o_win, str) and isinstance(n_win, str) \
                and o_win != n_win:
            changes.append({"metric": metric, "field": "winner",
                            "old": o_win, "new": n_win,
                            "delta_pct": None})
        if new.get("regression") and not old.get("regression"):
            regressions.append({"metric": metric, "field": "regression",
                                "old": False, "new": True, "delta_pct": None,
                                "reason": "regression flag newly set"})
        for ratio_field, floor_field in _GATED_PAIRS:
            r, floor = _num(new, ratio_field), _num(new, floor_field)
            if r is not None and floor is not None and r < floor:
                old_r = _num(old, ratio_field)
                if old_r is None or old_r >= floor:
                    regressions.append({
                        "metric": metric, "field": ratio_field,
                        "old": old_r, "new": r, "delta_pct": None,
                        "reason": f"{ratio_field} {r} below its "
                                  f"{floor_field} {floor}"})
    return {"regressions": regressions, "changes": changes,
            "added": added, "removed": removed}


def render(result: dict, old_name: str, new_name: str,
           threshold: float) -> str:
    out = [f"benchdiff {old_name} -> {new_name} "
           f"(threshold {threshold:.0%})"]
    for row in result["regressions"]:
        out.append(f"REGRESSED {row['metric']}.{row['field']}: "
                   f"{row['old']} -> {row['new']}"
                   + (f" ({row['delta_pct']:+.1f}%)"
                      if row["delta_pct"] is not None else "")
                   + f" — {row['reason']}")
    for row in result["changes"]:
        out.append(f"changed   {row['metric']}.{row['field']}: "
                   f"{row['old']} -> {row['new']}"
                   + (f" ({row['delta_pct']:+.1f}%)"
                      if row["delta_pct"] is not None else ""))
    for m in result["added"]:
        out.append(f"added     {m}")
    for m in result["removed"]:
        out.append(f"removed   {m}")
    n = len(result["regressions"])
    out.append(f"{n} regression(s) past threshold"
               + (" -> exit 1" if n else ""))
    return "\n".join(out)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="benchdiff", description=__doc__)
    ap.add_argument("old", help="older artifact (BENCH_r*.json / bench "
                               "stdout / recorder JSONL / SERVE "
                               "artifact / tuning table)")
    ap.add_argument("new", help="newer artifact")
    ap.add_argument("--threshold", type=float, default=DEFAULT_THRESHOLD,
                    help="relative value drop that counts as a regression "
                         f"(default {DEFAULT_THRESHOLD})")
    ap.add_argument("--json", action="store_true", dest="as_json")
    args = ap.parse_args(argv)

    old_table = load_tuning_table(args.old)
    new_table = load_tuning_table(args.new)
    if old_table is not None and new_table is not None:
        result = diff_tables(old_table, new_table,
                             threshold=args.threshold)
    elif (old_table is None) != (new_table is None):
        print("benchdiff: cannot diff a tuning table against a bench "
              "artifact", file=sys.stderr)
        return 2
    else:
        artifact = _artifact_mod()
        try:
            old_lines = artifact.load(args.old)
            new_lines = artifact.load(args.new)
        except OSError as exc:
            print(f"benchdiff: {exc}", file=sys.stderr)
            return 2
        result = diff(old_lines, new_lines, threshold=args.threshold)
    if args.as_json:
        print(json.dumps(result, indent=1))
    else:
        print(render(result, os.path.basename(args.old),
                     os.path.basename(args.new), args.threshold))
    return 1 if result["regressions"] else 0


if __name__ == "__main__":
    sys.exit(main())
