#!/usr/bin/env python
"""tracetool — the fleet-timeline CLI over the port's telemetry JSONL
shards (JAX counterpart tools/tracetool.py, with the same subcommands,
flags, output and exit codes).

    python port_tools/tracetool.py merge  telemetry.jsonl [-o merged.jsonl]
    python port_tools/tracetool.py stats  telemetry.jsonl [--json]
    python port_tools/tracetool.py stats  telemetry.jsonl --artifact TRACE.json
    python port_tools/tracetool.py check  telemetry.jsonl [--json]
                                          [--fail-on straggler,retrace]
                                          [--skew-ms 2000]
    python port_tools/tracetool.py export telemetry.jsonl --perfetto \
                                          [-o trace.perfetto.json]
    python port_tools/tracetool.py tree   telemetry.jsonl [--trace <id>]
    python port_tools/tracetool.py mem    telemetry.jsonl [--json]

Every subcommand takes the UNSUFFIXED telemetry path and transparently
merges the `<path>.pN` per-process shards a fleet run leaves behind
(deeplearning4j_tpu_torch/telemetry/trace.py discover_shards) — or the
single file when the run was one process.

* `merge`  — the causally-ordered union, one process-tagged JSONL line
  per event (timestamp-major; per-process seq breaks ties so no single
  process's stream ever reorders).
* `stats`  — per-(process, span-name) count/p50/p99/max/total wall
  time: where each process's time went. `--artifact` also writes the
  TRACE artifact (per-span latency rows are lower-is-better;
  `anomaly_count`/`straggler_skew_ms` regress on ANY increase).
* `check`  — the anomaly detector: stragglers (cross-process
  step-completion skew / a stalled process), post-warmup retraces,
  input_wait and queue spikes, memory leaks (monotonic steady-state
  live-bytes growth), headroom breaches (live/limit past the
  watermark), and cost-model drift (predicted vs measured per-device
  memory outside the documented factor). Exit 1 when a finding
  matches `--fail-on` (default: every kind). Thresholds: `--skew-ms`,
  `--leak-min-bytes`, `--watermark`, `--drift-factor`.
* `export --perfetto` — Chrome trace-event JSON; open the output at
  https://ui.perfetto.dev (or chrome://tracing). `memory` events render
  as counter ("C") tracks: live bytes + the per-subsystem ledger.
* `tree`   — render one correlated span tree (request → queue →
  batch_assemble → forward → compile); without `--trace`, lists the
  trace ids on the record.
* `mem`    — the device-memory report: per-process live-bytes timeline
  (first/last/peak, growth, last ledger breakdown, device limits), the
  cost book (per-entry flops / peak temp from `cost` events), and every
  `cost_drift` reconciliation.

Exit codes: 0 clean, 1 findings (`check`), 2 usage/IO error. Pure
stdlib: the port's telemetry modules load under package stubs, so the
tool imports neither torch nor anything of the JAX package.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def _trace_mod():
    """Import telemetry.trace without the package root (which pulls in
    torch and the whole nn stack): stub packages whose path is the
    port's directories."""
    import importlib
    import types

    for name in ("deeplearning4j_tpu_torch",
                 "deeplearning4j_tpu_torch.telemetry"):
        if name not in sys.modules:
            mod = types.ModuleType(name)
            mod.__path__ = [os.path.join(ROOT, *name.split("."))]
            sys.modules[name] = mod
    return importlib.import_module(
        "deeplearning4j_tpu_torch.telemetry.trace")


def _config(trace, args):
    kw = {}
    if getattr(args, "skew_ms", None) is not None:
        kw["straggler_skew_ms"] = float(args.skew_ms)
    if getattr(args, "leak_min_bytes", None) is not None:
        kw["leak_min_growth_bytes"] = float(args.leak_min_bytes)
    if getattr(args, "watermark", None) is not None:
        kw["headroom_watermark"] = float(args.watermark)
    if getattr(args, "drift_factor", None) is not None:
        kw["cost_drift_factor"] = float(args.drift_factor)
    return trace.AnomalyConfig(**kw)


def cmd_merge(trace, args) -> int:
    tl = trace.load_timeline(args.path)
    out = sys.stdout if args.output is None else open(args.output, "w")
    try:
        for ev in tl.events:
            out.write(json.dumps(ev) + "\n")
    finally:
        if args.output is not None:
            out.close()
            print(f"merged {len(tl.events)} events from "
                  f"{len(tl.processes)} process(es) -> {args.output}")
    return 0


def cmd_stats(trace, args) -> int:
    tl = trace.load_timeline(args.path)
    stats = trace.span_stats(tl)
    if args.as_json:
        print(json.dumps(
            {f"{p}::{n}": row for (p, n), row in sorted(stats.items())},
            indent=1))
    else:
        print(f"{len(tl.events)} events, {len(tl.processes)} process(es): "
              + ", ".join(tl.processes))
        header = (f"{'process':<8} {'span':<22} {'count':>6} "
                  f"{'p50_ms':>10} {'p99_ms':>10} {'max_ms':>10} "
                  f"{'total_s':>10}")
        print(header)
        for (p, n), row in sorted(stats.items()):
            print(f"{p:<8} {n:<22} {row['count']:>6} "
                  f"{row['p50_ms']:>10.3f} {row['p99_ms']:>10.3f} "
                  f"{row['max_ms']:>10.3f} {row['total_s']:>10.3f}")
    if args.artifact:
        anomalies = trace.detect_anomalies(tl, _config(trace, args))
        lines = trace.metric_lines(tl, anomalies)
        _write_artifact(args.artifact, lines)
        print(f"TRACE artifact ({len(lines)} rows) -> {args.artifact}")
    return 0


def _write_artifact(path: str, lines: list) -> None:
    """The SERVE artifact shape (metric JSONL + gate-carrying trailing
    summary, telemetry/artifact.py) so TRACE artifacts parse with the
    same code."""
    import importlib

    artifact = importlib.import_module(
        "deeplearning4j_tpu_torch.telemetry.artifact")
    summary = artifact.build_summary(lines)
    with open(path, "w") as fh:
        for line in lines:
            fh.write(json.dumps(line) + "\n")
        fh.write(json.dumps(summary) + "\n")


def cmd_check(trace, args) -> int:
    tl = trace.load_timeline(args.path)
    findings = trace.detect_anomalies(tl, _config(trace, args))
    fail_on = set(k for k in (args.fail_on or "").split(",") if k) or None
    gating = [f for f in findings
              if fail_on is None or f["anomaly"] in fail_on]
    if args.as_json:
        print(json.dumps({"findings": findings,
                          "gating": len(gating)}, indent=1))
    else:
        for f in findings:
            gate = "FAIL" if (fail_on is None
                              or f["anomaly"] in fail_on) else "info"
            detail = {k: v for k, v in f.items() if k != "anomaly"}
            print(f"{gate} {f['anomaly']}: {json.dumps(detail)}")
        print(f"tracetool check: {len(findings)} finding(s), "
              f"{len(gating)} gating")
    return 1 if gating else 0


def cmd_export(trace, args) -> int:
    tl = trace.load_timeline(args.path)
    doc = trace.to_perfetto(tl)
    out = args.output or (args.path + ".perfetto.json")
    with open(out, "w") as fh:
        json.dump(doc, fh)
    print(f"{len(doc['traceEvents'])} trace events -> {out} "
          "(open at https://ui.perfetto.dev)")
    return 0


def cmd_tree(trace, args) -> int:
    tl = trace.load_timeline(args.path)
    if args.trace is None:
        ids = trace.trace_ids(tl)
        print(f"{len(ids)} trace(s) on the record:")
        for tid in ids:
            print(f"  {tid}")
        return 0
    roots = trace.span_tree(tl, args.trace)
    if not roots:
        print(f"tracetool: no events carry trace_id {args.trace!r}",
              file=sys.stderr)
        return 2
    print(trace.render_tree(roots))
    return 0


def cmd_mem(trace, args) -> int:
    tl = trace.load_timeline(args.path)
    report = trace.memory_report(tl)
    if args.as_json:
        print(json.dumps(report, indent=1))
        return 0
    if not report["processes"]:
        print("tracetool mem: no memory events on the record "
              "(set DL4J_TPU_MEM_EVERY / run a serving engine with "
              "telemetry enabled)")
        return 0
    for process, row in report["processes"].items():
        limits = ", ".join(f"dev{d}={v}" for d, v
                           in row["device_limits"].items()) or "none"
        print(f"{process}: {row['samples']} sample(s)  "
              f"first={row['first_bytes']}B last={row['last_bytes']}B "
              f"peak={row['peak_bytes']}B growth={row['growth_bytes']}B  "
              f"limits: {limits}")
        for subsystem, nbytes in sorted(row["ledger"].items()):
            print(f"  ledger {subsystem:<12} {nbytes}B")
    if report["cost_book"]:
        print(f"cost book ({len(report['cost_book'])} entries):")
        for key, fields in sorted(report["cost_book"].items()):
            detail = " ".join(f"{k}={v}" for k, v in sorted(fields.items()))
            print(f"  {key}: {detail}")
    for drift in report["cost_drift"]:
        print(f"cost_drift [{drift.get('source')}]: "
              f"predicted={drift.get('predicted_bytes')}B "
              f"measured={drift.get('measured_bytes')}B "
              f"ratio={drift.get('ratio')} "
              f"(factor {drift.get('factor')})")
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="tracetool", description=__doc__)
    sub = ap.add_subparsers(dest="cmd", required=True)

    def common(p):
        p.add_argument("path", help="telemetry JSONL path (the .pN "
                                    "shards merge transparently)")
        p.add_argument("--json", action="store_true", dest="as_json")
        p.add_argument("--skew-ms", type=float, default=None,
                       help="straggler skew threshold (default 2000)")
        p.add_argument("--leak-min-bytes", type=float, default=None,
                       help="leak growth floor in bytes (default 1 MiB)")
        p.add_argument("--watermark", type=float, default=None,
                       help="headroom breach fraction (default 0.92)")
        p.add_argument("--drift-factor", type=float, default=None,
                       help="cost-drift ratio band (default 8.0)")

    p = sub.add_parser("merge", help="merged causal timeline as JSONL")
    common(p)
    p.add_argument("-o", "--output", default=None)
    p.set_defaults(fn=cmd_merge)

    p = sub.add_parser("stats", help="per-span p50/p99 per process")
    common(p)
    p.add_argument("--artifact", default=None,
                   help="also write the benchdiff-diffable TRACE "
                        "artifact here")
    p.set_defaults(fn=cmd_stats)

    p = sub.add_parser("check", help="run the anomaly detector")
    common(p)
    p.add_argument("--fail-on", default=None,
                   help="comma list of anomaly kinds that exit 1 "
                        "(default: every kind)")
    p.set_defaults(fn=cmd_check)

    p = sub.add_parser("export", help="export the timeline")
    common(p)
    p.add_argument("--perfetto", action="store_true",
                   help="Chrome trace-event JSON (the only format, "
                        "flag kept explicit for the reader)")
    p.add_argument("-o", "--output", default=None)
    p.set_defaults(fn=cmd_export)

    p = sub.add_parser("tree", help="render a correlated span tree")
    common(p)
    p.add_argument("--trace", default=None, help="trace id to render")
    p.set_defaults(fn=cmd_tree)

    p = sub.add_parser("mem", help="device-memory timeline + cost book")
    common(p)
    p.set_defaults(fn=cmd_mem)

    args = ap.parse_args(argv)
    trace = _trace_mod()
    try:
        return args.fn(trace, args)
    except FileNotFoundError as exc:
        print(f"tracetool: {exc}", file=sys.stderr)
        return 2


if __name__ == "__main__":
    sys.exit(main())
