#!/usr/bin/env python
"""graftlint for the port — the counterpart of tools/graftlint.py, over
deeplearning4j_tpu_torch/ (tools/graftlint.py still lints only the JAX
package).

    graftlint.py deeplearning4j_tpu_torch           # report
    graftlint.py --check deeplearning4j_tpu_torch   # exit 1 on findings
    graftlint.py --check --stage all --device cpu   # + op audit, CPU
    graftlint.py --check --stage ops                # op audit on the card
    graftlint.py --check --stage spmd               # rank divergence
    graftlint.py --check --stage concurrency        # host threads
    graftlint.py --check --stage precision --device cpu|cuda  # dtypes
    graftlint.py --json ...                         # machine output
    graftlint.py --write-baseline ...               # grandfather
    graftlint.py --update-budget --device cpu|cuda  # refreeze op bounds
    graftlint.py --update-collectives               # refreeze stage 3
    graftlint.py --update-precision --device cpu|cuda  # refreeze stage 5
    graftlint.py --update-locks                     # refreeze stage 4
    graftlint.py --changed                          # diff-scoped, fast
    graftlint.py --rules                            # rule inventory

(`python3 port_tools/graftlint.py ...` from the repo root.)

Stage `ast` (default) is pure stdlib — it imports neither torch nor jax
(the port's root package, which imports torch, is stubbed), so it suits
a pre-commit step; it runs all AST rules G001-G034. Stage `ops` runs
every entry point of analysis/op_audit.py twice on `--device` (default
cuda, the card; `cpu` runs the plain versions) and audits the second
call against analysis/op_budget.json (J001 syncs, J002 op count, J003
float64, J004 missing). Stage `spmd` runs the rank-divergence rules
G010-G015, G018, then the collective audit (analysis/collective_audit.py:
each entry's ordered c10d signature, recorded on the CPU as simulated
ranks of a fake process group, against analysis/collective_budget.json;
C001 drift, C002 missing, C003 rank divergence). Stage `precision` runs
the dtype rules G031-G034, then the precision audit
(analysis/precision_audit.py) of every entry on `--device`: each
recorded call's dtype profile against analysis/precision_budget.json
(P001 sub-f32 accumulation, P002 the int8 pairing, P003 convert churn,
P004 widened collectives, P005 rank divergence, PB01 drift). Explicit
.py paths that define GRAFTLINT_SPMD_ENTRIES or
GRAFTLINT_PRECISION_ENTRIES are audited in place of the built-in
entries, without the frozen files. `--stage all` records each entry
once for the op and precision audits. Stage
`concurrency` (pure stdlib, like `ast`) runs the host-thread rules
G025-G028 plus the lock-order audit (analysis/lock_audit.py): edges
frozen in analysis/lock_order.json, a lock-order CYCLE (D001) always
exits 1; pass explicit .py paths to audit fixtures without the
frozen-set comparison. `--changed [REF]` scopes the lint to .py files
touched since REF (default HEAD). Exit codes: 0 clean, 1 findings
(--check) or any D001, 2 usage/env error.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

PKG = "deeplearning4j_tpu_torch"
DEFAULT_BASELINE = os.path.join(ROOT, "port_tools", "graftlint_baseline.json")

# the hook a fixture .py defines for each trace stage
_HOOKS = {"spmd": "GRAFTLINT_SPMD_ENTRIES",
          "precision": "GRAFTLINT_PRECISION_ENTRIES"}


def _stub_packages() -> None:
    """Register `deeplearning4j_tpu_torch(.analysis)` as namespace-style
    stubs so `analysis.*` submodules import directly from their files,
    skipping the root __init__ (which imports torch). All intra-package
    imports use full dotted paths, so the skipped root is never
    missed."""
    import types
    pkg = types.ModuleType(PKG)
    pkg.__path__ = [os.path.join(ROOT, PKG)]
    sub = types.ModuleType(f"{PKG}.analysis")
    sub.__path__ = [os.path.join(ROOT, PKG, "analysis")]
    sys.modules.setdefault(PKG, pkg)
    sys.modules.setdefault(f"{PKG}.analysis", sub)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="graftlint", description=__doc__,
                                 formatter_class=argparse.
                                 RawDescriptionHelpFormatter)
    ap.add_argument("paths", nargs="*", default=None,
                    help=f"files/dirs to lint (default: {PKG})")
    ap.add_argument("--check", action="store_true",
                    help="exit non-zero when there are non-baselined "
                         "findings")
    ap.add_argument("--json", action="store_true", dest="as_json",
                    help="emit findings as JSON")
    ap.add_argument("--stage",
                    choices=("ast", "ops", "spmd", "concurrency",
                             "precision", "all"),
                    default="ast")
    ap.add_argument("--device", default="cuda",
                    help="where stages `ops` and `precision` run their "
                         "entries (default cuda, the card; cpu runs the "
                         "plain versions)")
    ap.add_argument("--baseline", default=DEFAULT_BASELINE)
    ap.add_argument("--write-baseline", action="store_true",
                    help="grandfather all current AST findings into the "
                         "baseline file")
    ap.add_argument("--update-budget", action="store_true",
                    help="rerun every op-audit entry on --device and "
                         "refreeze its op-count budget")
    ap.add_argument("--update-collectives", action="store_true",
                    help="rerun every collective-audit entry and refreeze "
                         "its signature (analysis/collective_budget.json)")
    ap.add_argument("--update-locks", action="store_true",
                    help="rescan the package lock-order graph and "
                         "refreeze the blessed edge set "
                         "(analysis/lock_order.json)")
    ap.add_argument("--update-precision", action="store_true",
                    help="rerun every precision-audit entry on --device "
                         "and refreeze its profile "
                         "(analysis/precision_budget.json)")
    ap.add_argument("--changed", nargs="?", const="HEAD", default=None,
                    metavar="REF",
                    help="lint only .py files touched since REF "
                         "(default HEAD: staged + unstaged + untracked)")
    ap.add_argument("--rules", action="store_true",
                    help="print the per-stage rule inventory and exit")
    args = ap.parse_args(argv)

    # explicit .py paths are audited as fixtures: the trace stages run
    # the entries they expose (none: no trace), not the built-in ones
    explicit_py = [p for p in (args.paths or []) if p.endswith(".py")]
    fixtures = bool(explicit_py) and len(explicit_py) == len(args.paths)
    trace = args.stage in _HOOKS and (not fixtures or any(
        _defines(p, _HOOKS[args.stage]) for p in explicit_py))
    needs_torch = (args.stage in ("ops", "all") or trace
                   or args.update_budget or args.update_collectives
                   or args.update_precision)
    if not needs_torch:
        # Pre-commit path: stub the package parents so the analysis
        # modules load WITHOUT the root __init__ (which imports torch).
        _stub_packages()

    if args.rules:
        return _print_rules()
    from deeplearning4j_tpu_torch.analysis.ast_pass import lint_paths
    from deeplearning4j_tpu_torch.analysis.core import (load_baseline,
                                                        split_baselined,
                                                        write_baseline)

    paths = args.paths or [os.path.join(ROOT, PKG)]
    if args.changed is not None:
        paths = _changed_paths(args.changed)
        if not paths:
            print(f"graftlint: no .py files changed since {args.changed}")
            return 0
    new, old = [], []
    records: dict = {}

    updating = (args.update_budget or args.update_locks
                or args.update_collectives or args.update_precision)
    if args.stage in ("ast", "all", "spmd", "concurrency", "precision") \
            and not updating:
        # the spmd, concurrency and precision stages lint their own rule
        # family only
        from deeplearning4j_tpu_torch.analysis import ast_rules
        family = {"spmd": ast_rules.SPMD_RULES,
                  "concurrency": ast_rules.CONC_RULES,
                  "precision": ast_rules.PRECISION_RULES}.get(args.stage)
        findings = lint_paths(paths, root=ROOT, rules=family)
        if args.write_baseline:
            write_baseline(args.baseline, findings)
            print(f"baselined {len(findings)} findings -> {args.baseline}")
            return 0
        n, o = split_baselined(findings, load_baseline(args.baseline))
        new.extend(n)
        old.extend(o)

    if args.update_collectives:
        from deeplearning4j_tpu_torch.analysis import collective_audit
        # the signatures are the same on every device (one frozen
        # section), so the collective audit records on the CPU
        _, signatures = collective_audit.audit(divergence=False,
                                               device="cpu")
        collective_audit.write_budget(signatures)
        print(f"froze collective signatures for {len(signatures)} entry "
              f"points -> {collective_audit.BUDGET_PATH}")
        for name, sig in sorted(signatures.items()):
            print(f"  {name}: {len(sig)} c10d op(s)")
        return 0

    run_ops = args.stage in ("ops", "all") or args.update_budget
    run_precision = (args.stage == "all" or args.update_precision
                     or (args.stage == "precision" and trace))
    if (run_ops or run_precision) and args.device.startswith("cuda"):
        import torch

        if not torch.cuda.is_available():
            stage = "ops" if run_ops else "precision"
            print(f"graftlint: stage `{stage}` on cuda needs a CUDA device "
                  "(pass --device cpu to audit the plain versions)",
                  file=sys.stderr)
            return 2

    if run_ops:
        from deeplearning4j_tpu_torch.analysis import op_audit
        ofindings, records = op_audit.audit(device=args.device)
        if args.update_budget:
            counts = {n: r.count for n, r in records.items()}
            op_audit.write_budget(counts, args.device)
            print(f"froze op budgets for {len(counts)} entry points on "
                  f"{args.device} -> {op_audit.BUDGET_PATH}")
            for name, count in sorted(counts.items()):
                print(f"  {name}: {count} ops + launches")
            return 0
        new.extend(ofindings)

    signatures: dict = {}
    if args.stage == "all" or (args.stage == "spmd" and trace):
        from deeplearning4j_tpu_torch.analysis import collective_audit
        if fixtures:
            cfindings, signatures = collective_audit.audit_paths(
                explicit_py, "cpu")
        else:
            cfindings, signatures = collective_audit.audit(device="cpu")
        new.extend(cfindings)

    profiles: dict = {}
    if run_precision:
        from deeplearning4j_tpu_torch.analysis import precision_audit
        if args.update_precision:
            _, profiles = precision_audit.audit(device=args.device,
                                                divergence=False)
            precision_audit.write_budget(profiles, args.device)
            print(f"froze precision profiles for {len(profiles)} entry "
                  f"points on {args.device} -> "
                  f"{precision_audit.BUDGET_PATH}")
            for name, prof in sorted(profiles.items()):
                print(f"  {name}: {sum(prof['dots'].values())} product(s), "
                      f"{sum(prof['converts'].values())} convert(s), "
                      f"q8 {prof['q8']['quantize']}q/"
                      f"{prof['q8']['dequantize']}dq, launches "
                      f"{prof['launches']}")
            return 0
        if fixtures and args.stage == "precision":
            pfindings, profiles = precision_audit.audit_paths(
                explicit_py, args.device)
        else:
            # one recorded call serves stage 2 and stage 5
            pfindings, profiles = precision_audit.audit(
                device=args.device, records=records)
        new.extend(pfindings)

    lock_edges: list[str] = []
    if args.stage in ("concurrency", "all") or args.update_locks:
        from deeplearning4j_tpu_torch.analysis import lock_audit
        if args.update_locks:
            edge_strs, _ = lock_audit.current_edges()
            lock_audit.write_locks(edge_strs)
            print(f"froze {len(edge_strs)} lock-order edge(s) -> "
                  f"{lock_audit.LOCKS_PATH}")
            for s in edge_strs:
                print(f"  {s}")
            return 0
        # explicit .py paths are audited as fixtures (no frozen-set
        # comparison); the default package sweep checks for drift
        explicit_py = [p for p in (args.paths or [])
                       if p.endswith(".py")]
        if explicit_py and len(explicit_py) == len(args.paths):
            lfindings, lock_edges = lock_audit.audit_paths(explicit_py)
        else:
            lfindings, lock_edges = lock_audit.audit()
        new.extend(lfindings)

    if args.as_json:
        print(json.dumps({
            "findings": [f.to_json() for f in new],
            "grandfathered": [f.to_json() for f in old],
            "op_audit": {n: r.to_json() for n, r in records.items()},
            "collective_signatures": signatures,
            "lock_order_edges": lock_edges,
            "precision_profiles": profiles,
        }, indent=1))
    else:
        for f in new:
            print(f.format())
        if old:
            print(f"({len(old)} grandfathered finding(s) in baseline)")
        if records:
            print(f"op audit: {len(records)} entry points run on "
                  f"{args.device}")
        if signatures:
            print(f"collective audit: {len(signatures)} entry points "
                  "recorded")
        if lock_edges:
            print(f"lock-order audit: {len(lock_edges)} edge(s)")
        if profiles:
            print(f"precision audit: {len(profiles)} entry points "
                  f"profiled on {args.device}")
        print(f"graftlint: {len(new)} finding(s)")
    # a lock-order cycle is a deadlock waiting for load — never
    # reportable-only, regardless of --check or baseline
    if any(f.rule == "D001" for f in new):
        return 1
    return 1 if (new and args.check) else 0


def _defines(path: str, hook: str) -> bool:
    """Whether the .py file at `path` names a trace stage's hook."""
    try:
        with open(path, encoding="utf-8") as fh:
            return hook in fh.read()
    except OSError:
        return False


def _changed_paths(ref: str) -> list[str]:
    """Absolute paths of .py files touched since `ref` (staged +
    unstaged via `git diff`, plus untracked). Exits 2 on a bad ref —
    the usage-error contract."""
    import subprocess

    diff = subprocess.run(["git", "diff", "--name-only", "-z", ref, "--"],
                          cwd=ROOT, capture_output=True, text=True)
    if diff.returncode != 0:
        print(diff.stderr.strip() or f"git diff {ref} failed",
              file=sys.stderr)
        sys.exit(2)
    names = [n for n in diff.stdout.split("\0") if n]
    untracked = subprocess.run(
        ["git", "ls-files", "--others", "--exclude-standard", "-z"],
        cwd=ROOT, capture_output=True, text=True)
    if untracked.returncode == 0:
        names += [n for n in untracked.stdout.split("\0") if n]
    return sorted({os.path.join(ROOT, n) for n in names
                   if n.endswith(".py") and n.startswith(PKG + "/")
                   and os.path.isfile(os.path.join(ROOT, n))})


def _print_rules() -> int:
    """Per-stage rule inventory (from RULE_DOCS + the audit docs)."""
    from deeplearning4j_tpu_torch.analysis.ast_rules import RULE_DOCS
    from deeplearning4j_tpu_torch.analysis.concurrency_rules import \
        CONC_RULE_IDS
    from deeplearning4j_tpu_torch.analysis.lock_audit import \
        RULE_DOCS as LOCK_DOCS
    from deeplearning4j_tpu_torch.analysis.precision_rules import \
        PRECISION_RULE_IDS
    from deeplearning4j_tpu_torch.analysis.spmd_rules import SPMD_RULE_IDS

    audit_docs = {
        "J001": "host sync (scalar read, nonzero, boolean mask, copy to "
                "the CPU, a sync_debug_mode warning) in an entry point",
        "J002": "op count plus kernel launches over the frozen budget",
        "J003": "float64 tensor into or out of an op",
        "J004": "entry point missing from the budget for its device",
        "C001": "collective signature drift from the frozen one",
        "C002": "entry point missing from the frozen signatures",
        "C003": "rank-divergent collective sequence or program, or an "
                "unmatched point-to-point move (deadlock class)",
        "P001": "sub-f32 accumulation (a chained reduction, a cumulative "
                "op, a collective sum, a loop-carried add)",
        "P002": "broken int8 quantize/dequantize pairing",
        "P003": "convert round trip whose middle value nothing reads",
        "P004": "collective operand wider than the entry's inputs",
        "P005": "rank-divergent precision profile (deadlock class)",
        "PB01": "precision profile drift from the frozen manifest, or "
                "missing",
    }
    stages = [
        ("ast", sorted(set(RULE_DOCS) - SPMD_RULE_IDS - CONC_RULE_IDS
                       - PRECISION_RULE_IDS)),
        ("ops", ["J001", "J002", "J003", "J004"]),
        ("spmd", sorted(SPMD_RULE_IDS) + ["C001", "C002", "C003"]),
        ("concurrency", sorted(CONC_RULE_IDS) + sorted(LOCK_DOCS)),
        ("precision", sorted(PRECISION_RULE_IDS)
         + ["P001", "P002", "P003", "P004", "P005", "PB01"]),
    ]
    for stage, ids in stages:
        print(f"stage {stage}:")
        for rid in ids:
            doc = RULE_DOCS.get(rid) or audit_docs.get(rid) \
                or LOCK_DOCS.get(rid, "")
            first = doc.split(";")[0].split(" — ")[0].strip()
            print(f"  {rid}  {first}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
