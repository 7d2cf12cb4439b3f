"""Finding model, inline suppressions, and the checked-in baseline
(the counterpart of deeplearning4j_tpu/analysis/core.py; the contracts
are the same, so a finding, a suppression comment or a baseline key
means the same in both packages).

A finding's baseline KEY deliberately omits the line number: baselines
must survive unrelated edits above the offending line, so the key is
(rule, path, stripped source line). Two identical offending lines in one
file share a key — acceptable for a grandfather list that is supposed to
shrink to zero, not grow.
"""

from __future__ import annotations

import ast
import dataclasses
import importlib.util
import json
import os
import re

# `# graftlint: disable=G001` or `# graftlint: disable=G001,G005` on the
# offending line (or the `if`/`def` line of the flagged statement).
_SUPPRESS_RE = re.compile(r"#\s*graftlint:\s*disable=([A-Z0-9,\s]+)")


# Every lint stage, in execution order. The CLI's --stage choices and
# the --rules inventory derive from this — adding a stage means adding
# it here plus its runner in port_tools/graftlint.py. `ops` is the
# counterpart of the JAX package's `jaxpr` stage: the op audit of the
# eager steps (analysis/op_audit.py).
STAGES = ("ast", "ops", "spmd", "concurrency", "precision")


@dataclasses.dataclass(frozen=True)
class Finding:
    rule: str        # "G001".."G034" (AST passes) / "J001".."J004"
                     # (op audit) / "C001".."C003" (collective audit)
                     # / "D001".."D003" (lock-order audit)
                     # / "P001".."P005", "PB01" (precision audit)
    path: str        # repo-relative posix path, or an entry-point name
    line: int        # 1-based; 0 for whole-artifact (op audit) findings
    col: int
    message: str
    fixit: str       # how to fix it (every rule carries one)
    snippet: str = ""
    # which lint stage produced it (one of STAGES) so --json consumers
    # (benchdiff-style tooling) can filter without re-deriving the
    # stage from the rule id. Excluded from `key`: baselines must
    # stay valid if a rule migrates stages.
    stage: str = ""

    @property
    def key(self) -> str:
        return f"{self.rule}:{self.path}:{self.snippet}"

    def format(self) -> str:
        loc = f"{self.path}:{self.line}:{self.col}" if self.line else self.path
        return f"{loc}: {self.rule} {self.message}\n    fix: {self.fixit}"

    def to_json(self) -> dict:
        return dataclasses.asdict(self)


def audit_device(device=None) -> str:
    """The device an audit entry point runs on, as its name: CUDA unless
    the caller names another (the package's `resolve_device`)."""
    from deeplearning4j_tpu_torch import resolve_device

    return str(resolve_device(device))


def walk(node) -> list:
    """`ast.walk(node)` as a list, memoized on the node: every rule walks
    the same trees and subtrees, so each is walked once per lint."""
    cached = getattr(node, "_gl_walk", None)
    if cached is None:
        cached = node._gl_walk = list(ast.walk(node))
    return cached


def suppressions(source: str) -> dict[int, set[str]]:
    """line (1-based) -> set of rule ids disabled on that line.

    Matched against the finding's reported line, so a disable comment
    sits on the line the linter names (for multi-line statements that is
    the statement's FIRST line)."""
    out: dict[int, set[str]] = {}
    for i, text in enumerate(source.splitlines(), start=1):
        m = _SUPPRESS_RE.search(text)
        if m:
            out[i] = {r.strip() for r in m.group(1).split(",") if r.strip()}
    return out


def apply_suppressions(findings, source: str):
    sup = suppressions(source)
    return [f for f in findings if f.rule not in sup.get(f.line, ())]


def load_baseline(path: str) -> set[str]:
    try:
        with open(path) as fh:
            data = json.load(fh)
    except FileNotFoundError:
        return set()
    return set(data.get("findings", []))


def write_baseline(path: str, findings) -> None:
    keys = sorted({f.key for f in findings})
    with open(path, "w") as fh:
        json.dump(
            {"comment": "graftlint grandfathered findings — shrink, never "
                        "grow. Regenerate: port_tools/graftlint.py "
                        "--write-baseline",
             "findings": keys}, fh, indent=1)
        fh.write("\n")


def split_baselined(findings, baseline: set[str]):
    """-> (new, grandfathered)."""
    new, old = [], []
    for f in findings:
        (old if f.key in baseline else new).append(f)
    return new, old


def load_hook(path: str, hook: str) -> dict:
    """The {entry name: builder} dict a fixture .py exposes under `hook`
    (the trace stages' GRAFTLINT_SPMD_ENTRIES and
    GRAFTLINT_PRECISION_ENTRIES), or {}. A file whose text never names
    the hook is not executed."""
    with open(path, encoding="utf-8") as fh:
        if hook not in fh.read():
            return {}
    modname = f"_graftlint_{hook.lower()}_" + re.sub(
        r"\W", "_", os.path.abspath(path))
    spec = importlib.util.spec_from_file_location(modname, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return getattr(mod, hook, {})
