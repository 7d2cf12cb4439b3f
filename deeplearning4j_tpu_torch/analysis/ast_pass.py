"""Stage 1: run the G-rules over a file tree.

Pure stdlib — importing this module imports neither torch nor jax, so
the AST pass stays cheap enough for a pre-commit step
(`port_tools/graftlint.py --check`)."""

from __future__ import annotations

import ast
import os

from deeplearning4j_tpu_torch.analysis.core import (Finding,
                                                    apply_suppressions,
                                                    split_baselined)
from deeplearning4j_tpu_torch.analysis.ast_rules import run_rules

_SKIP_DIRS = {"__pycache__", ".git", ".pytest_cache", "node_modules"}


def iter_py_files(paths):
    for path in paths:
        if os.path.isfile(path):
            if path.endswith(".py"):
                yield path
            continue
        for dirpath, dirnames, filenames in os.walk(path):
            dirnames[:] = sorted(d for d in dirnames
                                 if d not in _SKIP_DIRS)
            for fn in sorted(filenames):
                if fn.endswith(".py"):
                    yield os.path.join(dirpath, fn)


def lint_source(source: str, path: str, rules=None) -> list[Finding]:
    """Lint one file's source. `path` is the repo-relative posix path —
    rules use it for scoping (G002 hot dirs, G009's bootstrap opt-out).
    `rules`: run only these (a stage's family), default all."""
    try:
        tree = ast.parse(source, filename=path)
    except SyntaxError as exc:
        return [Finding("G000", path, exc.lineno or 0, exc.offset or 0,
                        f"syntax error: {exc.msg}", "fix the syntax error",
                        "")]
    return apply_suppressions(run_rules(tree, source, path, rules), source)


def lint_paths(paths, root: str | None = None,
               rules=None) -> list[Finding]:
    """Lint every .py under `paths`; finding paths are relative to
    `root` (default cwd) so baseline keys are machine-independent."""
    root = os.path.abspath(root or os.getcwd())
    findings = []
    for fpath in iter_py_files(paths):
        with open(fpath, encoding="utf-8") as fh:
            source = fh.read()
        rel = os.path.relpath(os.path.abspath(fpath), root)
        findings.extend(lint_source(source, rel.replace(os.sep, "/"),
                                    rules))
    return findings


def lint_report(paths, baseline: set[str], root: str | None = None):
    """-> (new_findings, grandfathered_findings)."""
    return split_baselined(lint_paths(paths, root), baseline)
