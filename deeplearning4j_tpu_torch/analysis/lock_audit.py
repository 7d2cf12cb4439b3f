"""graftlint stage 4, part 2: whole-package lock-ORDER audit, the
port's counterpart of deeplearning4j_tpu/analysis/lock_audit.py. It reads
deeplearning4j_tpu_torch/ and freezes the port's own edges in this
directory's lock_order.json; run over the JAX tree it builds the JAX
analyzer's graph edge for edge.

The collective audit (stage 3) catches the *device-side* deadlock
class statically: rank-divergent collective sequences (C003). This
module is its host-side twin. It builds a directed lock-order graph
over the whole package — for every ``with lockA:`` region, every lock
acquired inside the region (directly, or one call-hop deep through
helpers the analysis can resolve) adds an edge ``lockA -> lockB`` —
and then:

- D001  a CYCLE in the graph is a deadlock finding naming both
        acquisition chains file:line. Two threads entering the cycle
        from different edges block each other forever. Cycles always
        exit 1 from the CLI, baseline or not.
- D002  lock acquisition inside a telemetry sink/collector callback
        invoked while a lock is held — the sink-reentrancy shape of the
        /metrics wiring: ``Recorder.event`` fans
        out to registered sinks, and a sink that takes a lock (the
        MetricsRegistry histogram update) runs under whatever the
        emitter holds.
- D003  lock-order drift — the blessed edge set is FROZEN in
        ``analysis/lock_order.json`` (same discipline as the op budget
        and the collective signatures). A new edge that closes
        no cycle is drift: reviewed, then refrozen with
        ``port_tools/graftlint.py --update-locks``. A frozen edge that
        vanished is stale and also drift.

Edge nodes are ``<relpath>:<Class>.<lockgroup>`` (class locks) or
``<relpath>:<name>`` (module-level locks); a lock group is the
attribute set sharing one underlying lock, e.g. the Channel's two
conditions over one Lock are the single node
``data/prefetcher.py:Channel._not_empty|_not_full``.

Call-hop resolution is deliberately conservative: ``self.m()``
resolves exactly within the class; a cross-class ``obj.m()`` resolves
only when exactly one lock-acquiring method in the package bears that
name and the name is not generic (put/get/join/...); everything else
is skipped rather than guessed. The graph under-approximates — a
reported cycle is real.

Pure stdlib; runs with torch and jax unimportable, like stages 1 and 4a.
"""

from __future__ import annotations

import ast
import json
import os

from deeplearning4j_tpu_torch.analysis.concurrency_rules import (
    ClassModel,
    _callback_loop_attr,
    _module_locks,
    _own_nodes,
    _self_attr,
)
from deeplearning4j_tpu_torch.analysis.core import Finding, walk

LOCKS_PATH = os.path.join(os.path.dirname(__file__), "lock_order.json")

RULE_DOCS = {
    "D001": "lock-order cycle: two `with` chains acquire the same locks "
            "in opposite order — threads entering from different edges "
            "deadlock; the host-side twin of C003 (always exits 1)",
    "D002": "sink reentrancy: registered telemetry sink/collector "
            "callbacks invoked while a lock is held — a sink that "
            "acquires a lock (metrics histogram update) runs under "
            "whatever the emitter holds",
    "D003": "lock-order drift: an edge not in the frozen "
            "analysis/lock_order.json (or a stale frozen edge) — "
            "review the new acquisition order, then refreeze with "
            "--update-locks",
}

# Method names too generic to resolve cross-class by name alone
# (queue.Queue.put vs Channel.put, threading vs domain join/close...).
_GENERIC_NAMES = frozenset({
    "put", "get", "join", "wait", "wait_for", "acquire", "release",
    "start", "stop", "close", "run", "set", "clear", "is_set",
    "describe", "send", "recv", "submit", "next", "read", "write",
    "flush", "poll", "step", "reset", "update", "add", "append",
    "pop", "remove", "notify", "notify_all",
})


class _FileInfo:
    def __init__(self, path: str, rel: str):
        from deeplearning4j_tpu_torch.analysis.ast_rules import (
            Imports, _walk_with_parents)
        self.path = path
        self.rel = rel
        with open(path, encoding="utf-8") as fh:
            self.source = fh.read()
        self.tree = _walk_with_parents(ast.parse(self.source))
        self.imports = Imports(self.tree)
        self.models = [ClassModel(n, self.imports)
                       for n in walk(self.tree)
                       if isinstance(n, ast.ClassDef)]
        self.by_class = {id(m.node): m for m in self.models}
        self.mod_locks = _module_locks(self.tree, self.imports)
        self.mod_funcs = {n.name: n for n in self.tree.body
                          if isinstance(n, ast.FunctionDef)}

    def model_at(self, node) -> ClassModel | None:
        from deeplearning4j_tpu_torch.analysis.ast_rules import _parents
        for p in _parents(node):
            if isinstance(p, ast.ClassDef):
                return self.by_class.get(id(p))
        return None

    def lock_nodes(self, expr, model) -> set[str]:
        """Graph node ids a with-item / acquisition expr resolves to."""
        out = set()
        if model is not None:
            g = model.group_of_expr(expr)
            if g:
                out.add(f"{self.rel}:{model.name}.{g}")
        if isinstance(expr, ast.Name) and expr.id in self.mod_locks:
            out.add(f"{self.rel}:{expr.id}")
        return out


def _direct_acquires(fn, info: _FileInfo, model) -> set[str]:
    """Node ids of locks a call to *fn* acquires directly (own
    statements only — nested defs run later, on other threads)."""
    out: set[str] = set()
    for node in _own_nodes(fn):
        if isinstance(node, ast.With):
            for item in node.items:
                out |= info.lock_nodes(item.context_expr, model)
    return out


def _is_property(fn) -> bool:
    return any(isinstance(d, ast.Name) and d.id == "property"
               for d in fn.decorator_list)


def _build(paths: list[str], root: str):
    """(edges, findings) for the files in *paths*.

    edges: {(src, dst): (rel, line, context)} — first site wins.
    findings: raw D002 findings (cycles/drift are computed by callers).
    """
    from deeplearning4j_tpu_torch.analysis.ast_pass import iter_py_files

    files: list[tuple[str, str]] = []
    for p in paths:
        if os.path.isdir(p):
            for f in iter_py_files([p]):
                files.append((f, os.path.relpath(f, root).replace(
                    os.sep, "/")))
        else:
            files.append((p, os.path.relpath(p, root).replace(
                os.sep, "/")))

    infos = []
    for path, rel in files:
        try:
            infos.append(_FileInfo(path, rel))
        except SyntaxError:
            continue  # stage 1 reports G000 for these

    # package-wide name maps: method/property name -> node ids it
    # acquires, kept only while unambiguous and non-generic
    meth_map: dict[str, set[str]] = {}
    prop_map: dict[str, set[str]] = {}
    for info in infos:
        for model in info.models:
            for mname, fn in model.methods.items():
                acq = _direct_acquires(fn, info, model)
                if not acq:
                    continue
                dest = prop_map if _is_property(fn) else meth_map
                dest.setdefault(mname, set()).update(acq)

    edges: dict[tuple[str, str], tuple[str, int, str]] = {}
    findings: list[Finding] = []

    def add_edge(held: set[str], dsts: set[str], info, node, why: str):
        line = getattr(node, "lineno", 0)
        for src in sorted(held):
            for dst in sorted(dsts):
                if src != dst:
                    edges.setdefault((src, dst), (info.rel, line, why))

    for info in infos:
        lines = info.source.splitlines()
        for w in walk(info.tree):
            if not isinstance(w, ast.With):
                continue
            model = info.model_at(w)
            held = set()
            for item in w.items:
                held |= info.lock_nodes(item.context_expr, model)
            if not held:
                continue
            for stmt in w.body:
                if isinstance(stmt, (ast.FunctionDef,
                                     ast.AsyncFunctionDef,
                                     ast.ClassDef)):
                    continue
                for node in [stmt] + list(_own_nodes(stmt)):
                    if isinstance(node, ast.With):
                        acq = set()
                        for item in node.items:
                            acq |= info.lock_nodes(item.context_expr,
                                                   model)
                        add_edge(held, acq, info, node, "nested with")
                    elif isinstance(node, ast.Call):
                        _edge_for_call(node, held, info, model,
                                       meth_map, add_edge)
                        cb = _callback_loop_attr(node)
                        if cb is not None:
                            line = node.lineno
                            snippet = lines[line - 1].strip() \
                                if 0 < line <= len(lines) else ""
                            findings.append(Finding(
                                "D002", info.rel, line,
                                node.col_offset,
                                f"registered callbacks from "
                                f"`self.{cb}` run while holding "
                                f"{'/'.join(sorted(held))} — a sink "
                                f"that acquires a lock (the metrics "
                                f"histogram update) executes under "
                                f"the emitter's lock: the "
                                f"sink-reentrancy deadlock shape",
                                "snapshot the callback list under the "
                                "lock, invoke the callbacks after "
                                "releasing it",
                                snippet, stage="concurrency"))
                    elif isinstance(node, ast.Attribute) and \
                            isinstance(node.ctx, ast.Load):
                        parent = getattr(node, "_gl_parent", None)
                        if isinstance(parent, ast.Call) and \
                                parent.func is node:
                            continue  # handled as a call
                        name = node.attr
                        if name in _GENERIC_NAMES:
                            continue
                        targets = prop_map.get(name, set())
                        if len(targets) == 1:
                            add_edge(held, targets, info, node,
                                     f"property .{name}")
    return edges, findings


def _edge_for_call(call, held, info, model, meth_map, add_edge):
    func = call.func
    attr = _self_attr(func)
    if attr is not None:
        # exact: a same-class helper
        if model is not None and attr in model.methods:
            acq = _direct_acquires(model.methods[attr], info, model)
            add_edge(held, acq, info, call, f"self.{attr}()")
        return
    if isinstance(func, ast.Name):
        fn = info.mod_funcs.get(func.id)
        if fn is not None:
            acq = _direct_acquires(fn, info, None)
            # module fns can also take module locks of this file
            for node in _own_nodes(fn):
                if isinstance(node, ast.With):
                    for item in node.items:
                        acq |= info.lock_nodes(item.context_expr, None)
            add_edge(held, acq, info, call, f"{func.id}()")
        return
    if isinstance(func, ast.Attribute):
        name = func.attr
        if name in _GENERIC_NAMES:
            return
        targets = meth_map.get(name, set())
        if len(targets) == 1:
            add_edge(held, targets, info, call, f".{name}()")


# ------------------------------------------------------------------ cycles

def _find_cycles(edges) -> list[list[str]]:
    """Deduped simple cycles of the edge graph, as node paths
    (first node repeated at the end)."""
    adj: dict[str, list[str]] = {}
    for (src, dst) in edges:
        adj.setdefault(src, []).append(dst)
    for dsts in adj.values():
        dsts.sort()
    cycles, seen = [], set()

    def dfs(node, path, onpath, visited):
        for dst in adj.get(node, ()):
            if dst in onpath:
                cyc = path[path.index(dst):] + [dst]
                key = frozenset(cyc)
                if key not in seen:
                    seen.add(key)
                    cycles.append(cyc)
            elif dst not in visited:
                visited.add(dst)
                onpath.add(dst)
                dfs(dst, path + [dst], onpath, visited)
                onpath.discard(dst)

    for start in sorted(adj):
        dfs(start, [start], {start}, {start})
    return cycles


def _cycle_findings(cycles, edges) -> list[Finding]:
    out = []
    for cyc in cycles:
        chain_bits, rel0, line0 = [], "", 0
        for a, b in zip(cyc, cyc[1:]):
            rel, line, why = edges[(a, b)]
            if not rel0:
                rel0, line0 = rel, line
            chain_bits.append(f"{a} -> {b} ({rel}:{line}, {why})")
        out.append(Finding(
            "D001", rel0, line0, 0,
            "lock-order cycle — threads acquiring these locks in "
            "opposite order deadlock: " + "; ".join(chain_bits),
            "pick one global order for the locks in the cycle and "
            "acquire in that order everywhere (or drop to a single "
            "lock / release before the cross-acquisition)",
            "", stage="concurrency"))
    return out


# ------------------------------------------------------------------ frozen

def load_locks(path: str = LOCKS_PATH) -> list[str] | None:
    try:
        with open(path, encoding="utf-8") as fh:
            return list(json.load(fh).get("edges", []))
    except FileNotFoundError:
        return None


def write_locks(edge_strs, path: str = LOCKS_PATH) -> None:
    payload = {
        "_comment": "graftlint stage 4: blessed lock-order edges "
                    "(held -> acquired). Reviewed acquisition orders; "
                    "refreeze with port_tools/graftlint.py --update-locks. "
                    "A cycle among these can never be frozen — D001 "
                    "always fails the run.",
        "edges": sorted(edge_strs),
    }
    with open(path, "w", encoding="utf-8") as fh:
        json.dump(payload, fh, indent=1, sort_keys=True)
        fh.write("\n")


def _edge_strs(edges) -> list[str]:
    return sorted(f"{a} -> {b}" for (a, b) in edges)


# ------------------------------------------------------------------ entry

def _package_root() -> tuple[str, str]:
    pkg = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    return pkg, os.path.dirname(pkg)


def audit(locks_path: str = LOCKS_PATH):
    """Full package audit against the frozen edge set.

    Returns (findings, edge_strs). D001 for cycles, D002 for sink
    reentrancy, D003 for drift vs analysis/lock_order.json.
    """
    pkg, root = _package_root()
    edges, findings = _build([pkg], root)
    cycles = _find_cycles(edges)
    findings.extend(_cycle_findings(cycles, edges))
    cyclic_nodes = {n for cyc in cycles for n in cyc}

    cur = _edge_strs(edges)
    frozen = load_locks(locks_path)
    if frozen is None:
        findings.append(Finding(
            "D003", os.path.relpath(locks_path, root).replace(
                os.sep, "/"), 0, 0,
            "no frozen lock-order edge set — the lock graph is "
            "unreviewed",
            "inspect the current edges, then freeze them with "
            "port_tools/graftlint.py --update-locks",
            "", stage="concurrency"))
        return findings, cur
    frozen_set = set(frozen)
    for (a, b), (rel, line, why) in sorted(edges.items()):
        s = f"{a} -> {b}"
        if s in frozen_set or a in cyclic_nodes or b in cyclic_nodes:
            continue
        findings.append(Finding(
            "D003", rel, line, 0,
            f"new lock-order edge not in the frozen set: {s} "
            f"(via {why}) — a nested acquisition the last review "
            f"never blessed",
            "confirm the acquisition order is consistent "
            "everywhere, then refreeze with --update-locks",
            "", stage="concurrency"))
    for s in sorted(frozen_set - set(cur)):
        findings.append(Finding(
            "D003", "analysis/lock_order.json", 0, 0,
            f"stale frozen lock-order edge no longer in the code: {s}",
            "refreeze with --update-locks to drop it",
            "", stage="concurrency"))
    return findings, cur


def audit_paths(paths):
    """Fixture mode: audit explicit .py files with no frozen-set
    comparison — cycles (D001) and sink reentrancy (D002) only."""
    abspaths = [os.path.abspath(p) for p in paths]
    root = os.path.dirname(abspaths[0]) if abspaths else os.getcwd()
    edges, findings = _build(abspaths, root)
    findings.extend(_cycle_findings(_find_cycles(edges), edges))
    return findings, _edge_strs(edges)


def current_edges():
    """(edge_strs, by-edge site map) for the live package — what
    --update-locks freezes."""
    pkg, root = _package_root()
    edges, _ = _build([pkg], root)
    return _edge_strs(edges), edges
