"""graftlint stage 4, part 1: host-concurrency AST rules (G025-G028),
the port's counterpart of deeplearning4j_tpu/analysis/concurrency_rules.py.

The rules are threading-only, so they read the JAX package and the port
alike and find the same things in both (tests/test_torch_concurrency_lint.py
holds the two analyzers equal on every fixture and over the JAX tree).
The one difference is the set of device syncs G026 counts as blocking:
torch's (`torch.cuda.synchronize`, a tensor's `.item()`, `.cpu()`,
`.tolist()` and `.numpy()`, an Event's or Stream's `.synchronize()`) in
place of jax's (`jax.device_get`, `jax.block_until_ready`,
`jax.effects_barrier`).

The serving/data/fleet runtime is a threaded host program: worker loops,
dispatcher threads, checkpoint watchers and supervisors all share
mutable state under ad-hoc ``threading`` locks. These rules police the
race and liveness classes that the device-side stages (op budgets,
collective audit) cannot see:

G025  shared-attribute race — an attribute mutated with a
      read-modify-write (``+=``) on the thread side of a class and also
      touched from public methods with no common lock guard. The guard
      is *inferred*: a lock group "guards" an attribute when >= 90% of
      its mutation sites sit inside ``with self.<lock>:``; the stray
      sites (and unguarded public reads) are the findings. Plain
      wholesale assignment (``self.x = value``) is exempt from the
      read-side check — a single reference store/load is atomic under
      the GIL, which is exactly the WeightStore lock-free-reader design.

G026  blocking call under a held lock — ``queue.get/put``,
      ``Condition.wait`` (on a condition other than the held one),
      ``Thread.join``, ``Event.wait``, sockets/HTTP, ``subprocess``,
      ``time.sleep`` and torch device syncs inside a ``with <lock>:``
      body on the request/decode paths (serving/, data/, telemetry/).
      Invoking registered callbacks (sinks, collectors, listeners)
      while holding a lock is flagged too: the callback can block, or
      re-enter the lock (the D002 shape, caught here at the AST level).

G027  wait/notify/sleep discipline in serving/ and data/:
      ``Condition.wait`` outside a while-predicate loop (spurious
      wakeups), ``notify`` without holding the owning lock, and bare
      ``time.sleep`` polling loops — the spin-loop class the Channel
      rewrite removed; this rule keeps it out.

G028  thread-lifecycle discipline — a class that spawns a non-daemon
      thread must ``join`` it somewhere (or every interpreter exit
      hangs); a class that spawns a daemon thread must expose a
      stop/drain/close handle so externally visible resources (an open
      Recorder file, reserved PagePool pages) are released
      deterministically.

Everything here is pure stdlib ``ast`` — the stage runs with torch and
jax unimportable, like stage 1. ``ast_rules`` registers these rules into
ALL_RULES/RULE_DOCS at its module bottom (same pattern as
spmd_rules); helpers are imported lazily to keep that cycle clean.

The attribute->lock inference is public API (``guard_map`` /
``guard_map_for_file``): tests/test_torch_concurrency_lint.py pins the
inferred maps for PagePool, WeightStore, Channel, the engine workers,
Recorder and MetricsRegistry exactly, so a refactor that silently drops
a guard fails by name.
"""

from __future__ import annotations

import ast
import re

from deeplearning4j_tpu_torch.analysis.core import walk

# ------------------------------------------------------------------ model

_LOCK_CTORS = frozenset({"threading.Lock", "threading.RLock",
                         "threading.Semaphore",
                         "threading.BoundedSemaphore"})
_COND_CTORS = frozenset({"threading.Condition"})
_QUEUE_CTORS = frozenset({"queue.Queue", "queue.LifoQueue",
                          "queue.PriorityQueue", "queue.SimpleQueue"})
_EVENT_CTORS = frozenset({"threading.Event"})
_THREAD_CTORS = frozenset({"threading.Thread"})

_GUARD_RATIO = 0.9
_SINKISH = re.compile(r"sink|callback|listener|hook|collector|subscriber",
                      re.IGNORECASE)
_MUTATOR_METHODS = frozenset({"append", "appendleft", "extend", "insert",
                              "pop", "popleft", "remove", "discard", "add",
                              "clear", "update", "setdefault", "popitem"})
_HANDLE_NAMES = frozenset({"stop", "close", "drain", "shutdown", "retire",
                           "terminate", "cancel", "join"})

_G026_PATHS = ("serving/", "data/", "telemetry/")
_G027_PATHS = ("serving/", "data/")

_BLOCKING_CALLS = frozenset({
    "time.sleep",
    "subprocess.run", "subprocess.Popen", "subprocess.call",
    "subprocess.check_call", "subprocess.check_output",
    "socket.create_connection", "urllib.request.urlopen",
    "torch.cuda.synchronize",
})

# no-argument tensor methods that wait for the card (device->host
# copies and scalar reads), and an Event's or Stream's synchronize()
_BLOCKING_METHODS = frozenset({"item", "cpu", "tolist", "numpy",
                               "synchronize"})


def _in_paths(path: str, prefixes) -> bool:
    p = path.replace("\\", "/")
    return any(seg in p for seg in prefixes)


def _own_nodes(fn: ast.AST):
    """Nodes of *fn* without descending into nested def/class/lambda
    bodies (a nested worker loop runs on another thread, later)."""
    stack = list(ast.iter_child_nodes(fn))
    while stack:
        node = stack.pop()
        yield node
        if not isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                                 ast.ClassDef, ast.Lambda)):
            stack.extend(ast.iter_child_nodes(node))


def _parents(node: ast.AST):
    from deeplearning4j_tpu_torch.analysis.ast_rules import _parents as p
    return p(node)


def _self_attr(node: ast.AST) -> str | None:
    """'x' for a `self.x` attribute expression, else None."""
    if isinstance(node, ast.Attribute) and \
            isinstance(node.value, ast.Name) and node.value.id == "self":
        return node.attr
    return None


class _Site:
    """One mutation (or public read) of a shared attribute."""

    __slots__ = ("node", "kind", "fn", "method", "held", "in_init")

    def __init__(self, node, kind, fn, method, held, in_init):
        self.node = node        # the AST node, for line info
        self.kind = kind        # "aug" | "assign" | "call"
        self.fn = fn            # nearest enclosing function def
        self.method = method    # enclosing top-level method name
        self.held = held        # frozenset of lock-group names held
        self.in_init = in_init  # directly in the __init__ body


class ClassModel:
    """Locks, threads and shared-attribute sites of one class."""

    def __init__(self, node: ast.ClassDef, imports):
        self.node = node
        self.name = node.name
        self.methods: dict[str, ast.FunctionDef] = {
            item.name: item for item in node.body
            if isinstance(item, (ast.FunctionDef, ast.AsyncFunctionDef))}
        self.lock_groups: dict[str, str] = {}   # lock attr -> group name
        self.attr_types: dict[str, str] = {}    # attr -> queue/thread/...
        self.thread_sites: list[tuple] = []     # (call, daemon, method)
        self.entries: set[int] = set()          # id() of thread-side fns
        self._entry_nodes: list[tuple] = []     # (fn node, encl method)
        self._collect_locks(imports)
        self._collect_threads(imports)
        self._close_entries()
        self.sites: dict[str, list[_Site]] = {}
        self.public_reads: dict[str, list[_Site]] = {}
        self._collect_sites()

    # -- locks -------------------------------------------------------
    def _collect_locks(self, imports) -> None:
        # token -> attr names sharing one underlying lock; a Condition
        # built from an existing Lock joins that lock's token, so
        # Channel's two conditions over one Lock become ONE group.
        token_attrs: dict[tuple, set[str]] = {}
        for fn in self.methods.values():
            local_tokens: dict[str, tuple] = {}
            for node in walk(fn):
                if not isinstance(node, ast.Assign) or \
                        len(node.targets) != 1 or \
                        not isinstance(node.value, ast.Call):
                    continue
                ctor = imports.canon(node.value.func)
                tgt = node.targets[0]
                attr = _self_attr(tgt)
                if ctor in _LOCK_CTORS or ctor in _COND_CTORS:
                    token: tuple | None = None
                    if ctor in _COND_CTORS and node.value.args:
                        arg = node.value.args[0]
                        ref = _self_attr(arg)
                        if ref is not None:
                            token = ("attr", ref)
                        elif isinstance(arg, ast.Name):
                            token = local_tokens.get(arg.id)
                    if attr is not None:
                        if token is None:
                            token = ("attr", attr)
                        token_attrs.setdefault(token, set()).add(attr)
                        self.attr_types[attr] = (
                            "condition" if ctor in _COND_CTORS else "lock")
                    elif isinstance(tgt, ast.Name):
                        local_tokens[tgt.id] = ("local", id(fn), tgt.id)
                        token_attrs.setdefault(local_tokens[tgt.id], set())
                elif attr is not None:
                    if ctor in _QUEUE_CTORS:
                        self.attr_types[attr] = "queue"
                    elif ctor in _EVENT_CTORS:
                        self.attr_types[attr] = "event"
                    elif ctor in _THREAD_CTORS:
                        self.attr_types[attr] = "thread"
        for attrs in token_attrs.values():
            if not attrs:
                continue
            group = "|".join(sorted(attrs))
            for a in attrs:
                self.lock_groups[a] = group

    def group_of_expr(self, expr: ast.AST) -> str | None:
        attr = _self_attr(expr)
        if attr is not None:
            return self.lock_groups.get(attr)
        return None

    def held_groups(self, node: ast.AST) -> frozenset:
        """Lock groups lexically held at *node* (within its function)."""
        held = set()
        for p in _parents(node):
            if isinstance(p, (ast.FunctionDef, ast.AsyncFunctionDef,
                              ast.Lambda)):
                break
            if isinstance(p, ast.With):
                for item in p.items:
                    g = self.group_of_expr(item.context_expr)
                    if g:
                        held.add(g)
        return frozenset(held)

    # -- threads -----------------------------------------------------
    def _collect_threads(self, imports) -> None:
        for base in self.node.bases:
            if imports.canon(base) in _THREAD_CTORS and \
                    "run" in self.methods:
                fn = self.methods["run"]
                self._entry_nodes.append((fn, fn))
                self.thread_sites.append((self.node, True, "run"))
        for mname, fn in self.methods.items():
            for node in walk(fn):
                if not (isinstance(node, ast.Call)
                        and imports.canon(node.func) in _THREAD_CTORS):
                    continue
                daemon = any(
                    kw.arg == "daemon"
                    and isinstance(kw.value, ast.Constant)
                    and kw.value.value is True
                    for kw in node.keywords)
                if not daemon:
                    daemon = self._daemon_via_attr(node, fn)
                self.thread_sites.append((node, daemon, mname))
                target = next((kw.value for kw in node.keywords
                               if kw.arg == "target"), None)
                if target is None:
                    continue
                tattr = _self_attr(target)
                if tattr is not None and tattr in self.methods:
                    self._entry_nodes.append((self.methods[tattr], fn))
                elif isinstance(target, ast.Name):
                    for sub in walk(fn):
                        if isinstance(sub, ast.FunctionDef) and \
                                sub.name == target.id:
                            self._entry_nodes.append((sub, fn))
                            break

    @staticmethod
    def _daemon_via_attr(call: ast.Call, fn: ast.AST) -> bool:
        # `t = threading.Thread(...)` then `t.daemon = True`
        parent = getattr(call, "_gl_parent", None)
        if not (isinstance(parent, ast.Assign)
                and len(parent.targets) == 1
                and isinstance(parent.targets[0], ast.Name)):
            return False
        var = parent.targets[0].id
        for node in walk(fn):
            if isinstance(node, ast.Assign) and len(node.targets) == 1:
                tgt = node.targets[0]
                if isinstance(tgt, ast.Attribute) and \
                        tgt.attr == "daemon" and \
                        isinstance(tgt.value, ast.Name) and \
                        tgt.value.id == var and \
                        isinstance(node.value, ast.Constant) and \
                        node.value.value is True:
                    return True
        return False

    def _close_entries(self) -> None:
        # Transitive closure: from each thread entry, follow self.m()
        # calls (and sibling nested defs) -> those run thread-side too.
        work = list(self._entry_nodes)
        while work:
            fn, scope = work.pop()
            if id(fn) in self.entries:
                continue
            self.entries.add(id(fn))
            for node in walk(fn):
                if not isinstance(node, ast.Call):
                    continue
                attr = _self_attr(node.func)
                if attr is not None and attr in self.methods:
                    work.append((self.methods[attr], self.methods[attr]))
                elif isinstance(node.func, ast.Name):
                    for sub in walk(scope):
                        if isinstance(sub, ast.FunctionDef) and \
                                sub.name == node.func.id and sub is not fn:
                            work.append((sub, scope))
                            break

    # -- shared-attribute sites --------------------------------------
    def _enclosing(self, node: ast.AST):
        """(nearest def, enclosing top-level method name) of *node*."""
        fn, method = None, None
        for p in _parents(node):
            if isinstance(p, (ast.FunctionDef, ast.AsyncFunctionDef)):
                if fn is None:
                    fn = p
                if p.name in self.methods and self.methods[p.name] is p:
                    method = p.name
                    break
            elif isinstance(p, ast.ClassDef):
                break
        return fn, method

    def _collect_sites(self) -> None:
        init = self.methods.get("__init__")
        for node in walk(self.node):
            attr, kind = None, None
            if isinstance(node, ast.AugAssign):
                attr, kind = _self_attr(node.target), "aug"
            elif isinstance(node, ast.Assign):
                for tgt in node.targets:
                    a = _self_attr(tgt)
                    if a is not None:
                        attr, kind = a, "assign"
                    elif isinstance(tgt, ast.Subscript):
                        a = _self_attr(tgt.value)
                        if a is not None:
                            attr, kind = a, "call"
            elif isinstance(node, ast.Call) and \
                    isinstance(node.func, ast.Attribute) and \
                    node.func.attr in _MUTATOR_METHODS:
                a = _self_attr(node.func.value)
                if a is not None:
                    attr, kind = a, "call"
            if attr is None or attr in self.lock_groups:
                continue
            fn, method = self._enclosing(node)
            if fn is None:
                continue
            self.sites.setdefault(attr, []).append(_Site(
                node, kind, fn, method, self.held_groups(node),
                in_init=(init is not None and fn is init)))
        # public reads: Load of self.<attr> inside a public method
        for mname, fn in self.methods.items():
            if mname.startswith("_"):
                continue
            for node in walk(fn):
                a = _self_attr(node)
                if a is None or a in self.lock_groups or \
                        not isinstance(node.ctx, ast.Load):
                    continue
                nfn, _ = self._enclosing(node)
                self.public_reads.setdefault(a, []).append(_Site(
                    node, "read", nfn, mname, self.held_groups(node),
                    in_init=False))

    # -- inference ---------------------------------------------------
    def guard_map(self) -> dict[str, str]:
        """attr -> lock-group name, for attrs whose non-__init__
        mutation sites are >= 90% under one lock group."""
        out = {}
        for attr, sites in sorted(self.sites.items()):
            live = [s for s in sites if not s.in_init]
            if not live:
                continue
            counts: dict[str, int] = {}
            for s in live:
                for g in s.held:
                    counts[g] = counts.get(g, 0) + 1
            if not counts:
                continue
            best = max(sorted(counts), key=lambda g: counts[g])
            if counts[best] / len(live) >= _GUARD_RATIO:
                out[attr] = best
        return out


def _models(tree: ast.AST, imports) -> list[ClassModel]:
    cached = getattr(tree, "_gl_conc_models", None)
    if cached is None:
        cached = [ClassModel(n, imports) for n in walk(tree)
                  if isinstance(n, ast.ClassDef)]
        tree._gl_conc_models = cached  # type: ignore[attr-defined]
    return cached


def _module_locks(tree: ast.AST, imports) -> set[str]:
    """Names of module-level `X = threading.Lock()` style globals."""
    out = set()
    for node in tree.body if isinstance(tree, ast.Module) else []:
        if isinstance(node, ast.Assign) and len(node.targets) == 1 and \
                isinstance(node.targets[0], ast.Name) and \
                isinstance(node.value, ast.Call) and \
                imports.canon(node.value.func) in (_LOCK_CTORS |
                                                   _COND_CTORS):
            out.add(node.targets[0].id)
    return out


# ------------------------------------------------------------------ public

def guard_map(source: str) -> dict[str, dict[str, str]]:
    """{class name: {attr: guard lock group}} for *source* — the
    inference G025 runs on, exposed so tests can pin real classes."""
    from deeplearning4j_tpu_torch.analysis.ast_rules import (Imports,
                                                       _walk_with_parents)
    tree = _walk_with_parents(ast.parse(source))
    imports = Imports(tree)
    return {m.name: m.guard_map() for m in _models(tree, imports)
            if m.guard_map()}


def guard_map_for_file(path: str) -> dict[str, dict[str, str]]:
    with open(path, encoding="utf-8") as fh:
        return guard_map(fh.read())


# ------------------------------------------------------------------ G025

def g025_shared_attribute_race(tree, imports, path):
    out = []
    for model in _models(tree, imports):
        guards = model.guard_map()
        threaded = bool(model.entries)
        for attr, sites in sorted(model.sites.items()):
            live = [s for s in sites if not s.in_init]
            if not live:
                continue
            guard = guards.get(attr)
            if guard is not None:
                for s in live:
                    if guard not in s.held:
                        out.append((
                            "G025", s.node,
                            f"{model.name}.{attr} is guarded by "
                            f"`{guard}` at every other mutation site, "
                            f"but this one mutates it without the lock",
                            f"wrap the access in `with self."
                            f"{guard.split('|')[0]}:`"))
                if threaded and any(s.kind == "aug" for s in live):
                    for r in model.public_reads.get(attr, []):
                        if guard not in r.held:
                            out.append((
                                "G025", r.node,
                                f"{model.name}.{attr} (guard "
                                f"`{guard}`) is read in public method "
                                f"{r.method}() without the lock — "
                                f"read-modify-write state must be read "
                                f"under its guard",
                                f"wrap the read in `with self."
                                f"{guard.split('|')[0]}:`"))
            elif threaded:
                tside = [s for s in live
                         if s.kind == "aug" and id(s.fn) in model.entries]
                readers = sorted({r.method for r in
                                  model.public_reads.get(attr, [])})
                writers = sorted({s.method for s in live
                                  if s.method and
                                  not s.method.startswith("_")})
                if tside and (readers or writers):
                    s = tside[0]
                    who = ", ".join(f"{m}()" for m in
                                    (readers or writers))
                    out.append((
                        "G025", s.node,
                        f"{model.name}.{attr} is mutated with `+=` on "
                        f"the worker thread and accessed from {who} "
                        f"with no common lock — read-modify-write on a "
                        f"bare attribute loses updates under "
                        f"concurrency",
                        "guard every access with one dedicated lock "
                        "(`with self._lock:`), as PagePool does for "
                        "its counters"))
    return out


# ------------------------------------------------------------------ G026

def _local_ctor_types(fn: ast.AST, imports) -> dict[str, str]:
    out = {}
    for node in _own_nodes(fn):
        if isinstance(node, ast.Assign) and len(node.targets) == 1 and \
                isinstance(node.targets[0], ast.Name) and \
                isinstance(node.value, ast.Call):
            ctor = imports.canon(node.value.func)
            if ctor in _QUEUE_CTORS:
                out[node.targets[0].id] = "queue"
            elif ctor in _EVENT_CTORS:
                out[node.targets[0].id] = "event"
            elif ctor in _THREAD_CTORS:
                out[node.targets[0].id] = "thread"
            elif ctor in _COND_CTORS:
                out[node.targets[0].id] = "condition"
    return out


def _recv_type(expr, model, local_types) -> tuple[str | None, str | None]:
    """(kind, attr-or-var name) of a call receiver, best effort."""
    attr = _self_attr(expr)
    if attr is not None:
        if model is not None and attr in model.attr_types:
            return model.attr_types[attr], attr
        return None, attr
    if isinstance(expr, ast.Name):
        return local_types.get(expr.id), expr.id
    return None, None


def _callback_loop_attr(call: ast.Call) -> str | None:
    """Attr name when *call* invokes a loop variable drawn from
    `for cb in self.<sinks-ish>:` — dynamic fan-out under a lock."""
    if not isinstance(call.func, ast.Name):
        return None
    for p in _parents(call):
        if isinstance(p, (ast.FunctionDef, ast.AsyncFunctionDef,
                          ast.Lambda)):
            return None
        if isinstance(p, ast.For) and isinstance(p.target, ast.Name) \
                and p.target.id == call.func.id:
            attr = _self_attr(p.iter)
            if attr is not None and _SINKISH.search(attr):
                return attr
    return None


def g026_blocking_under_lock(tree, imports, path):
    if not _in_paths(path, _G026_PATHS):
        return []
    out = []
    mod_locks = _module_locks(tree, imports)
    by_class = {id(m.node): m for m in _models(tree, imports)}

    def enclosing_model(node):
        for p in _parents(node):
            if isinstance(p, ast.ClassDef):
                return by_class.get(id(p))
        return None

    for w in walk(tree):
        if not isinstance(w, ast.With):
            continue
        model = enclosing_model(w)
        held = set()
        for item in w.items:
            if model is not None:
                g = model.group_of_expr(item.context_expr)
                if g:
                    held.add(g)
            if isinstance(item.context_expr, ast.Name) and \
                    item.context_expr.id in mod_locks:
                held.add(item.context_expr.id)
        if not held:
            continue
        lock_desc = "/".join(sorted(held))
        fn = None
        for p in _parents(w):
            if isinstance(p, (ast.FunctionDef, ast.AsyncFunctionDef)):
                fn = p
                break
        local_types = _local_ctor_types(fn, imports) if fn else {}
        for body_stmt in w.body:
            if isinstance(body_stmt, (ast.FunctionDef,
                                      ast.AsyncFunctionDef,
                                      ast.ClassDef)):
                continue  # defined under the lock, runs later
            for node in [body_stmt] + list(_own_nodes(body_stmt)):
                if not isinstance(node, ast.Call):
                    continue
                label = None
                canon = imports.canon(node.func)
                if canon in _BLOCKING_CALLS:
                    label = canon
                elif isinstance(node.func, ast.Attribute) and \
                        node.func.attr in _BLOCKING_METHODS and \
                        not node.args and not node.keywords:
                    label = f".{node.func.attr}()"
                elif isinstance(node.func, ast.Attribute) and \
                        node.func.attr in ("get", "put", "join", "wait",
                                           "wait_for"):
                    kind, name = _recv_type(node.func.value, model,
                                            local_types)
                    meth = node.func.attr
                    if kind == "queue" and meth in ("get", "put", "join"):
                        if not any(kw.arg == "block" and
                                   isinstance(kw.value, ast.Constant) and
                                   kw.value.value is False
                                   for kw in node.keywords):
                            label = f"{name}.{meth}"
                    elif kind == "thread" and meth == "join":
                        label = f"{name}.join"
                    elif kind == "condition" and meth in ("wait",
                                                          "wait_for"):
                        # waiting on the lock you hold is the one
                        # correct blocking-under-lock pattern
                        grp = (model.lock_groups.get(name)
                               if model else None)
                        if grp is None or grp not in held:
                            label = f"{name}.{meth}"
                    elif kind == "event" and meth == "wait":
                        label = f"{name}.wait"
                if label is None:
                    cb_attr = _callback_loop_attr(node)
                    if cb_attr is not None:
                        out.append((
                            "G026", node,
                            f"registered callbacks from "
                            f"`self.{cb_attr}` are invoked while "
                            f"holding `{lock_desc}` — a callback that "
                            f"blocks or re-acquires a lock stalls or "
                            f"deadlocks every thread contending for it",
                            "snapshot the callback list under the "
                            "lock, then invoke outside it (the "
                            "Recorder sink fan-out pattern)"))
                        continue
                if label is not None:
                    out.append((
                        "G026", node,
                        f"blocking call `{label}` while holding "
                        f"`{lock_desc}` — every thread contending for "
                        f"the lock stalls behind this wait on the "
                        f"request/decode path",
                        "move the blocking call outside the `with` "
                        "block, or use the non-blocking variant and "
                        "retry at the batch boundary"))
    return out


# ------------------------------------------------------------------ G027

def g027_wait_discipline(tree, imports, path):
    if not _in_paths(path, _G027_PATHS):
        return []
    out = []
    by_class = {id(m.node): m for m in _models(tree, imports)}

    def enclosing_model(node):
        for p in _parents(node):
            if isinstance(p, ast.ClassDef):
                return by_class.get(id(p))
        return None

    def in_while(node):
        for p in _parents(node):
            if isinstance(p, (ast.FunctionDef, ast.AsyncFunctionDef,
                              ast.Lambda)):
                return False
            if isinstance(p, ast.While):
                return True
        return False

    for node in walk(tree):
        if not isinstance(node, ast.Call):
            continue
        canon = imports.canon(node.func)
        if canon == "time.sleep":
            if in_while(node):
                out.append((
                    "G027", node,
                    "bare time.sleep polling loop — burns a core "
                    "re-checking state and adds up to one full "
                    "interval of latency per item",
                    "block on the state change instead: "
                    "Condition.wait in a while-predicate loop, or "
                    "Event.wait(timeout) for stop-flag loops (the "
                    "Channel pattern)"))
            continue
        if not isinstance(node.func, ast.Attribute):
            continue
        model = enclosing_model(node)
        if model is None:
            continue
        attr = _self_attr(node.func.value)
        if attr is None or \
                model.attr_types.get(attr) != "condition":
            continue
        if node.func.attr == "wait" and not in_while(node):
            out.append((
                "G027", node,
                f"`{attr}.wait()` outside a while-predicate loop — "
                f"condition waits wake spuriously and on stale "
                f"notifies; the predicate must be re-checked",
                "wrap in `while not <predicate>: "
                f"self.{attr}.wait(...)` (or use wait_for)"))
        elif node.func.attr in ("notify", "notify_all"):
            grp = model.lock_groups.get(attr)
            if grp is not None and grp not in model.held_groups(node):
                out.append((
                    "G027", node,
                    f"`{attr}.{node.func.attr}()` without holding the "
                    f"owning lock — raises RuntimeError at runtime "
                    f"and races the waiter's predicate check",
                    f"notify inside `with self.{attr}:`"))
    return out


# ------------------------------------------------------------------ G028

def g028_thread_lifecycle(tree, imports, path):
    out = []
    for model in _models(tree, imports):
        if not model.thread_sites:
            continue
        has_join = any(
            isinstance(n, ast.Call) and
            isinstance(n.func, ast.Attribute) and n.func.attr == "join"
            for n in walk(model.node))
        has_handle = has_join or any(
            m in _HANDLE_NAMES for m in model.methods)
        for call, daemon, mname in model.thread_sites:
            if not daemon and not has_join:
                out.append((
                    "G028", call,
                    f"{model.name}.{mname} starts a non-daemon thread "
                    f"and the class never join()s it — interpreter "
                    f"shutdown blocks forever on the live thread",
                    "join the thread on the shutdown path, or mark it "
                    "daemon AND give the class a stop/close handle"))
            elif daemon and not has_handle:
                out.append((
                    "G028", call,
                    f"{model.name}.{mname} starts a daemon thread but "
                    f"the class has no stop/close/drain/join handle — "
                    f"resources the thread holds (open files, "
                    f"reserved pages) are torn down mid-operation at "
                    f"exit",
                    "add a stop()/close() that signals the loop and "
                    "joins the thread (CheckpointWatcher pattern)"))
    return out


# ------------------------------------------------------------------ registry

CONC_RULES = [g025_shared_attribute_race, g026_blocking_under_lock,
              g027_wait_discipline, g028_thread_lifecycle]

CONC_RULE_IDS = frozenset({"G025", "G026", "G027", "G028"})

CONC_RULE_DOCS = {
    "G025": "shared-attribute race: an attribute `+=`-mutated on the "
            "thread side of a class and touched from public methods "
            "with no common lock; guards are inferred (>=90% of "
            "mutation sites under one `with self._lock:` group) and "
            "the stray sites are the findings",
    "G026": "blocking call (queue.get/put, Condition.wait, join, "
            "Event.wait, socket/HTTP, subprocess, sleep, torch device "
            "sync: torch.cuda.synchronize, .item/.cpu/.tolist/.numpy, "
            "Event/Stream.synchronize) or registered-callback fan-out "
            "inside a held-lock body on the serving//data//telemetry/ "
            "request paths",
    "G027": "wait/notify/sleep discipline in serving/ and data/: "
            "Condition.wait outside a while-predicate loop, notify "
            "without the owning lock, bare time.sleep polling loops "
            "(the spin-loop class the Channel rewrite removed)",
    "G028": "thread-lifecycle discipline: non-daemon threads never "
            "joined on any shutdown path; daemon threads with no "
            "stop/drain/close handle for the resources they hold",
}
