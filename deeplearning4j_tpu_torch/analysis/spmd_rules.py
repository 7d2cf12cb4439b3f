"""The G010-G015 + G018 SPMD-divergence / fleet-robustness AST rules
(graftlint stage 3, AST side): the port's counterpart of
deeplearning4j_tpu/analysis/spmd_rules.py, with torch.distributed's names.

A program that issues different collective sequences on different ranks
hangs the whole fleet: an NCCL or gloo collective that one rank never
reaches blocks its peers until the process group's timeout, as a
rank-guarded XLA collective does. These rules catch the statically
visible shapes of that bug; the trace-level twin (a collective audit of
the eager step) is the next slice.

Like the stage-1 rules they are pure stdlib — importing this module
imports neither torch nor jax, so `port_tools/graftlint.py --stage ast`
stays a pre-commit fast path. Helpers shared with ast_rules.py are
imported lazily inside the rule functions (ast_rules registers these
rules at its module bottom).

The spellings, JAX -> port:

- collectives: `jax.lax.psum`, `all_gather`, `ppermute`, ... ->
  `torch.distributed.all_reduce`, `all_gather(_into_tensor)`,
  `reduce_scatter_tensor`, `broadcast`, `barrier`, `all_to_all_single`,
  `send`/`recv`/`isend`/`irecv`, `batch_isend_irecv`, and the port's
  wrappers in `ops/shard_comm.py` and `parallel/overlap.py`;
- meshes: `jax.make_mesh`, the package's `make_mesh` ->
  `torch.distributed.device_mesh.init_device_mesh`, `new_group`, the
  port's `parallel/mesh.make_mesh`, `distributed/global_mesh.
  make_global_mesh`;
- the rank: `jax.process_index()`, `process_id` ->
  `torch.distributed.get_rank()`, `process_id`, `process_index`,
  `rank`, the `DL4J_TPU_PROCESS_ID` env contract of the port's
  `distributed/bootstrap.py`, torch's `RANK`;
- host syncs: `.block_until_ready()`, `jax.device_get` -> `.item()`,
  `.cpu()`, `.tolist()`, `.numpy()`, `torch.cuda.synchronize`;
- `jax.jit` under a rank guard -> `torch.compile`/`torch.jit.script`;
- `jax.tree.map(np.asarray, params)` -> the port's `nn/tree.tree_map`
  of a host copy over a whole tree.

- G010: rank-dependent control flow guarding code that issues
  collectives, compiled-function creation, or mesh construction — the
  hang shape. Not caught: rank-divergent programs reached through calls
  the AST cannot see into.
- G011: host nondeterminism (time.*, os.urandom, unseeded np.random,
  uuid, id()/hash()) flowing into torch calls or mesh construction in
  distributed/, parallel/, nn/ — a per-process value fed to a seed or a
  shape diverges the ranks' programs. Not caught: taint through
  attributes or across function boundaries.
- G012: no counterpart. A torch.distributed collective names a
  ProcessGroup object, not an axis string that an enclosing scope must
  bind; an unbound group is a NameError at the call, which the rule's
  JAX form exists to pre-empt. The rule keeps its ID and finds nothing.
- G013: blocking host syncs (.item(), .cpu(), torch.cuda.synchronize)
  inside rank-conditional blocks — one rank stalls on a value whose
  producing collective the other ranks may never reach.
"""

from __future__ import annotations

import ast
import re

from deeplearning4j_tpu_torch.analysis.core import walk

_PKG = "deeplearning4j_tpu_torch"

# Collective-issuing calls, canonical (the per-file import table resolves
# `import torch.distributed as dist` spellings to these).
# the bucket planner's entry points (parallel/overlap.py): collectives
# for G010/G013/G014, and the blessed route G015 sends gradients through
PLANNER_CALLS = frozenset(
    f"{_PKG}.parallel.overlap.{n}" for n in (
        "bucketed_reduce", "sparse_bucket_reduce", "reduce_gradients",
        "pmean_float_leaves"))

COLLECTIVE_CALLS = frozenset(
    {"torch.distributed." + n for n in (
        "all_reduce", "all_gather", "all_gather_into_tensor",
        "all_gather_object", "reduce_scatter", "reduce_scatter_tensor",
        "broadcast", "broadcast_object_list", "barrier",
        "monitored_barrier", "all_to_all", "all_to_all_single", "reduce",
        "gather", "scatter", "send", "recv", "isend", "irecv",
        "batch_isend_irecv")}
    | {f"{_PKG}.ops.shard_comm.gather_rows",
       f"{_PKG}.ops.shard_comm._all_reduce_f32",
       f"{_PKG}.parallel.overlap.reduce_scatter",
       f"{_PKG}.parallel.overlap.all_gather"} | PLANNER_CALLS)

# Mesh construction — every process must build the identical mesh (and
# its process groups: `new_group` is itself collective), so a
# rank-guarded construction is the same hang shape as a collective.
MESH_CTORS = frozenset({
    "torch.distributed.device_mesh.init_device_mesh",
    "torch.distributed.device_mesh.DeviceMesh",
    "torch.distributed.new_group",
    f"{_PKG}.parallel.mesh.make_mesh",
    f"{_PKG}.distributed.global_mesh.make_global_mesh",
})

# Compiled-function creation (the counterpart of jax.jit under a rank
# guard): ranks that compile different programs issue different kernels
# and, with collectives inside, different collective sequences.
COMPILE_NAMES = frozenset({"torch.compile", "torch.jit.script",
                           "torch.jit.trace"})

_RANK_NAMES = frozenset({"process_id", "process_index", "rank",
                         "global_rank"})
_RANK_CALLS = frozenset({"torch.distributed.get_rank",
                         "torch.distributed.get_node_local_rank"})

_G011_SCOPE = ("/distributed/", "/parallel/", "/nn/")

# Host calls whose value differs per process (or per interpreter run —
# str hash is randomized by PYTHONHASHSEED, id() is an address).
_NONDET_CALLS = frozenset({
    "time.time", "time.time_ns", "time.monotonic", "time.monotonic_ns",
    "time.perf_counter", "time.perf_counter_ns", "os.urandom",
    "uuid.uuid1", "uuid.uuid4", "id", "hash",
})
# np.random entry points that are deterministic given their (seed) args.
_NONDET_SEEDABLE = frozenset({
    "numpy.random.default_rng", "numpy.random.RandomState",
})
_NONDET_EXEMPT_TAILS = frozenset({"seed", "default_rng", "RandomState",
                                  "Random", "get_state", "set_state"})

_BLOCKING_ATTRS = frozenset({"item", "cpu", "tolist", "numpy"})
_BLOCKING_CALLS = frozenset({"torch.cuda.synchronize"})

SPMD_RULE_IDS = frozenset({"G010", "G011", "G012", "G013", "G014",
                           "G015", "G018"})


def _env_rank_var() -> str:
    """The env contract's process-id variable, read from its single
    spelling (the port's distributed/bootstrap.py ENV_PROCESS_ID — the
    G009 contract), parsed, not imported, so the AST stage imports no
    torch."""
    from deeplearning4j_tpu_torch.analysis.ast_rules import module_constants

    return module_constants("distributed/bootstrap.py").get(
        "ENV_PROCESS_ID", "")


def _is_rank_expr(expr: ast.AST, imports) -> bool:
    """Does `expr` read this process's rank? Recognized spellings:
    torch.distributed.get_rank() (and any `.get_rank()` call),
    names/attrs `process_id`/`process_index`/`rank`/`global_rank`, and
    the DL4J_TPU_PROCESS_ID env contract (literal or the imported
    ENV_PROCESS_ID constant) or torch's own `RANK` variable."""
    rank_env = _env_rank_var()
    for node in walk(expr):
        if isinstance(node, ast.Call):
            if imports.canon(node.func) in _RANK_CALLS or (
                    isinstance(node.func, ast.Attribute)
                    and node.func.attr == "get_rank"):
                return True
        elif isinstance(node, ast.Name):
            if node.id in _RANK_NAMES:
                return True
            canon = imports.canon(node) or ""
            if canon.endswith(".ENV_PROCESS_ID"):
                return True
        elif isinstance(node, ast.Attribute) and node.attr in _RANK_NAMES:
            return True
        elif isinstance(node, ast.Constant) and isinstance(node.value, str) \
                and node.value in (rank_env, "process_id", "RANK"):
            return True
    return False


def _iter_executed(stmts):
    """Nodes that EXECUTE when the given statements run — skips nested
    def/lambda bodies (defining a function under a rank guard issues
    nothing; calling it elsewhere is out of AST scope)."""
    stack = list(stmts)
    while stack:
        node = stack.pop()
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.Lambda)):
            continue
        yield node
        stack.extend(ast.iter_child_nodes(node))


def _rank_conditionals(tree, imports):
    """Every if/while whose test reads the process rank."""
    for node in walk(tree):
        if isinstance(node, (ast.If, ast.While)) and \
                _is_rank_expr(node.test, imports):
            yield node


# --------------------------------------------------------------- G010

def g010_rank_divergent_control_flow(tree, imports, path):
    """Rank-dependent control flow around collectives / compiled-function
    creation / mesh construction: the ranks issue different programs and
    the first collective hangs the fleet until the process group's
    timeout. Rank-guarded host-side effects (logging, checkpoint IO) are
    deliberately NOT flagged."""
    out = []
    for cond in _rank_conditionals(tree, imports):
        for node in _iter_executed(cond.body + cond.orelse):
            if not isinstance(node, ast.Call):
                continue
            name = imports.canon(node.func)
            if name in COLLECTIVE_CALLS:
                what = f"collective `{name}`"
            elif name in MESH_CTORS:
                what = f"mesh construction `{name}`"
            elif name in COMPILE_NAMES:
                what = f"compiled-function creation `{name}`"
            else:
                continue
            out.append(("G010", cond,
                        f"rank-dependent control flow guards {what} "
                        f"(line {node.lineno}) — ranks issue different "
                        "collective sequences and the fleet hangs until "
                        "the process group times out",
                        "issue the identical collective/compile/mesh "
                        "program "
                        "on every process; keep rank branches to host-side "
                        "effects (logging, checkpoint IO)"))
    return out


# --------------------------------------------------------------- G011

def _is_nondet_call(node: ast.Call, imports) -> bool:
    name = imports.canon(node.func) or ""
    if name in _NONDET_CALLS:
        return True
    if name in _NONDET_SEEDABLE:
        return not (node.args or node.keywords)  # unseeded
    if name.startswith(("numpy.random.", "random.")):
        return name.rsplit(".", 1)[-1] not in _NONDET_EXEMPT_TAILS
    return False


def _walk_scope(scope):
    """Nodes of one lexical scope, not descending into nested defs."""
    stack = list(ast.iter_child_nodes(scope))
    while stack:
        node = stack.pop()
        yield node
        if not isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                                 ast.Lambda)):
            stack.extend(ast.iter_child_nodes(node))


def g011_host_nondeterminism(tree, imports, path):
    """Host nondeterminism flowing into torch calls or mesh construction
    in distributed/, parallel/, nn/: a time.*/os.urandom/
    unseeded-np.random/id()/hash() value differs per process, so feeding
    it to a seed, a shape or a mesh silently diverges the ranks'
    programs — the G010 hang without a visible branch.
    Taint tracking is per-scope and name-based (attributes and
    cross-function flow are out of scope)."""
    if not any(frag in path for frag in _G011_SCOPE):
        return []
    out = []
    scopes = [tree] + [n for n in walk(tree)
                       if isinstance(n, (ast.FunctionDef,
                                         ast.AsyncFunctionDef))]
    for scope in scopes:
        tainted: set[str] = set()
        for _ in range(4):  # bounded fixpoint, order-insensitive
            before = len(tainted)
            for node in _walk_scope(scope):
                if not isinstance(node, ast.Assign):
                    continue
                dirty = any(
                    (isinstance(c, ast.Call)
                     and _is_nondet_call(c, imports))
                    or (isinstance(c, ast.Name)
                        and isinstance(c.ctx, ast.Load)
                        and c.id in tainted)
                    for c in walk(node.value))
                if dirty:
                    for tgt in node.targets:
                        for n in walk(tgt):
                            if isinstance(n, ast.Name):
                                tainted.add(n.id)
            if len(tainted) == before:
                break
        for node in _walk_scope(scope):
            if not isinstance(node, ast.Call):
                continue
            name = imports.canon(node.func) or ""
            if not (name.startswith("torch.") or name in MESH_CTORS):
                continue
            for arg in list(node.args) + [k.value for k in node.keywords]:
                dirty = any(
                    (isinstance(c, ast.Call)
                     and _is_nondet_call(c, imports))
                    or (isinstance(c, ast.Name)
                        and isinstance(c.ctx, ast.Load)
                        and c.id in tainted)
                    for c in walk(arg))
                if dirty:
                    out.append(("G011", node,
                                f"host nondeterminism flows into `{name}` "
                                "— the value differs per process, so the "
                                "ranks' programs / meshes diverge",
                                "derive the value deterministically (seed "
                                "it, or broadcast rank-0's value through "
                                "the env contract) before it reaches "
                                "torch"))
                    break
    return out


# --------------------------------------------------------------- G012

def g012_unbound_axis_name(tree, imports, path):
    """No counterpart in the port (module docstring): torch.distributed
    collectives take a ProcessGroup object, never an axis-name string an
    enclosing scope must bind. Kept under its ID; finds nothing."""
    return []


# --------------------------------------------------------------- G013

def g013_rank_conditional_host_sync(tree, imports, path):
    """Blocking host syncs (.item() / .cpu() / .tolist() / .numpy() /
    torch.cuda.synchronize) under a rank condition: the blocking rank
    waits on a value whose producing collective the other ranks may
    never issue — the passive half of the G010 hang, and even when it
    resolves, it skews step pacing across the fleet."""
    out = []
    for cond in _rank_conditionals(tree, imports):
        for node in _iter_executed(cond.body + cond.orelse):
            if not isinstance(node, ast.Call):
                continue
            name = imports.canon(node.func) or ""
            blocking = name in _BLOCKING_CALLS or (
                isinstance(node.func, ast.Attribute)
                and node.func.attr in _BLOCKING_ATTRS and not node.args)
            if blocking:
                what = name if name in _BLOCKING_CALLS \
                    else f".{node.func.attr}()"
                out.append(("G013", node,
                            f"blocking host sync `{what}` inside a "
                            "rank-conditional block — the blocked rank "
                            "waits on device work the other ranks may "
                            "never schedule, skewing (or deadlocking) "
                            "the fleet",
                            "sync on every rank, or defer the host read "
                            "until after the collective step completes"))
    return out


# --------------------------------------------------------------- G014

# Calls whose failure must never be silently swallowed: a collective or
# rendezvous error is the fleet telling you a peer is gone — an
# overbroad handler that eats it turns a recoverable death into a
# divergent fleet (some ranks "succeeded", some are gone). Deliberately
# NOT included: destroy_process_group and teardown paths, where
# best-effort `except: pass` is the correct idiom.
_G014_SWALLOW_TRIGGERS = (COLLECTIVE_CALLS
                          | {"torch.distributed.init_process_group",
                             f"{_PKG}.distributed.bootstrap.initialize"})

_G014_OVERBROAD = frozenset({"Exception", "BaseException"})


def _handler_is_overbroad(handler: ast.ExceptHandler, imports) -> bool:
    if handler.type is None:  # bare `except:`
        return True
    name = imports.canon(handler.type)
    return name in _G014_OVERBROAD


def g014_swallowed_fleet_errors(tree, imports, path):
    """(a) bare/overbroad `except` that swallows (never re-raises)
    around collective or rendezvous-initialize calls — package-wide; and
    (b) `while True` retry loops in distributed/ that sleep inside an
    exception handler with no raise anywhere in the loop body — an
    uncapped retry (the bounded idiom is `bootstrap.Backoff`, whose
    exhausted budget makes the caller raise). Not caught: swallowing
    through helper functions the AST cannot see into, and loops bounded
    by non-`while True` conditions (those carry their own exit)."""
    out = []
    for node in walk(tree):
        if isinstance(node, ast.Try):
            trigger = None
            for sub in _iter_executed(node.body):
                if isinstance(sub, ast.Call) and \
                        imports.canon(sub.func) in _G014_SWALLOW_TRIGGERS:
                    trigger = imports.canon(sub.func)
                    break
            if trigger is None:
                continue
            for handler in node.handlers:
                if not _handler_is_overbroad(handler, imports):
                    continue
                if any(isinstance(s, ast.Raise)
                       for s in walk(handler)):
                    continue
                out.append(("G014", handler,
                            f"overbroad `except` swallows failures of "
                            f"`{trigger}` — a dead peer's error "
                            "disappears and the fleet diverges instead "
                            "of recovering",
                            "catch the narrow exception, or re-raise "
                            "after cleanup so the elastic supervisor "
                            "can classify the death"))
        elif isinstance(node, ast.While) and "/distributed/" in \
                path.replace("\\", "/"):
            test = node.test
            if not (isinstance(test, ast.Constant) and test.value is True):
                continue
            body_nodes = list(_iter_executed(node.body))
            has_handler = any(isinstance(s, ast.ExceptHandler)
                              for s in body_nodes)
            sleeps = any(isinstance(s, ast.Call)
                         and imports.canon(s.func) == "time.sleep"
                         for s in body_nodes)
            raises = any(isinstance(s, ast.Raise) for s in body_nodes)
            if has_handler and sleeps and not raises:
                out.append(("G014", node,
                            "`while True` retry loop sleeps on failure "
                            "with no raise path — an unreachable "
                            "coordinator retries forever instead of "
                            "dying classifiably",
                            "use bootstrap.Backoff (full jitter + "
                            "max-elapsed cap) and raise when pause() "
                            "returns False"))
    return out


# --------------------------------------------------------------- G015

# The two files allowed to issue collectives on gradient pytrees: the
# bucket planner (parallel/overlap.py — bucketed_reduce and the
# unbucketed reduce_gradients routing) and the train-step assembly that
# consumes it. Everything else must route through them, so the bucket
# schedule stays the single source of the per-rank gradient-collective
# sequence the stage-3 audit freezes.
_G015_BLESSED = (f"{_PKG}/parallel/overlap.py",
                 f"{_PKG}/nn/training.py")

# Identifier shapes that mean "this value is a gradient pytree" —
# precision over recall: `g`, `delta`, or `update` alone do not flag.
_G015_GRAD_NAME = re.compile(r"(?:^|_)(d?grads?|gradients?)(?:_|$|\d)",
                             re.IGNORECASE)


def _names_gradients(expr: ast.AST) -> bool:
    for node in walk(expr):
        ident = None
        if isinstance(node, ast.Name):
            ident = node.id
        elif isinstance(node, ast.Attribute):
            ident = node.attr
        if ident is not None and _G015_GRAD_NAME.search(ident):
            return True
    return False


def g015_handrolled_gradient_collective(tree, imports, path):
    """A collective call whose operand is a gradient pytree, outside the
    blessed bucket-planner sites (parallel/overlap.py, nn/training.py):
    hand-rolled gradient reductions fork the per-rank collective
    sequence away from the frozen bucket schedule — the C001/C003 drift
    class at its source. Detection is name-based (an operand expression
    mentioning grads/gradients); collectives on losses, params, or
    activations never flag."""
    norm = path.replace("\\", "/")
    if any(norm.endswith(b) for b in _G015_BLESSED):
        return []
    out = []
    for node in walk(tree):
        if not isinstance(node, ast.Call):
            continue
        name = imports.canon(node.func) or ""
        if name not in COLLECTIVE_CALLS or name in PLANNER_CALLS:
            continue
        operands = list(node.args) + [k.value for k in node.keywords
                                      if k.arg not in ("group", "op")]
        if any(_names_gradients(arg) for arg in operands):
            out.append(("G015", node,
                        f"hand-rolled collective `{name}` on a gradient "
                        "pytree outside parallel/overlap.py / "
                        "nn/training.py — gradient reductions must route "
                        "through the bucket planner so every rank issues "
                        "the frozen per-bucket collective sequence",
                        "call parallel/overlap.bucketed_reduce (or "
                        "reduce_gradients for the unbucketed tree mean) "
                        "instead of issuing the collective directly"))
    return out


# --------------------------------------------------------------- G018

# The blessed full-tree host-materialization sites: the portable
# resharding engine and the two checkpoint formats. Everywhere else, a
# whole-param-tree host materialization defeats the resharding engine's
# guarantee (spanning-mesh restores never materialize full params on
# host) and reintroduces the gather-everything-to-host scaling wall the
# reshard/ subsystem exists to remove.
# (the port's checkpoint formats are util/checkpoint.py and
# util/model_serializer.py; weights_io.py carries trees across packages)
_G018_BLESSED = (f"{_PKG}/reshard/",
                 f"{_PKG}/util/checkpoint.py",
                 f"{_PKG}/util/model_serializer.py",
                 f"{_PKG}/weights_io.py")

# identifiers that denote a WHOLE param/optimizer tree (a bare name or
# a terminal attribute like `net.params`); subscripts (`params["W"]`)
# and calls are single leaves / derived values and never flag.
_G018_TREE_NAMES = frozenset({"params", "opt_state", "param_tree",
                              "params_tree", "opt_tree"})

_G018_MATERIALIZERS = frozenset({"numpy.asarray", "numpy.array"})
_G018_TREE_MAP = frozenset({f"{_PKG}.nn.tree.tree_map",
                            "torch.utils._pytree.tree_map"})
_G018_HOST_METHODS = frozenset({"cpu", "numpy", "tolist"})


def _g018_is_whole_tree(expr: ast.AST) -> bool:
    if isinstance(expr, ast.Name):
        return expr.id in _G018_TREE_NAMES
    if isinstance(expr, ast.Attribute):
        return expr.attr in _G018_TREE_NAMES
    return False


def _g018_is_materializer(expr: ast.AST, imports) -> bool:
    """np.asarray-like references, and lambdas whose body copies to
    the host (`lambda t: t.cpu()`, `.numpy()`, `.tolist()`)."""
    name = imports.canon(expr) or ""
    if name in _G018_MATERIALIZERS:
        return True
    if isinstance(expr, ast.Lambda):
        return any(isinstance(sub, ast.Call)
                   and (isinstance(sub.func, ast.Attribute)
                        and sub.func.attr in _G018_HOST_METHODS
                        or (imports.canon(sub.func) or "")
                        in _G018_MATERIALIZERS)
                   for sub in walk(expr.body))
    return isinstance(expr, ast.Attribute) and expr.attr == "asarray"


def g018_full_tree_host_materialization(tree, imports, path):
    """Full-parameter host materialization outside the blessed
    reshard/ + checkpoint paths: (a) any `host_materialize(...)` call,
    (b) `np.asarray` whose operand IS a whole params/opt_state tree (a
    bare name or `net.params`-style attribute), (c) `tree_map(np.asarray
    | lambda t: t.cpu(), <tree>)` — the leaf-at-a-time spelling of the
    same gather. Single-leaf reads
    (`params["W"]`), derived values, and per-leaf loops are deliberately
    not caught (precision over recall); route tree-level moves through
    `reshard/` (live) or `resume_from(..., target_mesh=...)`
    (checkpoint) instead."""
    norm = path.replace("\\", "/")
    if any(b in norm for b in _G018_BLESSED):
        return []
    out = []
    for node in walk(tree):
        if not isinstance(node, ast.Call):
            continue
        name = imports.canon(node.func) or ""
        is_hm = (name.endswith(".host_materialize")
                 or name == "host_materialize")
        if is_hm:
            out.append(("G018", node,
                        "`host_materialize` outside the blessed reshard/"
                        " + checkpoint paths gathers the full param tree "
                        "to host — the scaling wall the portable "
                        "resharding engine removes",
                        "restore/move through reshard/ (net.resume_from("
                        "dir, target_mesh=...) or "
                        "reshard.executor.reshard_net_live)"))
            continue
        if name in _G018_MATERIALIZERS:
            if any(_g018_is_whole_tree(a) for a in node.args):
                out.append(("G018", node,
                            f"`{name}` over a whole param/optimizer tree "
                            "materializes every shard on host",
                            "keep the tree on device; reshard through "
                            "reshard/ or read single leaves explicitly"))
            continue
        if (name in _G018_TREE_MAP or name.endswith(".tree_map")
                or name == "tree_map") and len(node.args) >= 2 \
                and _g018_is_materializer(node.args[0], imports) \
                and any(_g018_is_whole_tree(a) for a in node.args[1:]):
            out.append(("G018", node,
                        "tree-mapped host materialization "
                        "(`tree_map(lambda t: t.cpu(), <param tree>)`) — "
                        "the leaf-at-a-time spelling of a full-tree "
                        "host gather",
                        "keep the tree on device; reshard through "
                        "reshard/ instead of materializing"))
    return out


SPMD_RULES = [g010_rank_divergent_control_flow, g011_host_nondeterminism,
              g012_unbound_axis_name, g013_rank_conditional_host_sync,
              g014_swallowed_fleet_errors,
              g015_handrolled_gradient_collective,
              g018_full_tree_host_materialization]

SPMD_RULE_DOCS = {
    "G010": "rank-dependent control flow guarding torch.distributed "
            "collectives/torch.compile/mesh construction (fleet hang "
            "shape)",
    "G011": "host nondeterminism (time/urandom/unseeded rng/id/hash) "
            "flowing into torch calls or mesh construction",
    "G012": "no counterpart: a torch.distributed collective names a "
            "ProcessGroup object, not an axis string a scope must bind",
    "G013": "blocking host sync (.item/.cpu/.tolist/.numpy/"
            "torch.cuda.synchronize) inside rank-conditional blocks",
    "G014": "overbroad except swallowing collective/rendezvous errors; "
            "uncapped retry loops in distributed/",
    "G015": "hand-rolled collective on a gradient pytree outside "
            "parallel/overlap.py / nn/training.py (the blessed bucket-"
            "planner sites)",
    "G018": "full-parameter host materialization (host_materialize / "
            "np.asarray / tree_map of .cpu() over whole param trees) "
            "outside "
            "the blessed reshard/ + checkpoint paths",
}
