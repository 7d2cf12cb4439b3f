"""The G001-G009 + G016-G024 + G029 + G030 AST rules of the port's
graftlint (G010-G015 + G018 live in spmd_rules.py, G025-G028 in
concurrency_rules.py, G031-G034 in precision_rules.py; all register into
ALL_RULES/RULE_DOCS at the bottom of this module). The counterpart of
deeplearning4j_tpu/analysis/ast_rules.py: same IDs, same Finding
contract, each rule reading the torch spelling of its JAX hazard.

Every rule errs toward PRECISION over recall: a lint gate that cries
wolf gets suppressed wholesale, while a quiet one keeps running in CI
forever. Each rule documents what it deliberately does not catch.

All name matching goes through the per-file import table (`Imports`), so
`import torch.nn.functional as F` / `import numpy as onp` spellings
resolve to canonical dotted paths before any rule looks at them. Like the
JAX table it skips relative imports (`from .walkers import ...`; the
port's graph/ uses them): a name bound that way is not resolved, so a
rule keyed on a canonical path does not see it there.

The rules, JAX spelling -> torch spelling:

- G001: `if`/`bool()`/`float()`/`int()` on a traced value in a jitted
  function -> the same on a tensor value (a torch call's result) in a
  hot path or a `torch.compile`d function: each is a device->host sync.
- G002: `.item()`, `np.asarray`, `jax.device_get` in ops/, parallel/,
  nn/layers/ -> `.item()`, `.cpu()`, `.tolist()`, `.numpy()`,
  `np.asarray`/`np.array`, `torch.cuda.synchronize` there.
- G003: dtype-less np constructors in jnp code -> in torch code
  (`torch.from_numpy` keeps their float64/int64).
- G004: np.random/random in traced code, a PRNG key reused -> global
  RNG state in device code: `np.random.*`/`random.*` draws,
  `torch.manual_seed`, torch draws with no `generator=`.
- G005: `jax.jit(f)(x)`, jit in a loop, unhashable static_argnums ->
  `torch.compile(f)(x)`, `torch.compile`/`torch.jit.script` in a loop;
  the static_argnums half has no counterpart (torch.compile takes none).
- G006: shard_map in_specs/out_specs arity -> no counterpart: the port
  has no shard_map; a split layer's shard runs the same eager function
  (ops/shard_scope.py).
- G007: version-moved jax symbols outside util/compat.py -> no
  counterpart: the port has no compat shim.
- G008: mutable defaults, module-level jnp allocations -> mutable
  defaults, module-level torch tensor allocations.
- G009: raw `jax.distributed.initialize`, env literals outside
  distributed/bootstrap.py -> raw `torch.distributed.
  init_process_group`/`destroy_process_group`, the port's env literals.
- G016: Pallas BlockSpec/grid literals > 128 outside ops/autotune.py ->
  BLOCK/TILE constants and launch keywords (`BLOCK_N=`) > 128 in ops/.
- G017, G019: unbucketed jit entries, per-request and per-token syncs
  in serving/ -> unbucketed compiled entries, torch's syncs.
- G020: `_batch_dict`/`globalize_batch`/`jax.device_put` in a `while
  has_next()` loop -> `_batch_dict`/`globalize_batch`/`.cuda()` there.
- G021, G023, G024: unchanged (the port's serving/fleet.py is blessed;
  the port's telemetry/recorder.py EVENT_KINDS/SPAN_NAMES; host sampling
  in decode loops).
- G022: `jax.sharding.Mesh(...)`, role-dict literals in examples/, cli/,
  elastic -> `DeviceMesh(...)`/`init_device_mesh`, role-dict literals.
- G029: memory_stats/live_arrays/memory_analysis in hot loops ->
  `torch.cuda.memory_stats`/`memory_allocated`/`mem_get_info`/... there.
- G030: `jnp.take` over a table, `syn0[idx]`, `zeros_like(T).at[].add()`
  -> `torch.index_select`/`F.embedding` over a table, `syn0[idx]`,
  `torch.zeros_like(T).index_add_()`.

G001-G009 parse; G006 and G007 keep their IDs in RULE_DOCS and find
nothing in an eager torch package (the table says why).
"""

from __future__ import annotations

import ast
import functools
import os
import re

from deeplearning4j_tpu_torch.analysis.core import Finding, walk

_PKG = "deeplearning4j_tpu_torch"
_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# Paths whose code runs per training step — the G002 host-sync scope.
HOT_PATH_FRAGMENTS = ("/ops/", "/parallel/", "/nn/layers/")

# Calls that compile a function (the counterparts of jax.jit).
COMPILE_NAMES = {"torch.compile", "torch.jit.script", "torch.jit.trace"}

# Attribute reads that return STATIC python values even on tensors.
_STATIC_ATTRS = {"shape", "ndim", "dtype", "size", "device", "is_cuda",
                 "layout", "requires_grad", "is_leaf", "grad_fn", "dim",
                 "numel", "nelement", "element_size", "stride",
                 "is_contiguous", "is_floating_point", "is_complex",
                 "data_ptr", "storage_offset", "get_device", "names",
                 "type"}
# Builtins whose result on a tensor is static.
_STATIC_CALLS = {"len", "isinstance", "type", "hasattr", "getattr", "id",
                 "repr", "str"}
# torch.* calls that return host values without touching tensor data.
_STATIC_TORCH_PREFIXES = ("torch.cuda.", "torch.distributed.",
                          "torch.backends.", "torch.jit.", "torch.compiler.",
                          "torch.autograd.", "torch.utils.",
                          "torch.testing.")
_STATIC_TORCH_CALLS = {"torch.is_tensor", "torch.is_grad_enabled",
                       "torch.get_default_dtype", "torch.finfo",
                       "torch.iinfo", "torch.device", "torch.Size",
                       "torch.is_floating_point", "torch.is_complex",
                       "torch.numel", "torch.promote_types",
                       "torch.result_type", "torch.can_cast",
                       "torch.is_inference_mode_enabled",
                       "torch.are_deterministic_algorithms_enabled",
                       "torch.get_num_threads", "torch.no_grad",
                       "torch.enable_grad", "torch.inference_mode",
                       "torch.Generator"}

_NP_CTORS = {"zeros", "ones", "empty", "full", "arange", "linspace",
             "eye", "identity"}

_MUTABLE_DEFAULT_CALLS = {"list", "dict", "set", "bytearray",
                          "defaultdict", "OrderedDict"}

# torch calls that ALLOCATE a tensor when run at module level.
_TORCH_ALLOC = {"torch." + n for n in
                _NP_CTORS | {"tensor", "as_tensor", "from_numpy", "stack",
                             "cat", "rand", "randn", "randint", "randperm",
                             "zeros_like", "ones_like", "empty_like"}}

# the host syncs of a tensor (device->host copies and scalar reads)
_SYNC_METHODS = {"item", "cpu", "tolist", "numpy"}
_SYNC_CALLS = {"torch.cuda.synchronize"}


class Imports:
    """Local alias -> canonical dotted module path, e.g. F ->
    torch.nn.functional, dist -> torch.distributed."""

    def __init__(self, tree: ast.AST):
        self.map: dict[str, str] = {}
        for node in walk(tree):
            if isinstance(node, ast.Import):
                for a in node.names:
                    if a.asname:
                        self.map[a.asname] = a.name
                    else:
                        root = a.name.split(".")[0]
                        self.map[root] = root
            elif isinstance(node, ast.ImportFrom) and node.module \
                    and node.level == 0:
                for a in node.names:
                    self.map[a.asname or a.name] = f"{node.module}.{a.name}"

    def canon(self, node: ast.AST) -> str | None:
        """Canonical dotted path of a Name/Attribute chain, or None."""
        parts = []
        while isinstance(node, ast.Attribute):
            parts.append(node.attr)
            node = node.value
        if not isinstance(node, ast.Name):
            return None
        parts.append(self.map.get(node.id, node.id))
        return ".".join(reversed(parts))


def _walk_with_parents(tree: ast.AST):
    for parent in walk(tree):
        for child in ast.iter_child_nodes(parent):
            child._gl_parent = parent  # type: ignore[attr-defined]
    return tree


def _parents(node: ast.AST):
    while True:
        node = getattr(node, "_gl_parent", None)
        if node is None:
            return
        yield node


@functools.lru_cache(maxsize=None)
def module_constants(relpath: str) -> dict:
    """Top-level constants of a port module, read by parsing it (never
    importing it, so the AST stage imports no torch): NAME = "str" as a
    str, NAME = frozenset({...}) / {...} of strings as a frozenset."""
    try:
        with open(os.path.join(_PKG_DIR, relpath), encoding="utf-8") as fh:
            tree = ast.parse(fh.read())
    except (OSError, SyntaxError):
        return {}
    out: dict = {}
    for node in tree.body:
        if not (isinstance(node, ast.Assign) and len(node.targets) == 1
                and isinstance(node.targets[0], ast.Name)):
            continue
        value = node.value
        if isinstance(value, ast.Call) and isinstance(value.func, ast.Name) \
                and value.func.id in ("frozenset", "set") and value.args:
            value = value.args[0]
        if isinstance(value, ast.Constant) and isinstance(value.value, str):
            out[node.targets[0].id] = value.value
        elif isinstance(value, (ast.Set, ast.Tuple, ast.List)) and all(
                isinstance(e, ast.Constant) and isinstance(e.value, str)
                for e in value.elts):
            out[node.targets[0].id] = frozenset(e.value for e in value.elts)
    return out


def _decorator_canon(deco: ast.AST, imports: Imports):
    """(canonical name, call node | None) for plain / called / partial-
    wrapped decorators: @torch.compile, @torch.compile(...),
    @partial(torch.compile, ...)."""
    if isinstance(deco, ast.Call):
        name = imports.canon(deco.func)
        if name in ("functools.partial", "partial") and deco.args:
            name = imports.canon(deco.args[0])
        return name, deco
    return imports.canon(deco), None


def _compiled_functions(tree: ast.AST, imports: Imports):
    """Every function decorated to be compiled (torch.compile /
    torch.jit.script): the counterpart of the JAX rules' traced
    functions."""
    for node in walk(tree):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)) and \
                any(_decorator_canon(d, imports)[0] in COMPILE_NAMES
                    for d in node.decorator_list):
            yield node


def _is_tensor_call(node: ast.Call, imports: Imports) -> bool:
    """A call whose result is a tensor: any `torch.*` function but the
    ones that return host values (device queries, dtype info, ...)."""
    name = imports.canon(node.func) or ""
    return (name.startswith("torch.")
            and name not in _STATIC_TORCH_CALLS
            and not name.startswith(_STATIC_TORCH_PREFIXES))


def _mentions_tensor(expr: ast.AST, tracked: set[str],
                     imports: Imports) -> bool:
    """Does `expr` read a tensor value (a torch call's result or a name
    bound to one) in a position that yields the tensor's data?
    `.shape`/`.dtype`/`.device`/... reads and len()/isinstance() calls
    are static and do not count."""
    def visit(node) -> bool:
        if isinstance(node, ast.Attribute) and node.attr in _STATIC_ATTRS:
            return False
        if _only_identity_tests(node):
            return False
        if isinstance(node, ast.Call):
            fname = imports.canon(node.func)
            if fname in _STATIC_CALLS:
                return False
            if _is_tensor_call(node, imports):
                return True
            return visit(node.func) or any(
                visit(a) for a in node.args) or any(
                visit(k.value) for k in node.keywords)
        if isinstance(node, ast.Name) and isinstance(node.ctx, ast.Load):
            return node.id in tracked
        return any(visit(c) for c in ast.iter_child_nodes(node))
    return visit(expr)


def _only_identity_tests(test: ast.AST) -> bool:
    """`x is None` / `x is not None` and and/or/not combinations thereof
    — identity, not value, so no sync."""
    if isinstance(test, ast.Compare):
        return all(isinstance(op, (ast.Is, ast.IsNot)) for op in test.ops)
    if isinstance(test, ast.BoolOp):
        return all(_only_identity_tests(v) for v in test.values)
    if isinstance(test, ast.UnaryOp) and isinstance(test.op, ast.Not):
        return _only_identity_tests(test.operand)
    return False


# calls whose result is a host value even when their argument is a
# tensor (the sync happens there, and G001/G002 report it there)
_HOST_RESULT_CALLS = {"int", "float", "bool", "len", "str", "tuple", "list",
                      "range", "sum", "max", "min", "abs", "round"}


def _is_tensor_expr(value: ast.AST, tracked: set[str],
                    imports: Imports) -> bool:
    if isinstance(value, ast.Call) and (
            (isinstance(value.func, ast.Name)
             and value.func.id in _HOST_RESULT_CALLS)
            or (isinstance(value.func, ast.Attribute)
                and value.func.attr in _SYNC_METHODS)):
        return False
    return _mentions_tensor(value, tracked, imports)


def bindings(fn: ast.AST) -> dict[str, list]:
    """name -> every value bound to it in `fn` (None for a binding with
    no expression: a parameter, a loop or comprehension variable, a
    `with ... as` target)."""
    values: dict[str, list] = {}

    def bind(target, value):
        if isinstance(target, (ast.Tuple, ast.List)) and isinstance(
                value, (ast.Tuple, ast.List)) and \
                len(target.elts) == len(value.elts):
            for t, v in zip(target.elts, value.elts):
                bind(t, v)
            return
        for n in walk(target):
            if isinstance(n, ast.Name):
                values.setdefault(n.id, []).append(value)

    args = fn.args
    for a in args.posonlyargs + args.args + args.kwonlyargs + [
            args.vararg, args.kwarg]:
        if a is not None:
            values.setdefault(a.arg, []).append(None)
    for node in walk(fn):
        if isinstance(node, ast.Assign):
            for tgt in node.targets:
                bind(tgt, node.value)
        elif isinstance(node, (ast.AugAssign, ast.AnnAssign)):
            bind(node.target, node.value)
        elif isinstance(node, (ast.For, ast.AsyncFor, ast.comprehension)):
            bind(node.target, None)
        elif isinstance(node, (ast.With, ast.AsyncWith)):
            for item in node.items:
                if item.optional_vars is not None:
                    bind(item.optional_vars, None)
        elif isinstance(node, ast.NamedExpr):
            bind(node.target, node.value)
    return values


def names_bound_only_to(fn: ast.AST, pred) -> set[str]:
    """Names every binding of which satisfies `pred(value, names)`, where
    `names` is the set found so far (so `y = f(x)` joins once `x` has).
    Fixpoint, bounded and order-insensitive."""
    values = bindings(fn)
    found: set[str] = set()
    for _ in range(4):
        before = len(found)
        for name, vals in values.items():
            if name not in found and all(
                    v is not None and pred(v, found) for v in vals):
                found.add(name)
        if len(found) == before:
            break
    return found


def _tensor_names(fn: ast.AST, imports: Imports) -> set[str]:
    """Names that hold tensors in `fn`: every binding of the name is a
    torch call's result, or an expression over such names (y =
    torch.sum(x) * 2). A name also bound to anything else — a loop or
    comprehension variable, a parameter, `int(...)` — is not tracked."""
    return names_bound_only_to(
        fn, lambda v, found: _is_tensor_expr(v, found, imports))


def _in_hot_path(path: str) -> bool:
    return any(frag in path for frag in HOT_PATH_FRAGMENTS)


# --------------------------------------------------------------- G001

def g001_tensor_bool(tree, imports, path):
    """Python control flow / bool()/float()/int() on tensor values in a
    hot path or a compiled function: each reads the tensor's data on the
    host — a device->host sync mid-step in eager code, a graph break (or
    a guard per value) under torch.compile. Not caught: tensors entering
    through parameters or attributes (only torch calls' results and
    names bound to them are seen)."""
    fns = [n for n in walk(tree)
           if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))] \
        if _in_hot_path(path) else list(_compiled_functions(tree, imports))
    out = []
    seen: set[int] = set()
    for fn in fns:
        tracked = _tensor_names(fn, imports)
        for node in walk(fn):
            if id(node) in seen:
                continue
            if isinstance(node, (ast.If, ast.While)):
                if _only_identity_tests(node.test):
                    continue
                if _mentions_tensor(node.test, tracked, imports):
                    seen.add(id(node))
                    kind = "if" if isinstance(node, ast.If) else "while"
                    out.append((node, f"python `{kind}` on a tensor value "
                                "(a device->host sync every time it runs)",
                                "use torch.where / masked arithmetic, or "
                                "decide on host values known before the "
                                "step"))
            elif isinstance(node, ast.Call) and isinstance(
                    node.func, ast.Name) and node.func.id in (
                    "bool", "float", "int") and node.args and \
                    _mentions_tensor(node.args[0], tracked, imports):
                seen.add(id(node))
                out.append((node, f"`{node.func.id}()` forces a tensor "
                            "value to a python scalar (device->host sync)",
                            "keep it as a 0-d tensor, or read it once "
                            "after the step"))
    return [("G001", n, m, f) for n, m, f in out]


# --------------------------------------------------------------- G002

def g002_host_sync(tree, imports, path):
    """Implicit device->host syncs in hot paths (ops/, parallel/,
    nn/layers/): .item(), .cpu(), .tolist(), .numpy(), np.asarray /
    np.array of a tensor and torch.cuda.synchronize stall the launch
    queue mid-step. Host-side setup code in those dirs carries an inline
    disable with its justification."""
    if not _in_hot_path(path):
        return []
    out = []
    for node in walk(tree):
        if not isinstance(node, ast.Call):
            continue
        name = imports.canon(node.func)
        if name in ("numpy.asarray", "numpy.array"):
            out.append(("G002", node,
                        f"`{name.replace('numpy', 'np')}` in a hot path "
                        "copies a tensor to the host (sync)",
                        "stay in torch, or move host conversion out of "
                        "the per-step path"))
        elif name in _SYNC_CALLS:
            out.append(("G002", node, f"`{name}` in a hot path is an "
                        "explicit device sync",
                        "order work with streams/events; sync once "
                        "outside the step loop"))
        elif isinstance(node.func, ast.Attribute) and \
                node.func.attr in _SYNC_METHODS and not node.args \
                and not node.keywords:
            out.append(("G002", node, f"`.{node.func.attr}()` in a hot "
                        "path blocks on the device value",
                        "keep the value on the card; read it after the "
                        "step"))
    return out


# --------------------------------------------------------------- G003

def g003_float64_drift(tree, imports, path):
    """dtype-less np constructors inside functions that also do torch
    math: np defaults to float64/int64, and `torch.from_numpy` /
    `torch.as_tensor` keep that dtype, so the host value either widens
    the whole expression to f64 or fails against an f32 operand. Not
    caught: promotion via python float literals."""
    out = []
    fns = [n for n in walk(tree)
           if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))]
    seen: set[int] = set()
    for fn in fns:
        uses_torch = any(
            isinstance(n, ast.Call) and _is_tensor_call(n, imports)
            for n in walk(fn))
        if not uses_torch:
            continue
        for node in walk(fn):
            if not isinstance(node, ast.Call) or id(node) in seen:
                continue
            name = imports.canon(node.func)
            if name and name.startswith("numpy.") and \
                    name.split(".")[-1] in _NP_CTORS and \
                    not any(kw.arg == "dtype" for kw in node.keywords) and \
                    len(node.args) < _ctor_dtype_pos(name):
                seen.add(id(node))
                out.append(("G003", node,
                            f"dtype-less `{name.replace('numpy', 'np')}` "
                            "in torch code defaults to float64/int64 "
                            "(torch.from_numpy keeps it)",
                            "pass an explicit dtype= (e.g. np.float32), "
                            "or build it with torch"))
    return out


def _ctor_dtype_pos(name: str) -> int:
    # positional index where dtype may be passed without the keyword
    return {"numpy.full": 3, "numpy.arange": 99, "numpy.linspace": 99,
            "numpy.eye": 99}.get(name, 2)


# --------------------------------------------------------------- G004

# dirs whose code runs on the card (or feeds it) per step: draws there
# must come from a seeded, owned generator
_G004_DEVICE_DIRS = ("/ops/", "/nn/", "/parallel/", "/serving/",
                     "/embedding/", "/models/", "/distributed/")
_G004_GLOBAL_SEED = {"torch.manual_seed", "torch.seed",
                     "torch.cuda.manual_seed", "torch.cuda.manual_seed_all",
                     "torch.random.manual_seed", "numpy.random.seed",
                     "random.seed"}
_G004_TORCH_DRAWS = {"torch." + n for n in (
    "rand", "randn", "randint", "randperm", "rand_like", "randn_like",
    "randint_like", "bernoulli", "multinomial", "normal", "poisson")}
_G004_TENSOR_DRAWS = {"uniform_", "normal_", "bernoulli_", "random_",
                      "exponential_", "geometric_", "cauchy_",
                      "log_normal_"}
# np.random entry points that build an OWNED generator (fine)
_G004_NP_OWNED = {"default_rng", "RandomState", "Generator", "SeedSequence",
                  "PCG64", "Philox", "MT19937", "SFC64", "BitGenerator"}


def g004_rng_discipline(tree, imports, path):
    """Global RNG state in device code (ops/, nn/, parallel/, serving/,
    embedding/, models/, distributed/): (a) a global reseed
    (`torch.manual_seed`, `np.random.seed`) — a library call that
    resets every caller's stream; (b) a draw from the global state
    (`np.random.rand(...)`, stdlib `random.random()`, a torch draw or an
    in-place `.uniform_()` with no `generator=`) — the stream depends on
    whatever ran before, so two ranks or two runs drift apart. The
    blessed shape is a seeded, owned generator threaded through
    (`torch.Generator(device).manual_seed(s)`, `np.random.default_rng(s)`).
    Not caught: an owned generator built with no seed."""
    if not any(d in "/" + path.replace("\\", "/")
               for d in _G004_DEVICE_DIRS):
        return []
    out = []
    for node in walk(tree):
        if not isinstance(node, ast.Call):
            continue
        name = imports.canon(node.func) or ""
        has_gen = any(kw.arg == "generator" for kw in node.keywords)
        if name in _G004_GLOBAL_SEED:
            out.append(("G004", node,
                        f"`{name}` reseeds the process-global RNG from "
                        "library code — every other caller's stream "
                        "restarts",
                        "seed an owned generator (torch.Generator(device)"
                        ".manual_seed(s) / np.random.default_rng(s)) and "
                        "thread it through"))
        elif name in _G004_TORCH_DRAWS and not has_gen:
            out.append(("G004", node,
                        f"`{name}` with no generator= draws from the "
                        "global torch RNG — the stream depends on what "
                        "ran before (ranks and runs drift apart)",
                        "pass the net's/engine's seeded torch.Generator "
                        "as generator="))
        elif isinstance(node.func, ast.Attribute) and \
                node.func.attr in _G004_TENSOR_DRAWS and not has_gen:
            out.append(("G004", node,
                        f"`.{node.func.attr}()` with no generator= draws "
                        "from the global torch RNG",
                        "pass a seeded torch.Generator as generator="))
        elif (name.startswith("numpy.random.")
              and name.split(".")[-1] not in _G004_NP_OWNED) or \
                (name.startswith("random.")
                 and name.split(".")[-1] not in ("Random", "SystemRandom")):
            out.append(("G004", node,
                        f"`{name}` draws from a process-global host RNG "
                        "in device code",
                        "draw from an owned np.random.default_rng(seed) "
                        "(or random.Random(seed)) threaded through"))
    return out


# --------------------------------------------------------------- G005

def g005_recompile_hazards(tree, imports, path):
    """Compiled-function re-creation per call — `torch.compile(f)(x)` or
    torch.compile / torch.jit.script inside a loop — recompiles (or at
    best re-guards) every invocation. The JAX rule's unhashable
    static_argnums half has no counterpart (torch.compile takes none).
    Not caught: a compiled function rebuilt in a function body called
    per step (the call site is out of AST scope)."""
    out = []
    for node in walk(tree):
        if not isinstance(node, ast.Call):
            continue
        name = imports.canon(node.func)
        if isinstance(node.func, ast.Call) and \
                imports.canon(node.func.func) in COMPILE_NAMES:
            out.append(("G005", node,
                        f"`{imports.canon(node.func.func)}(f)(...)` "
                        "creates and discards a compiled function every "
                        "call (a full recompile each time)",
                        "hoist the compiled function to module level or "
                        "cache it"))
        if name in COMPILE_NAMES:
            for anc in _parents(node):
                if isinstance(anc, (ast.For, ast.While)):
                    out.append(("G005", node,
                                f"`{name}` inside a loop body compiles a "
                                "fresh function per iteration",
                                "create the compiled function once, "
                                "outside the loop"))
                    break
                if isinstance(anc, (ast.FunctionDef,
                                    ast.AsyncFunctionDef, ast.Lambda)):
                    break
    return out


# --------------------------------------------------------------- G006

def g006_shard_map_arity(tree, imports, path):
    """No counterpart in the port (module docstring): it has no
    shard_map; a split layer's shard runs the same eager function.
    Kept under its ID; finds nothing."""
    return []


# --------------------------------------------------------------- G007

def g007_compat_bypass(tree, imports, path):
    """No counterpart in the port (module docstring): it has no compat
    shim (the JAX package's util/compat.py routes jax symbols that moved
    between jax versions). Kept under its ID; finds nothing."""
    return []


# --------------------------------------------------------------- G009

# the single home of the rendezvous layer; everything else routes
# through it (same shape as the JAX rule)
_RENDEZVOUS_HOME = "distributed/bootstrap.py"
_RENDEZVOUS_CALLS = {"torch.distributed.init_process_group",
                     "torch.distributed.destroy_process_group"}


def _rendezvous_env_vars() -> frozenset:
    """The env-var contract's spellings: the ENV_* constants of the
    port's distributed/bootstrap.py (parsed, not imported)."""
    consts = module_constants(_RENDEZVOUS_HOME)
    return frozenset(v for k, v in consts.items()
                     if k.startswith("ENV_") and isinstance(v, str))


def g009_rendezvous_routing(tree, imports, path):
    """Raw `torch.distributed.init_process_group` /
    `destroy_process_group` calls or hand-rolled rendezvous env plumbing
    (a literal DL4J_TPU_* contract variable) outside
    distributed/bootstrap.py. The bootstrap owns retry/backoff on
    connect, the backend choice (NCCL on CUDA, gloo on the CPU), the
    bounded timeout, the env-var contract and per-process telemetry — a
    raw call sidesteps all of them."""
    # the contract's home and this rule's own spelling of it are exempt
    if path.endswith((_RENDEZVOUS_HOME, "analysis/ast_rules.py")):
        return []
    env_vars = _rendezvous_env_vars()
    out = []
    for node in walk(tree):
        if isinstance(node, ast.Attribute):
            name = imports.canon(node)
            if name in _RENDEZVOUS_CALLS:
                out.append(("G009", node,
                            f"raw `{name}` bypasses the rendezvous "
                            "bootstrap (retry/backoff, backend, timeout, "
                            "env contract, telemetry)",
                            f"use {_PKG}.distributed.bootstrap."
                            "initialize()/shutdown()"))
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            if (node.module or "") == "torch.distributed" and any(
                    f"torch.distributed.{a.name}" in _RENDEZVOUS_CALLS
                    for a in node.names):
                out.append(("G009", node,
                            "raw `from torch.distributed import "
                            "init_process_group` bypasses the rendezvous "
                            "bootstrap",
                            f"use {_PKG}.distributed.bootstrap."
                            "initialize()/shutdown()"))
        elif isinstance(node, ast.Constant) and \
                isinstance(node.value, str) and node.value in env_vars:
            out.append(("G009", node,
                        f"rendezvous env var {node.value!r} spelled as a "
                        "literal — the contract's one spelling lives in "
                        "distributed/bootstrap.py",
                        "import the ENV_* constant from "
                        f"{_PKG}.distributed.bootstrap"))
    return out


# --------------------------------------------------------------- G008

def g008_import_time(tree, imports, path):
    """(a) mutable default args — shared across calls; (b) module-level
    torch tensor allocations — they run at IMPORT time, before the
    program has chosen a device (and a CUDA one sets up CUDA in every
    process that imports the module)."""
    out = []
    for node in walk(tree):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.Lambda)):
            for d in node.args.defaults + [
                    d for d in node.args.kw_defaults if d is not None]:
                bad = isinstance(d, (ast.List, ast.Dict, ast.Set,
                                     ast.ListComp, ast.DictComp,
                                     ast.SetComp))
                if isinstance(d, ast.Call) and isinstance(
                        d.func, ast.Name) and \
                        d.func.id in _MUTABLE_DEFAULT_CALLS:
                    bad = True
                if bad:
                    out.append(("G008", d,
                                "mutable default argument is shared "
                                "across calls",
                                "default to None; create inside the "
                                "function"))

    def scan(node):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.Lambda)):
            return
        if isinstance(node, ast.Call):
            name = imports.canon(node.func)
            if name in _TORCH_ALLOC or (
                    isinstance(node.func, ast.Attribute)
                    and node.func.attr == "cuda" and not node.args):
                out.append(("G008", node,
                            f"module-level `{name or '.cuda()'}` "
                            "allocates a tensor at import time (before "
                            "the program picks its device)",
                            "allocate lazily inside a function, or keep "
                            "the constant in numpy"))
        for child in ast.iter_child_nodes(node):
            scan(child)

    for stmt in getattr(tree, "body", []):
        scan(stmt)
    return out


# --------------------------------------------------------------- G016

# The one module allowed to hold tunable launch knobs: the tuning layer
# (table + heuristics + override hook). Kernels resolve their launch
# params through it; a literal elsewhere re-freezes a knob the
# kerneltune sweep can no longer reach.
_TUNING_LAYER = ("ops/autotune.py",)

# 128 is the structural tile (a warp-group's rows, the mma tiles'
# multiple); anything larger in a block position is a swept knob that
# belongs in the tuning layer.
_G016_STRUCTURAL_MAX = 128

# names that denote block/tile knobs: BLOCK_Q_MAX, _ROW_BLOCK,
# CHUNK_TILES, a Triton launch's BLOCK_N= keyword
_G016_CONST_RE = re.compile(r"BLOCK|TILE")


def _g016_literal_over(node: ast.AST):
    """Int literals > 128 anywhere inside a (possibly nested) tuple/list
    expression."""
    for sub in walk(node):
        if isinstance(sub, ast.Constant) and isinstance(sub.value, int) \
                and not isinstance(sub.value, bool) \
                and sub.value > _G016_STRUCTURAL_MAX:
            yield sub


def g016_hardcoded_block_literals(tree, imports, path):
    """Launch-size literals hardcoded in ops/ outside the tuning layer
    (ops/autotune.py): (a) int literals > 128 passed as a BLOCK/TILE
    launch keyword (`BLOCK_N=`, `*_TILE=`) to any call — a Triton
    launch must take the autotune-resolved value; (b) module-level
    UPPERCASE BLOCK/TILE constants in ops/ files bound to int (or
    int-tuple) literals > 128 — the swept
    defaults live in autotune.py. Not caught: literals laundered through
    arithmetic (512 * 1), launch params fixed inside csrc/ at compile
    time, or non-BLOCK-named constants — precision over recall."""
    norm = path.replace("\\", "/")
    if "/ops/" not in "/" + norm or any(norm.endswith(t)
                                        for t in _TUNING_LAYER):
        return []
    out = []
    for node in walk(tree):
        if not isinstance(node, ast.Call):
            continue
        for kw in node.keywords:
            if kw.arg and _G016_CONST_RE.search(kw.arg):
                for lit in _g016_literal_over(kw.value):
                    out.append(("G016", lit,
                                f"hardcoded launch literal {lit.value} "
                                f"(`{kw.arg}=`) outside the tuning layer "
                                "— a knob the kerneltune sweep cannot "
                                "reach",
                                "resolve the value through "
                                "ops/autotune.py and pass the variable"))
    for stmt in getattr(tree, "body", []):
        targets = []
        if isinstance(stmt, ast.Assign):
            targets = [t for t in stmt.targets if isinstance(t, ast.Name)]
            value = stmt.value
        elif isinstance(stmt, ast.AnnAssign) and isinstance(
                stmt.target, ast.Name) and stmt.value is not None:
            targets = [stmt.target]
            value = stmt.value
        else:
            continue
        for tgt in targets:
            if tgt.id.isupper() and _G016_CONST_RE.search(tgt.id):
                for lit in _g016_literal_over(value):
                    out.append(("G016", lit,
                                f"block/tile constant `{tgt.id}` "
                                f"hardcodes {lit.value} in a kernel "
                                "file — the swept defaults live in "
                                "the tuning layer",
                                "move the default to ops/autotune.py "
                                "and alias it here"))
    return out


# --------------------------------------------------------------- G017

# Serving hot-path discipline (serving/ only). The continuous-batching
# contract: requests are padded into the bucket lattice BEFORE any
# compiled call (else every novel length is a recompile), and results
# come back to host ONCE per batch (else N per-request device syncs
# serialize the pipeline). Exemptions are named, not inferred:
# bucket-shape dispatch (argument/function names mentioning
# bucket/batch/padded/warmup) and the batch-boundary fetch (a sync
# OUTSIDE a per-request loop).
_G017_REQUESTISH = re.compile(r"(^|_)(request|req|prompt)s?($|_|\b)",
                              re.IGNORECASE)
_G017_BUCKETISH = re.compile(r"bucket|batch|padded|warm", re.IGNORECASE)


def _g017_name_strings(node: ast.AST):
    for sub in walk(node):
        if isinstance(sub, ast.Name):
            yield sub.id
        elif isinstance(sub, ast.Attribute):
            yield sub.attr


def _g017_mentions(node: ast.AST, pattern) -> bool:
    return any(pattern.search(s) for s in _g017_name_strings(node))


def _g017_enclosing_fn_name(node: ast.AST) -> str:
    for cur in _parents(node):
        if isinstance(cur, (ast.FunctionDef, ast.AsyncFunctionDef)):
            return cur.name
    return ""


def _is_sync_call(node: ast.Call, imports) -> bool:
    return imports.canon(node.func) in _SYNC_CALLS or (
        isinstance(node.func, ast.Attribute)
        and node.func.attr in _SYNC_METHODS and not node.args)


def g017_serving_hot_path(tree, imports, path):
    """Serving hot-path rule (serving/ files only), two halves:

    (a) UNBUCKETED COMPILED ENTRY: a torch.compile'd callable invoked
        with an argument that mentions a request-ish name
        (request/req/prompt) and nothing bucket-ish
        (bucket/batch/padded/warm) — raw request data fed straight into
        a compiled function recompiles for each novel length.
    (b) PER-REQUEST HOST SYNC: `.item()` / `.cpu()` / `.tolist()` /
        `.numpy()` / `torch.cuda.synchronize` inside a for-loop that
        iterates request-ish values — N device round-trips per batch.
        The batch-boundary fetch (one copy per BATCH, outside such
        loops) never flags."""
    norm = path.replace("\\", "/")
    if "/serving/" not in norm:
        return []
    out = []
    compiled: set[str] = set()
    for node in walk(tree):
        if isinstance(node, ast.Assign) and isinstance(node.value, ast.Call) \
                and imports.canon(node.value.func) in COMPILE_NAMES:
            for tgt in node.targets:
                if isinstance(tgt, ast.Name):
                    compiled.add(tgt.id)
                elif isinstance(tgt, ast.Attribute):
                    compiled.add(tgt.attr)
    for node in walk(tree):
        if not isinstance(node, ast.Call):
            continue
        callee = node.func
        is_entry = (
            (isinstance(callee, ast.Name) and callee.id in compiled)
            or (isinstance(callee, ast.Attribute)
                and callee.attr in compiled)
            or (isinstance(callee, ast.Call)
                and imports.canon(callee.func) in COMPILE_NAMES))
        if not is_entry:
            continue
        if _G017_BUCKETISH.search(_g017_enclosing_fn_name(node)):
            continue
        for arg in list(node.args) + [kw.value for kw in node.keywords]:
            if _g017_mentions(arg, _G017_REQUESTISH) \
                    and not _g017_mentions(arg, _G017_BUCKETISH):
                out.append(("G017", node,
                            "unbucketed compiled entry: raw request data "
                            "fed straight into a compiled callable — "
                            "every novel request shape recompiles",
                            "pad the request into a bucket batch first "
                            "(serving/batcher.py assemble) and pass the "
                            "bucketed tensors"))
                break
    for loop in walk(tree):
        if not isinstance(loop, (ast.For, ast.AsyncFor)):
            continue
        if not (_g017_mentions(loop.target, _G017_REQUESTISH)
                or _g017_mentions(loop.iter, _G017_REQUESTISH)):
            continue
        for node in walk(loop):
            if isinstance(node, ast.Call) and _is_sync_call(node, imports):
                out.append(("G017", node,
                            "per-request host sync inside a request "
                            "loop: one device round-trip per request "
                            "serializes the serving pipeline",
                            "fetch ONCE per batch (one .cpu() of the "
                            "whole padded output — the batch-boundary "
                            "fetch) and distribute host-side rows"))
    return out


# --------------------------------------------------------------- G019

# Decode-loop discipline (serving/ only) — the generation-side twin of
# G017's host-sync half: ONE batch-boundary fetch of the whole
# next-token vector per step, then host-side distribution.
_G019_TOKENISH = re.compile(r"(^|_)(token|tok)s?($|_|\b)|decode",
                            re.IGNORECASE)


def g019_decode_loop_sync(tree, imports, path):
    """Per-token host syncs inside decode loops (serving/ files only):
    a for-loop whose target or iterable mentions token-ish names
    (token/tok/decode) containing `.item()` / `.cpu()` / `.tolist()` /
    `.numpy()` / `torch.cuda.synchronize`. The batch-boundary fetch —
    one copy of the whole step's token vector, OUTSIDE such loops —
    never flags."""
    norm = path.replace("\\", "/")
    if "/serving/" not in norm:
        return []
    out = []
    for loop in walk(tree):
        if not isinstance(loop, (ast.For, ast.AsyncFor)):
            continue
        if not (_g017_mentions(loop.target, _G019_TOKENISH)
                or _g017_mentions(loop.iter, _G019_TOKENISH)):
            continue
        for node in walk(loop):
            if isinstance(node, ast.Call) and _is_sync_call(node, imports):
                out.append(("G019", node,
                            "per-token host sync inside a decode loop: "
                            "one device round-trip per emitted token "
                            "serializes the generation pipeline behind "
                            "host latency",
                            "fetch the step's whole next-token vector "
                            "ONCE (one .cpu() at the batch boundary) "
                            "and distribute host-side values"))
    return out


# --------------------------------------------------------------- G020

# Input-pipeline discipline: the fit step loops ride
# data/pipeline.iter_prefetched, which runs batch conversion and the
# host->device copy on a prefetch thread. A synchronous conversion
# INSIDE a `while it.has_next():` step loop serializes host input work
# in front of every step.
_G020_CONVERTERS = frozenset({"_batch_dict", "_globalize_batch",
                              "globalize_batch", "globalize_full"})
# blessed: the pipeline's own synchronous fallback (depth 0 /
# async-unsupported iterators) and the host-prefetch adapter
_G020_BLESSED = (f"{_PKG}/data/",
                 f"{_PKG}/datasets/async_iterator.py")


def g020_sync_input_in_step_loop(tree, imports, path):
    """Synchronous batch conversion / device copy inside a fit step
    loop: a `while <x>.has_next():` loop containing a call to
    `_batch_dict` / `_globalize_batch` / `globalize_batch` /
    `globalize_full` or a `.cuda()` copy. Whole-epoch staging, per-window
    TBPTT conversion (a `for` over range), and batch-boundary fetches
    never flag — the rule keys on the step-loop shape itself."""
    norm = path.replace("\\", "/")
    if any(b in norm for b in _G020_BLESSED):
        return []
    out = []
    for loop in walk(tree):
        if not isinstance(loop, ast.While):
            continue
        has_next = any(
            isinstance(n, ast.Call) and isinstance(n.func, ast.Attribute)
            and n.func.attr == "has_next"
            for n in walk(loop.test))
        if not has_next:
            continue
        for node in walk(loop):
            if not isinstance(node, ast.Call):
                continue
            is_converter = (isinstance(node.func, ast.Attribute)
                            and node.func.attr in _G020_CONVERTERS) or \
                imports.canon(node.func) in _G020_CONVERTERS
            is_put = isinstance(node.func, ast.Attribute) and \
                node.func.attr == "cuda"
            if is_converter or is_put:
                out.append(("G020", node,
                            "synchronous batch conversion/device copy "
                            "inside a fit step loop: host input work "
                            "runs serially in front of every step "
                            "instead of overlapping compute",
                            "route the loop through data/pipeline."
                            "iter_prefetched so conversion and the "
                            "device copy run on the prefetch thread"))
    return out


# --------------------------------------------------------------- G021

# Weight-swap discipline: serving replicas read their params through the
# engine's double-buffered WeightStore (serving/fleet.py), read ONCE per
# batch so a live hot-swap flips between batches. A direct write to a
# live `.params` reference, or a `resume_from` restore into a serving
# net outside the blessed path, bypasses the standby restore, the shape
# validation, the atomic flip AND the `weight_swap` telemetry record.
_G021_BLESSED = (f"{_PKG}/serving/fleet.py",)


def g021_weight_swap_path(tree, imports, path):
    """Param publish/flip outside the blessed swap path (serving/ files
    only; serving/fleet.py exempt): (a) assignment to a `.params`
    attribute — a direct write to what a worker serves; (b) any
    `.resume_from(...)` call — restoring INTO a serving net must route
    through fleet.restore_for_serving / fleet.hot_swap. Reading params
    never flags."""
    norm = path.replace("\\", "/")
    if "/serving/" not in norm or any(b in norm for b in _G021_BLESSED):
        return []
    out = []
    for node in walk(tree):
        if isinstance(node, (ast.Assign, ast.AugAssign)):
            targets = (node.targets if isinstance(node, ast.Assign)
                       else [node.target])
            for t in targets:
                if isinstance(t, ast.Attribute) and t.attr == "params":
                    out.append((
                        "G021", node,
                        "direct write to a live param reference in "
                        "serving code: bypasses the WeightStore double "
                        "buffer — a replica mid-batch can observe a "
                        "half-swapped param set and there is no "
                        "validation, generation record, or rollback",
                        "publish through serving/fleet.py: "
                        "hot_swap(engine, ckpt) restores into a shadow "
                        "net, validates, and flips atomically"))
        elif isinstance(node, ast.Call) \
                and isinstance(node.func, ast.Attribute) \
                and node.func.attr == "resume_from":
            out.append((
                "G021", node,
                "resume_from on a net inside serving code: restores "
                "INTO the served params outside the blessed swap path "
                "(no double buffer, no shape validation, no "
                "weight_swap telemetry, old weights unrecoverable on a "
                "bad checkpoint)",
                "route restores through serving/fleet."
                "restore_for_serving (startup) or fleet.hot_swap "
                "(live)"))
    return out


# --------------------------------------------------------------- G022

# Placement discipline at the USER-FACING layers: examples/, cli/, and
# the elastic runtime are where mesh layouts get hand-guessed — the
# habit the placement search (reshard/search.py) retires. A raw
# `DeviceMesh(...)` / `init_device_mesh(...)` construction, or an
# axis-role dict literal fed to a mesh builder / set_mesh, bypasses
# Placement validation AND the search's ranking and telemetry.
_G022_SCOPE_FRAGMENTS = ("/examples/", "/cli/")
_G022_SCOPE_SUFFIXES = ("distributed/elastic.py",)
_G022_ROLE_NAMES = frozenset({"data", "model", "pipe", "seq", "expert"})
_G022_MESH_CALL_TAILS = frozenset({"DeviceMesh", "init_device_mesh",
                                   "make_mesh", "make_global_mesh",
                                   "set_mesh"})
_G022_RAW_MESH = frozenset({"torch.distributed.device_mesh.DeviceMesh",
                            "torch.distributed.device_mesh."
                            "init_device_mesh"})
_G022_BLESSED_TAILS = frozenset({"search_placement",
                                 "searched_global_mesh"})


def _g022_call_tail(func: ast.AST) -> str:
    if isinstance(func, ast.Attribute):
        return func.attr
    if isinstance(func, ast.Name):
        return func.id
    return ""


def _g022_is_blessed(node: ast.Call) -> bool:
    """Placement.of / Placement.from_json / search entry points."""
    func = node.func
    tail = _g022_call_tail(func)
    if tail in _G022_BLESSED_TAILS:
        return True
    if isinstance(func, ast.Attribute) and tail in ("of", "from_json"):
        base = func.value
        base_name = (base.attr if isinstance(base, ast.Attribute)
                     else getattr(base, "id", ""))
        return base_name == "Placement"
    return False


def _g022_role_dict(arg: ast.AST) -> bool:
    """A dict literal whose string keys are ALL placement roles (and at
    least one) — the hand-written axis/role map shape."""
    if not isinstance(arg, ast.Dict) or not arg.keys:
        return False
    keys = []
    for k in arg.keys:
        if not (isinstance(k, ast.Constant) and isinstance(k.value, str)):
            return False
        keys.append(k.value)
    return all(k in _G022_ROLE_NAMES for k in keys)


def g022_handrolled_placement(tree, imports, path):
    """Hand-constructed placements at the user-facing layers (examples/,
    cli/, distributed/elastic.py): (a) a raw torch `DeviceMesh(...)` /
    `init_device_mesh(...)` construction; (b) an axis-role dict literal
    passed to make_mesh / make_global_mesh / set_mesh. Route through
    `reshard.planner.Placement.of` (set_mesh consumes the Placement
    directly) or `search_placement`/`searched_global_mesh`, whose own
    calls are exempt."""
    norm = "/" + path.replace("\\", "/").lstrip("/")
    if not (any(f in norm for f in _G022_SCOPE_FRAGMENTS)
            or any(norm.endswith(s) for s in _G022_SCOPE_SUFFIXES)):
        return []
    out = []
    for node in walk(tree):
        if not isinstance(node, ast.Call) or _g022_is_blessed(node):
            continue
        name = imports.canon(node.func) or ""
        tail = _g022_call_tail(node.func)
        if name in _G022_RAW_MESH:
            out.append(("G022", node,
                        f"raw `{name}` construction in a user-facing "
                        "layer: the layout skips Placement validation "
                        "and the placement search's ranking + telemetry",
                        "declare the layout as Placement.of(...) and feed "
                        "it to set_mesh, or let search_placement pick "
                        "it"))
            continue
        if tail not in _G022_MESH_CALL_TAILS:
            continue
        for arg in list(node.args) + [k.value for k in node.keywords]:
            if _g022_role_dict(arg):
                out.append(("G022", node,
                            f"hand-written axis-role dict literal fed to "
                            f"`{tail}` in a user-facing layer — an "
                            "unvalidated, unranked mesh layout",
                            "build the layout with Placement.of "
                            "(set_mesh consumes it directly) or take "
                            "the search_placement winner"))
                break
    return out


# --------------------------------------------------------------- G023

# Telemetry schema discipline: the timeline tooling (telemetry/trace.py,
# port_tools/tracetool.py) classifies every record it merges by its
# event kind and span name. An event("...")/span("...") literal invented
# at a call site is a record the registered schema does not know. The
# registry itself (telemetry/) is exempt; dynamic names stay silent.
_G023_EXEMPT = (f"{_PKG}/telemetry/",)
_G023_REGISTRY = "telemetry/recorder.py"


def _g023_registered():
    """(EVENT_KINDS, SPAN_NAMES) of the port's telemetry/recorder.py,
    parsed, not imported. An unreadable registry disables the rule
    rather than crashing the lint."""
    consts = module_constants(_G023_REGISTRY)
    kinds, names = consts.get("EVENT_KINDS"), consts.get("SPAN_NAMES")
    if not isinstance(kinds, frozenset) or not isinstance(names, frozenset):
        return None
    return kinds, names


def _g023_str_arg(node: ast.AST):
    return node.value if (isinstance(node, ast.Constant)
                          and isinstance(node.value, str)) else None


def g023_unregistered_telemetry_names(tree, imports, path):
    """An `<obj>.event("<kind>")` whose kind literal is not a
    registered EVENT_KIND, or an `<obj>.span("<name>")` /
    `event("span", name="<name>")` whose name literal is not a
    registered SPAN_NAME, outside telemetry/. Non-literal names and
    non-string first arguments (`re.Match.span(0)`) never flag."""
    norm = path.replace("\\", "/")
    if any(b in norm for b in _G023_EXEMPT):
        return []
    sets = _g023_registered()
    if sets is None:
        return []
    event_kinds, span_names = sets
    out = []
    for node in walk(tree):
        if not isinstance(node, ast.Call) \
                or not isinstance(node.func, ast.Attribute) \
                or node.func.attr not in ("span", "event") \
                or not node.args:
            continue
        lit = _g023_str_arg(node.args[0])
        if lit is None:
            continue
        if node.func.attr == "span":
            if lit not in span_names:
                out.append(("G023", node,
                            f"span name {lit!r} is not in the registered "
                            "schema (telemetry/recorder.py SPAN_NAMES): "
                            "the timeline tooling cannot classify it",
                            "register the name in SPAN_NAMES first, or "
                            "reuse an existing span name"))
            continue
        if lit not in event_kinds:
            out.append(("G023", node,
                        f"event kind {lit!r} is not in the registered "
                        "schema (telemetry/recorder.py EVENT_KINDS): "
                        "merged timelines parse it as noise",
                        "register the kind in EVENT_KINDS first, or use "
                        "a typed Recorder method"))
        elif lit == "span":
            for kw in node.keywords:
                if kw.arg != "name":
                    continue
                name_lit = _g023_str_arg(kw.value)
                if name_lit is not None and name_lit not in span_names:
                    out.append(("G023", node,
                                f"span name {name_lit!r} (via "
                                "event(\"span\", name=...)) is not in "
                                "the registered schema "
                                "(telemetry/recorder.py SPAN_NAMES)",
                                "register the name in SPAN_NAMES first"))
    return out


# --------------------------------------------------------------- G024

# Sampling discipline (serving/ only): token selection belongs ON DEVICE
# in the one fused kernel (ops/fused_sampling.fused_sample, K12).
# Host-side sampling inside a decode loop ships the [slots, vocab]
# logits to the host every step and drifts from the kernel's
# tie-breaking.
_G024_HOST_RNG_PREFIXES = ("numpy.random.", "random.")
_G024_SORTISH_ATTRS = frozenset({"argsort", "cumsum"})
_G024_SORTISH_CALLS = frozenset({"numpy.argsort", "numpy.cumsum"})
_G024_LOGITSISH = re.compile(r"logit|prob|score", re.IGNORECASE)


def g024_host_sampling(tree, imports, path):
    """Host-side sampling in decode loops (serving/ files only): inside
    a for-loop whose target or iterable mentions token-ish names
    (token/tok/decode), flag `np.random.*` / `random.*` draws and
    `argsort`/`cumsum` calls over logits-ish values (logit/prob/score).
    The blessed path is ops/fused_sampling.fused_sample."""
    norm = path.replace("\\", "/")
    if "/serving/" not in norm:
        return []
    out = []
    for loop in walk(tree):
        if not isinstance(loop, (ast.For, ast.AsyncFor)):
            continue
        if not (_g017_mentions(loop.target, _G019_TOKENISH)
                or _g017_mentions(loop.iter, _G019_TOKENISH)):
            continue
        for node in walk(loop):
            if not isinstance(node, ast.Call):
                continue
            name = imports.canon(node.func) or ""
            if name.startswith(_G024_HOST_RNG_PREFIXES):
                out.append(("G024", node,
                            "host RNG draw inside a decode loop: token "
                            "selection off-device means a per-step "
                            "logit fetch and numpy-side sampling that "
                            "drifts from the kernel's tie-breaking",
                            "sample on the card via ops/fused_sampling."
                            "fused_sample (temperature/top-k/top-p in "
                            "one kernel) and distribute the returned "
                            "ids"))
                continue
            sortish = name in _G024_SORTISH_CALLS or (
                isinstance(node.func, ast.Attribute)
                and node.func.attr in _G024_SORTISH_ATTRS)
            if not sortish:
                continue
            over_logits = any(
                _g017_mentions(arg, _G024_LOGITSISH)
                for arg in list(node.args)
                + [kw.value for kw in node.keywords]) or (
                isinstance(node.func, ast.Attribute)
                and _g017_mentions(node.func.value, _G024_LOGITSISH))
            if over_logits:
                out.append(("G024", node,
                            "host-side top-k/top-p reconstruction "
                            "(argsort/cumsum over logits) inside a "
                            "decode loop",
                            "filter on the card via ops/fused_sampling."
                            "fused_sample — its top-k/top-p masking "
                            "runs in the same kernel as the sample"))
    return out


# --------------------------------------------------------------- G029

# Memory-introspection discipline — the observability twin of G002.
# Allocator queries walk the caching allocator's state (and
# `mem_get_info` calls into CUDA): host work that, inside a
# per-token/per-request loop or a compiled function, lands on the hot
# path. The blessed producers sample at batch boundaries
# (telemetry/memstat.py) or at warmup (telemetry/costbook.py).
_G029_BLESSED = (f"{_PKG}/telemetry/memstat.py",
                 f"{_PKG}/telemetry/costbook.py")
_G029_INTROSPECT = frozenset({"memory_stats", "memory_allocated",
                              "max_memory_allocated", "memory_reserved",
                              "max_memory_reserved", "mem_get_info",
                              "memory_snapshot", "memory_summary"})


def g029_memory_introspection_hot_path(tree, imports, path):
    """A `torch.cuda.memory_stats()` / `memory_allocated()` /
    `max_memory_allocated()` / `memory_reserved()` / `mem_get_info()` /
    `memory_snapshot()` call inside a compiled function or a
    per-token / per-request loop. Batch-boundary or warmup-time
    introspection stays silent — that IS the sampler contract — and the
    two blessed producer modules are exempt."""
    norm = path.replace("\\", "/")
    if norm.endswith(_G029_BLESSED):
        return []
    out = []
    seen: set[int] = set()

    def scan(scope, where):
        for node in walk(scope):
            if not isinstance(node, ast.Call) or id(node) in seen:
                continue
            attr = (node.func.attr
                    if isinstance(node.func, ast.Attribute) else None)
            if attr in _G029_INTROSPECT:
                seen.add(id(node))
                out.append((
                    "G029", node,
                    f"device-memory introspection ({attr}) inside "
                    f"{where}: an allocator walk on the hot path",
                    "sample at batch boundaries via telemetry/"
                    "memstat.py (MemorySampler.on_step/maybe_sample) "
                    "or harvest at warmup via telemetry/costbook.py, "
                    "then read the cached event/ledger"))

    for fn in _compiled_functions(tree, imports):
        scan(fn, "a compiled function")
    for loop in walk(tree):
        if not isinstance(loop, (ast.For, ast.AsyncFor)):
            continue
        if (_g017_mentions(loop.target, _G019_TOKENISH)
                or _g017_mentions(loop.iter, _G019_TOKENISH)
                or _g017_mentions(loop.target, _G017_REQUESTISH)
                or _g017_mentions(loop.iter, _G017_REQUESTISH)):
            scan(loop, "a per-token/per-request loop")
    return out


# --------------------------------------------------------------- G030

# Sparse-embedding discipline. An embedding step touches a handful of
# rows of a vocab-sized table; the two ways to lose that sparsity are
# (a) a dense gather over the full table outside the engine and (b)
# densifying the sparse gradient — `torch.zeros_like(table)
# .index_add_(0, idx, grads)` allocates (and, under "data", all-reduces)
# a full table-shaped buffer where the sparse bucket kind
# (parallel/overlap.plan_sparse_bucket) moves only (indices, values).
# The blessed sites own those patterns: the embedding engine, the
# legacy dense reference (nlp/lookup.py) and the device pipeline.
_G030_BLESSED = (f"{_PKG}/embedding/",
                 f"{_PKG}/nlp/lookup.py",
                 f"{_PKG}/nlp/device_pipeline.py")
_G030_TABLEISH = re.compile(
    r"^(syn0|syn1|syn1neg|embed(ding)?s?(_table)?|emb_table|"
    r"lookup_table|vocab_table)$")
_G030_TABLE_NAMES = frozenset({"syn0", "syn1", "syn1neg"})


def _g030_ident(node: ast.AST) -> str | None:
    """The identifier text of a table-ish operand: bare name, attribute
    leaf (`self.syn0`), or a constant subscript key (`params["table"]`)."""
    if isinstance(node, ast.Name):
        return node.id
    if isinstance(node, ast.Attribute):
        return node.attr
    if isinstance(node, ast.Subscript):
        sl = node.slice
        if isinstance(sl, ast.Constant) and isinstance(sl.value, str):
            return sl.value
    return None


def g030_dense_embedding_path(tree, imports, path):
    """A full-table gather (`torch.index_select(table, 0, idx)`,
    `F.embedding(idx, table)`, `syn0[idx]`) or a densified sparse
    gradient (`torch.zeros_like(table).index_add_(...)`) outside the
    embedding engine's blessed internals."""
    norm = path.replace("\\", "/")
    if any(b in norm if b.endswith("/") else norm.endswith(b)
           for b in _G030_BLESSED):
        return []
    out = []
    for node in walk(tree):
        if isinstance(node, ast.Call):
            name = imports.canon(node.func)
            table = None
            if name in ("torch.index_select", "torch.take") and node.args:
                table = node.args[0]
            elif name == "torch.nn.functional.embedding" and \
                    len(node.args) >= 2:
                table = node.args[1]
            ident = _g030_ident(table) if table is not None else None
            if ident and _G030_TABLEISH.match(ident):
                out.append((
                    "G030", node,
                    f"dense gather over the full embedding table "
                    f"({ident!r}) outside the engine: at ep>1 this "
                    "gathers every shard's rows on every rank",
                    "route lookups through embedding/engine.py "
                    "(ShardedEmbeddingEngine's masked partial gather)"))
            # (b) torch.zeros_like(T).index_add_(...) / .index_add(...)
            if isinstance(node.func, ast.Attribute) \
                    and node.func.attr in ("index_add_", "index_add") \
                    and isinstance(node.func.value, ast.Call) \
                    and imports.canon(node.func.value.func) in (
                        "torch.zeros_like", "numpy.zeros_like"):
                out.append((
                    "G030", node,
                    "sparse gradient densified into a table-shaped buffer "
                    "(zeros_like(table).index_add_(...)): allocates and "
                    "reduces the full vocab where only the touched rows "
                    "carry signal",
                    "keep gradients as (indices, values) pairs and move "
                    "them with parallel/overlap.sparse_bucket_reduce; "
                    "scatter per-shard inside embedding/engine.py"))
        elif isinstance(node, ast.Subscript) \
                and isinstance(node.ctx, ast.Load) \
                and isinstance(node.value, ast.Name) \
                and node.value.id in _G030_TABLE_NAMES:
            out.append((
                "G030", node,
                f"direct subscript gather over embedding table "
                f"{node.value.id!r} outside the blessed dense "
                "reference (nlp/lookup.py)",
                "use embedding/engine.py's sharded gather (or the "
                "EngineLookupView accessors)"))
    return out


# stage-3 AST rules (G010-G015, G018) live in spmd_rules.py and register
# here; the import sits below every helper they borrow lazily, so
# importing either module first resolves cleanly.
from deeplearning4j_tpu_torch.analysis.spmd_rules import (  # noqa: E402
    SPMD_RULE_DOCS,
    SPMD_RULES,
)
# stage-4 AST rules (G025-G028, host-concurrency) live in
# concurrency_rules.py and register the same way
from deeplearning4j_tpu_torch.analysis.concurrency_rules import (  # noqa: E402
    CONC_RULE_DOCS,
    CONC_RULE_IDS,
    CONC_RULES,
)
# stage-5 AST rules (G031-G034, precision discipline) live in
# precision_rules.py and register the same way
from deeplearning4j_tpu_torch.analysis.precision_rules import (  # noqa: E402
    PRECISION_RULE_DOCS,
    PRECISION_RULE_IDS,
    PRECISION_RULES,
)

ALL_RULES = [g001_tensor_bool, g002_host_sync, g003_float64_drift,
             g004_rng_discipline, g005_recompile_hazards,
             g006_shard_map_arity, g007_compat_bypass, g008_import_time,
             g009_rendezvous_routing,
             g016_hardcoded_block_literals,
             g017_serving_hot_path, g019_decode_loop_sync,
             g020_sync_input_in_step_loop,
             g021_weight_swap_path,
             g022_handrolled_placement,
             g023_unregistered_telemetry_names,
             g024_host_sampling,
             g029_memory_introspection_hot_path,
             g030_dense_embedding_path] + SPMD_RULES + CONC_RULES \
    + PRECISION_RULES

# JAX rule IDs the port keeps with no counterpart: each finds nothing in
# an eager torch package, for the reason its RULE_DOCS line gives.
NO_COUNTERPART = frozenset({"G006", "G007", "G012"})

RULE_DOCS = {
    "G001": "python control flow / bool()/float()/int() on tensor values "
            "in hot paths or compiled functions (a device->host sync)",
    "G002": "implicit host sync (.item/.cpu/.tolist/.numpy/np.asarray/"
            "torch.cuda.synchronize) in hot paths",
    "G003": "dtype-less np constructors mixed into torch code (float64 "
            "drift)",
    "G004": "global RNG state in device code: np.random/random draws, "
            "torch.manual_seed, torch draws without generator=",
    "G005": "per-call torch.compile creation / compile in a loop "
            "(recompiles)",
    "G006": "no counterpart: the port has no shard_map (a split layer's "
            "shard runs the same eager function), so no spec arity to "
            "check",
    "G007": "no counterpart: the port has no compat shim for "
            "version-moved symbols (JAX's util/compat.py)",
    "G008": "mutable default args; module-level torch tensor allocations",
    "G009": "raw torch.distributed.init_process_group / rendezvous env "
            "plumbing bypassing distributed/bootstrap.py",
    "G016": "launch-size literals (BLOCK/TILE constants and launch "
            "keywords) > 128 hardcoded in ops/ outside the tuning layer "
            "(ops/autotune.py)",
    "G017": "serving hot-path discipline: unbucketed compiled entries "
            "and per-request host syncs in serving/ (bucket dispatch "
            "and the batch-boundary fetch are exempt)",
    "G019": "decode-loop discipline: per-token host syncs "
            "(.item/.cpu/.tolist/.numpy) inside token-ish loops in "
            "serving/ — the per-step batch-boundary fetch is the "
            "blessed pattern",
    "G020": "synchronous globalize_batch/_batch_dict/.cuda() inside fit "
            "step loops (while has_next) bypassing the data/ input "
            "pipeline — the pipeline's own sync fallback and the "
            "AsyncDataSetIterator adapter are the blessed sites",
    "G021": "param publish/flip outside the blessed serving/fleet.py "
            "swap path: direct `.params` assignment or `resume_from` "
            "in serving/ bypasses the double-buffered WeightStore",
    "G022": "hand-constructed DeviceMesh/init_device_mesh / axis-role "
            "dict literals in the user-facing layers (examples/, cli/, "
            "distributed/elastic.py) outside Placement.of / "
            "search_placement",
    "G023": "telemetry event kinds / span names invented at the call "
            "site: an event(\"...\")/span(\"...\") string literal "
            "outside telemetry/ that is not in the registered schema "
            "(recorder.py EVENT_KINDS/SPAN_NAMES)",
    "G024": "sampling discipline: host-side token sampling "
            "(np.random/random draws, argsort/cumsum over logits) "
            "inside decode loops in serving/ — token selection belongs "
            "in the fused on-card kernel (ops/fused_sampling)",
    "G029": "memory-introspection discipline: torch.cuda.memory_stats/"
            "memory_allocated/mem_get_info/... inside compiled "
            "functions or per-token/per-request loops; the blessed "
            "producers are telemetry/memstat.py and "
            "telemetry/costbook.py",
    "G030": "sparse-embedding discipline: dense index_select/"
            "F.embedding/subscript gathers over full-vocab embedding "
            "tables, and sparse gradients densified via "
            "zeros_like(table).index_add_(...), outside the blessed "
            "engine internals (embedding/, nlp/lookup.py, "
            "nlp/device_pipeline.py)",
    **SPMD_RULE_DOCS,
    **CONC_RULE_DOCS,
    **PRECISION_RULE_DOCS,
}


def run_rules(tree: ast.AST, source: str, path: str,
              rules=None) -> list[Finding]:
    """All rules (or `rules`, a subset of ALL_RULES: one stage's family)
    over one parsed file -> raw findings (no suppression)."""
    _walk_with_parents(tree)
    imports = Imports(tree)
    lines = source.splitlines()
    findings = []
    for rule in ALL_RULES if rules is None else rules:
        for rule_id, node, message, fixit in rule(tree, imports, path):
            line = getattr(node, "lineno", 0)
            col = getattr(node, "col_offset", 0)
            snippet = lines[line - 1].strip() if 0 < line <= len(lines) \
                else ""
            stage = ("concurrency" if rule_id in CONC_RULE_IDS
                     else "precision" if rule_id in PRECISION_RULE_IDS
                     else "ast")
            findings.append(Finding(rule_id, path, line, col, message,
                                    fixit, snippet, stage=stage))
    findings.sort(key=lambda f: (f.path, f.line, f.rule))
    return findings
