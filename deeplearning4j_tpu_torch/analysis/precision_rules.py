"""graftlint stage 5, AST side: the G031-G034 precision-discipline
rules, the port's counterpart of deeplearning4j_tpu/analysis/
precision_rules.py with torch's casts.

The mixed-precision surface (bf16 operands with f32 accumulators, the
int8 paged KV cache with per-(row, page, head) scales) is enforced by
convention — and a convention is exactly what a refactor silently drops.
These rules freeze the statically visible half of the dtype policy; the
trace-level half (a precision audit of the eager step) is the next
slice.

Pure stdlib ``ast`` like stages 1/4 — importing this module imports
neither torch nor jax. ``ast_rules`` registers these rules into
ALL_RULES/RULE_DOCS at its module bottom; shared helpers are imported
lazily inside the rule bodies.

The spellings, JAX -> port:

- contractions: `jnp.einsum`/`matmul`/`dot`/`lax.dot_general` without
  `preferred_element_type`, `@` -> `torch.einsum`/`matmul`/`bmm`/`mm`,
  a tensor's `.matmul`/`.bmm`/`.mm`, `@`, unless every operand is cast
  to f32 at the call (`.float()`, `.to(torch.float32)`, a view of one,
  or a name bound only to one): torch has no accumulator argument, so
  the f32 operands are the declaration;
- float64: `jnp.float64`, `.astype(float64)`, `dtype=float64` ->
  `torch.float64`/`torch.double`, `.double()`, `.to("float64")`,
  `dtype="float64"` on a torch call, `np.float64` constructors in device
  dirs;
- the int8 clamp: `jnp.clip(x, -127, 127)` -> `torch.clamp`/`.clamp`/
  `.clip` with ±127;
- tree casts: `jax.tree.map(lambda t: t.astype(...), params)` -> the
  port's `nn/tree.tree_map(lambda t: t.to(...), params)` (or `.float()`,
  `.bfloat16()`, ...).

- G031: a contraction in the kernel dirs (ops/, embedding/) whose
  operands are not cast to f32 where it is written — the accumulator
  and output dtype left to the operands'. A bf16 pair then rounds its
  result to bf16, the silent-precision class the f32-accumulation
  policy exists to prevent.
- G032: float64 entering DEVICE code. Host-side numpy analytics
  (clustering/, graph/, util/ math helpers) legitimately run f64 and
  stay out of scope; gradientcheck/'s f64 finite differences are
  blessed; declarative name->dtype registry tables (a dict literal
  keyed by dtype-name strings) are exempt — the drift happens where a
  literal f64 dtype is APPLIED, which the op audit's J003 then proves.
- G033: hand-rolled quantization scale math — the symmetric-int8
  constants 127/127.0 in mul/div/clamp arithmetic (or a float 128.0
  scale) outside the blessed `ops/decode_attention.py` quantize
  helpers. Integer 128 alone is the lane tile and round-up expressions
  like `(n + 127) // 128` never flag: only Mult/Div/clamp contexts
  count.
- G034: a dtype cast applied to a WHOLE params/opt_state tree (a
  `tree_map` whose mapped lambda casts) outside the blessed reshard/ +
  checkpoint paths that own the dtype policy. Single-leaf casts
  (`params["W"].to(...)`) never flag.
"""

from __future__ import annotations

import ast

from deeplearning4j_tpu_torch.analysis.core import walk

PRECISION_RULE_IDS = frozenset({"G031", "G032", "G033", "G034"})

# kernel dirs whose contractions must declare their accumulator dtype
_G031_SCOPE = ("/ops/", "/embedding/")

_PKG = "deeplearning4j_tpu_torch"

_G031_DOT_CALLS = frozenset({
    "torch.einsum", "torch.matmul", "torch.bmm", "torch.mm",
    "torch.tensordot", "torch.baddbmm", "torch.addmm",
})
# tensor methods that contract (`x.matmul(w)`, `x.bmm(w)`)
_G031_DOT_METHODS = frozenset({"matmul", "bmm", "mm"})

# device-side dirs for the np.float64-constructor half of G032 (host
# analytics dirs — clustering/, graph/, util math — legitimately run
# f64 and are deliberately out of scope)
_G032_DEVICE_DIRS = ("/ops/", "/nn/", "/parallel/", "/embedding/",
                     "/distributed/", "/serving/", "/models/",
                     "/reshard/", "/eval/")

_F64_TORCH = frozenset({"torch.float64", "torch.double"})
_F64_CANON = _F64_TORCH | {"numpy.float64"}
_F64_STRINGS = frozenset({"float64", "f64", ">f8", "<f8", "f8", "double"})

# the finite-difference harness deliberately runs f64; it is the one
# blessed f64 consumer of the torch API surface (and the op audit's
# J003 detector names the dtype it looks for)
_G032_BLESSED_DIRS = ("/gradientcheck/", "/analysis/op_audit.py")

_G033_BLESSED = "ops/decode_attention.py"

_G034_BLESSED = (f"{_PKG}/reshard/",
                 f"{_PKG}/util/checkpoint.py",
                 f"{_PKG}/util/model_serializer.py")
_G034_TREE_NAMES = frozenset({"params", "opt_state", "param_tree",
                              "params_tree", "opt_tree"})
_G034_TREE_MAP = frozenset({f"{_PKG}.nn.tree.tree_map",
                            "torch.utils._pytree.tree_map"})
# tensor methods that change a dtype
_G034_CAST_METHODS = frozenset({"to", "type", "float", "half", "bfloat16",
                                "double"})


def _norm(path: str) -> str:
    return path.replace("\\", "/")


def _in_dirs(path: str, fragments) -> bool:
    norm = "/" + _norm(path)
    return any(frag in norm for frag in fragments)


# ------------------------------------------------------------------ G031

# view ops: an f32 operand stays f32 through them
_G031_VIEWS = frozenset({"transpose", "t", "reshape", "view", "permute",
                         "contiguous", "unsqueeze", "squeeze", "flatten",
                         "expand", "narrow", "select", "unflatten"})


def _f32_cast(node, imports, f32_names=frozenset()) -> bool:
    """Is `node` an explicit cast to f32 (`x.float()`,
    `x.to(torch.float32)`), a view of one (`x.float().transpose(-1,
    -2)`, `.T`, a subscript), or a name every binding of which is one?"""
    while True:
        if isinstance(node, ast.Name):
            return node.id in f32_names
        if isinstance(node, ast.Subscript):
            node = node.value
        elif isinstance(node, ast.Attribute) and node.attr in ("T", "mT"):
            node = node.value
        elif isinstance(node, ast.Call) and \
                isinstance(node.func, ast.Attribute):
            attr = node.func.attr
            if attr == "float" and not node.args:
                return True
            if attr == "to":
                dtypes = list(node.args) + [kw.value for kw in node.keywords
                                            if kw.arg == "dtype"]
                return any(imports.canon(d) in ("torch.float32",
                                                "torch.float")
                           for d in dtypes)
            if attr not in _G031_VIEWS:
                return False
            node = node.func.value
        else:
            return False


def _f32_names(fn, imports) -> frozenset:
    from deeplearning4j_tpu_torch.analysis.ast_rules import (
        names_bound_only_to)

    return frozenset(names_bound_only_to(
        fn, lambda v, found: _f32_cast(v, imports, found)))


def g031_undeclared_accumulator(tree, imports, path):
    """Contractions in ops/ + embedding/ whose operands are not all
    cast to f32 at the call (or spelled `@`, unless both sides are)."""
    if not _in_dirs(path, _G031_SCOPE):
        return []
    from deeplearning4j_tpu_torch.analysis.ast_rules import _parents

    f32_by_fn: dict[int, frozenset] = {}

    def f32_at(node):
        fn = next((p for p in _parents(node)
                   if isinstance(p, (ast.FunctionDef,
                                     ast.AsyncFunctionDef))), None)
        if fn is None:
            return frozenset()
        if id(fn) not in f32_by_fn:
            f32_by_fn[id(fn)] = _f32_names(fn, imports)
        return f32_by_fn[id(fn)]

    out = []
    for node in walk(tree):
        if isinstance(node, ast.Call):
            canon = imports.canon(node.func)
            if canon in _G031_DOT_CALLS:
                short = canon.split(".")[-1]
                operands = [a for a in node.args
                            if not (isinstance(a, ast.Constant)
                                    and isinstance(a.value, str))]
            elif isinstance(node.func, ast.Attribute) and \
                    node.func.attr in _G031_DOT_METHODS and \
                    not (canon or "").startswith("torch."):
                short = node.func.attr
                operands = [node.func.value] + list(node.args)
            else:
                continue
            names = f32_at(node)
            if operands and all(_f32_cast(o, imports, names)
                                for o in operands):
                continue
            out.append((
                "G031", node,
                f"`{short}` in a kernel dir on operands not cast to f32 "
                "— the accumulator and output dtype are left to the "
                "operands' (a bf16 pair rounds its result to bf16)",
                "cast the operands at the call (`.float()`), the f32-"
                "accumulation policy ops/flash_attention.py's plain "
                "versions follow"))
        elif isinstance(node, ast.BinOp) and isinstance(node.op,
                                                        ast.MatMult):
            names = f32_at(node)
            if _f32_cast(node.left, imports, names) and \
                    _f32_cast(node.right, imports, names):
                continue
            out.append((
                "G031", node,
                "`@` matmul in a kernel dir on operands not cast to f32 "
                "— the operator cannot declare an accumulator dtype",
                "cast both sides (`a.float() @ b.float()`) or spell the "
                "contraction as torch.einsum over f32 operands"))
    return out


# ------------------------------------------------------------------ G032

def _is_dtype_registry_value(node) -> bool:
    """Is `node` a VALUE in a dict literal keyed by dtype-name strings
    (a declarative name->dtype registry, e.g. nn/conf's DTYPES)?
    The registry itself introduces no f64 — selecting from it does."""
    from deeplearning4j_tpu_torch.analysis.ast_rules import _parents

    for parent in _parents(node):
        if isinstance(parent, ast.Dict):
            keys = [k for k in parent.keys if k is not None]
            if keys and all(isinstance(k, ast.Constant)
                            and isinstance(k.value, str) for k in keys):
                return node in parent.values or any(
                    v is node or node in walk(v)
                    for v in parent.values)
        elif isinstance(parent, (ast.FunctionDef, ast.AsyncFunctionDef,
                                 ast.ClassDef)):
            return False
    return False


def _names_f64(node, imports) -> bool:
    if isinstance(node, (ast.Name, ast.Attribute)):
        return imports.canon(node) in _F64_CANON
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        return node.value in _F64_STRINGS
    return False


def g032_float64_device_drift(tree, imports, path):
    """float64 entering device code: `torch.float64`/`torch.double`
    anywhere, `.double()` / `.to(float64)` / `dtype=float64` on torch
    calls, and np.float64 constructors in the device dirs."""
    if _in_dirs(path, _G032_BLESSED_DIRS):
        return []
    out = []
    device_dir = _in_dirs(path, _G032_DEVICE_DIRS)
    fixit = ("keep device math float32/bfloat16 (the port's dtype "
             "policy); pin host constants with an explicit f32 dtype")
    for node in walk(tree):
        if isinstance(node, ast.Attribute):
            if imports.canon(node) in _F64_TORCH \
                    and not _is_dtype_registry_value(node):
                out.append((
                    "G032", node,
                    f"{imports.canon(node)} — a float64 dtype aimed at "
                    "device tensors (the op audit's J003 class, caught "
                    "pre-commit)",
                    fixit))
        elif isinstance(node, ast.Call):
            canon = imports.canon(node.func)
            if isinstance(node.func, ast.Attribute) \
                    and node.func.attr == "double" and not node.args \
                    and device_dir \
                    and not (canon or "").startswith("torch."):
                out.append((
                    "G032", node,
                    ".double() — an explicit widen to f64 in a device "
                    "dir",
                    fixit))
            elif isinstance(node.func, ast.Attribute) \
                    and node.func.attr in ("astype", "to") and node.args \
                    and isinstance(node.args[0], ast.Constant) \
                    and _names_f64(node.args[0], imports) and device_dir:
                out.append((
                    "G032", node,
                    f".{node.func.attr}({node.args[0].value!r}) — an "
                    "explicit widen to f64 in a device dir",
                    fixit))
            elif canon == "numpy.float64" and device_dir:
                out.append((
                    "G032", node,
                    "np.float64 constructor in a device dir — the "
                    "scalar widens every tensor expression it meets",
                    fixit))
            elif canon and canon.startswith("torch."):
                for kw in node.keywords:
                    if kw.arg == "dtype" and isinstance(kw.value,
                                                        ast.Constant) \
                            and _names_f64(kw.value, imports):
                        out.append((
                            "G032", node,
                            "dtype='float64' on a torch call — float64 "
                            "built directly into device tensors",
                            fixit))
    return out


# ------------------------------------------------------------------ G033

def _is_q8_const(node) -> bool:
    """127 in any numeric spelling; 128 only as a FLOAT (int 128 is the
    lane tile — G016's structural constant — and round-up expressions
    like `(n + 127) // 128 * 128` must never flag)."""
    if not isinstance(node, ast.Constant) or isinstance(node.value, bool):
        return False
    v = node.value
    if isinstance(v, int):
        return v in (127, -127)
    if isinstance(v, float):
        return v in (127.0, -127.0, 128.0, -128.0)
    return False


def g033_hardcoded_quant_scale(tree, imports, path):
    """Symmetric-int8 scale constants (127 in mul/div/clamp/clip, float
    128.0) outside the blessed decode_attention quantize helpers."""
    if _norm(path).endswith(_G033_BLESSED):
        return []
    out = []
    fixit = ("route scale math through ops/decode_attention.py's "
             "quantize_pages/dequantize_pages/quantized_cache_update — "
             "a second spelling of maxabs/127 is how a cache writer and "
             "reader disagree (q8-scale-mismatch)")
    for node in walk(tree):
        if isinstance(node, ast.BinOp) \
                and isinstance(node.op, (ast.Mult, ast.Div)) \
                and (_is_q8_const(node.left) or _is_q8_const(node.right)):
            out.append((
                "G033", node,
                "hand-rolled int8 quantization scale math (127/128 "
                "mul-div) outside the blessed quantize helpers",
                fixit))
        elif isinstance(node, ast.Call) \
                and (imports.canon(node.func) or "").endswith(
                    (".clip", ".clamp")) \
                and any(_is_q8_const(a) for a in node.args):
            out.append((
                "G033", node,
                "hand-rolled int8 code clamp (clip to ±127) outside "
                "the blessed quantize helpers",
                fixit))
    return out


# ------------------------------------------------------------------ G034

def _is_tree_expr(expr) -> bool:
    if isinstance(expr, ast.Name):
        return expr.id in _G034_TREE_NAMES
    if isinstance(expr, ast.Attribute):
        return expr.attr in _G034_TREE_NAMES
    return False


def _casts_inside(fn_node) -> bool:
    """Does a mapped function (lambda or named ref is not resolvable —
    lambdas only) cast its argument's dtype?"""
    if not isinstance(fn_node, ast.Lambda):
        return False
    return any(isinstance(sub, ast.Call)
               and isinstance(sub.func, ast.Attribute)
               and sub.func.attr in _G034_CAST_METHODS
               for sub in walk(fn_node.body))


def g034_whole_tree_dtype_cast(tree, imports, path):
    """Wholesale dtype casts of params/opt_state trees outside the
    blessed reshard/ + checkpoint dtype-policy paths."""
    norm = _norm(path)
    if any(b in norm if b.endswith("/") else norm.endswith(b)
           for b in _G034_BLESSED):
        return []
    out = []
    fixit = ("cast per-leaf inside the blessed dtype-policy paths "
             "(reshard/, util/checkpoint.py, util/model_serializer.py) "
             "— a wholesale tree cast rewrites the optimizer "
             "accumulators' dtype too")
    for node in walk(tree):
        if not isinstance(node, ast.Call):
            continue
        canon = imports.canon(node.func) or ""
        if (canon in _G034_TREE_MAP or canon.endswith(".tree_map")
                or canon == "tree_map") and len(node.args) >= 2 \
                and any(_is_tree_expr(a) for a in node.args[1:]) \
                and _casts_inside(node.args[0]):
            out.append((
                "G034", node,
                "tree_map casting a whole params/opt_state tree's "
                "dtype outside the blessed dtype-policy paths",
                fixit))
    return out


PRECISION_RULES = [g031_undeclared_accumulator, g032_float64_device_drift,
                   g033_hardcoded_quant_scale, g034_whole_tree_dtype_cast]

PRECISION_RULE_DOCS = {
    "G031": "accumulator discipline (ops/ + embedding/): "
            "torch.einsum/matmul/bmm/mm or `@` on operands not cast to "
            "f32 at the call — torch has no accumulator argument, so "
            "the f32 operands are the declaration",
    "G032": "float64 drift into device code: torch.float64/"
            "torch.double, .double(), .to('float64'), dtype='float64' "
            "on torch calls, np.float64 constructors in device dirs "
            "(the op audit's J003 promoted to pre-commit; host "
            "analytics dirs, gradientcheck/'s f64 "
            "finite differences, and name->dtype registry tables "
            "exempt)",
    "G033": "hand-rolled int8 quantization scale math — 127/127.0 in "
            "mul/div/clamp or a float 128.0 scale outside the blessed "
            "ops/decode_attention.py quantize helpers (the "
            "q8-scale-mismatch class); lane-tile 128 and (n+127)//128 "
            "round-ups never flag",
    "G034": "dtype-mutating cast of a WHOLE params/opt_state tree "
            "(tree_map of a .to/.float/.bfloat16/... cast) outside the "
            "blessed reshard/ + checkpoint dtype-policy paths; "
            "single-leaf casts never flag",
}
