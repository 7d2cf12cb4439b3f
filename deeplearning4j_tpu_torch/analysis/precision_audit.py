"""Stage 5: the precision-flow audit (dtype dataflow and a frozen
quantization manifest) — the counterpart of
deeplearning4j_tpu/analysis/precision_audit.py for eager PyTorch.

The JAX audit walks each entry's closed jaxpr. The port has no traced
program: the op audit's recorder (op_audit.py `OpRecorder`) records one
call of each entry as a graph of aten and c10d ops — every op's input
and output tensors as versioned serials, a producer and a consumer map
over them — and this module distills that call into a per-entry
**precision profile** with the JAX profile's keys:

- `dots`: 'in,in->out' dtypes of every `mm`, `bmm`, `addmm`, `baddbmm`,
  `linear` and `convolution`;
- `reductions`: 'op:dtype' of every `sum`, `mean`, `cumsum`, `cumprod`,
  `logcumsumexp`, `index_add` and `scatter_add`;
- `collectives`: 'op:dtype' of every c10d op, by operand dtype;
- `converts`: 'src->dst' of every dtype-changing `_to_copy`, `to` and
  `copy_`;
- `convert_round_trips` and `q8` (`quantize`: float -> int8,
  `dequantize`: int8 -> float);

and one key of the port's own, `launches` by kernel (the LAUNCHES
deltas): on the card the kernels do not dispatch, so a path that leaves
a kernel for a plain route changes the profile. One recorded call serves
stage 2 and this stage (`op_audit.record_call` returns both).

The rules (the JAX IDs and meanings, in eager terms):

- P001: a sub-f32 accumulation — a sub-f32 additive reduction whose
  operand comes, through shape-only and dtype hops, from a product or
  another reduction; a sub-f32 cumulative op; a sub-f32 all-reduce or
  reduce-scatter operand; a loop-carried sub-f32 `add`/`add_` (the
  eager twin of a scan carry: a run of same-shape adds, each fed by the
  one before while its other operand does not depend on it; a run of
  `CARRY_MIN_ADDS`, as a bias add followed by a residual add is two; a
  kernel's output buffer, which no op fills, counts as depending on
  what came before it, so a residual stream through the kernels is no
  carry).
  Ops recorded in autograd's backward are exempt from the chain, carry
  and churn checks, as the JAX audit exempts scopes holding `add_any`.
- P002: on the int8 path, an int8 -> float convert that reaches no
  `mul` within a few shape hops (a raw-code read), and a float -> int8
  requantize in a read-modify-write (the call also dequantizes) whose
  value never passed a `where` or a masked fill.
- P003: a round trip between converts (a -> b -> a) whose middle value
  nothing else reads.
- P004: a collective operand wider than the entry's widest floating
  input (a tensor the call reads and no op of it wrote).
- P005: the profile differs between simulated rank 0 and rank 1
  (collective_audit.simulated_process_group); the five extras only, as
  in JAX.
- PB01: the profile drifted from the frozen one in
  analysis/precision_budget.json (keyed by device: "cpu" runs the plain
  versions where "cuda" runs kernels), or is missing.

Entries: the op audit's 16 plus the JAX extras (`PRECISION_EXTRA`) at
the JAX audit's shapes, concrete from numpy seed 0. A .py passed to
`graftlint --stage precision` that defines
``GRAFTLINT_PRECISION_ENTRIES = {name: builder}`` (builder() -> (fn,
args)) gets each entry profiled and P-checked without the frozen
manifest.

torch loads inside the functions, so the AST stages stay torch-free.
"""

from __future__ import annotations

import json
import os

from deeplearning4j_tpu_torch.analysis.core import (
    Finding,
    audit_device,
    load_hook,
)

BUDGET_PATH = os.path.join(os.path.dirname(__file__),
                           "precision_budget.json")

# the hook external fixture modules expose: {entry_name: builder}
ENTRY_HOOK = "GRAFTLINT_PRECISION_ENTRIES"

# Entries beyond the op audit's: the int8 paged-cache decode path and
# the two serving-side kernels. They also carry the rank-divergence
# check (P005), as in JAX.
PRECISION_EXTRA = (
    "decode_attention/cached",
    "decode_attention/q8",
    "decode_attention/q8_update",
    "fused_sampling/sample",
    "fused_neg_softmax/scores",
)

# the products and the operands whose dtypes key them
DOTS = {"mm": (0, 1), "bmm": (0, 1), "addmm": (1, 2), "baddbmm": (1, 2),
        "linear": (0, 1), "convolution": (0, 1)}
# additive reductions (where evaluation order compounds rounding) and
# the operand each accumulates; max/min are exact at any width
ADDITIVE = {"sum": 0, "mean": 0, "index_add": 2, "index_add_": 2,
            "scatter_add": 2, "scatter_add_": 2}
CUMULATIVE = frozenset({"cumsum", "cumsum_", "cumprod", "cumprod_",
                        "logcumsumexp", "_logcumsumexp"})
# collectives whose operand is an accumulator
ACC_COLLECTIVES = frozenset({"allreduce_", "_reduce_scatter_base_"})
CONVERTS = frozenset({"_to_copy", "to", "copy_"})
# shape, layout and width hops an accumulation chain crosses (no new
# math); the P001 chain walk crosses these only
_CHAIN_HOPS = frozenset({
    "view", "_unsafe_view", "reshape", "transpose", "t", "permute",
    "expand", "squeeze", "unsqueeze", "slice", "select", "clone",
    "alias", "detach", "as_strided", "split", "split_with_sizes",
    "unbind", "_to_copy", "to", "copy_", "flatten", "narrow",
})
# pass-through hops of the P002 dequantize -> scale-multiply walk
_DEQUANT_HOPS = frozenset({"view", "_unsafe_view", "reshape", "transpose",
                           "t", "permute", "expand", "squeeze",
                           "unsqueeze"})
_MASKS = frozenset({"where", "masked_fill", "masked_fill_"})
# ops that allocate storage no op fills: a hand-written kernel's output
# buffer, which the kernel writes from operands the dispatcher never sees
_UNFILLED = frozenset({"empty", "empty_like", "empty_strided", "new_empty",
                       "new_empty_strided"})
_ADDS = frozenset({"add", "add_"})

_P002A_DEPTH = 6
_P002B_DEPTH = 14
# the length of a run of chained adds that counts as a loop carry
CARRY_MIN_ADDS = 3
# the most nodes one dependence search visits
_SEARCH_CAP = 20000

_FLOAT_WIDTH = {"float64": 8, "float32": 4, "bfloat16": 2, "float16": 2,
                "float8_e4m3fn": 1, "float8_e5m2": 1,
                "float8_e4m3fnuz": 1, "float8_e5m2fnuz": 1}


def entry_names() -> list[str]:
    """Every stage-5 entry (stable order): the op audit's plus the
    extras."""
    from deeplearning4j_tpu_torch.analysis import op_audit

    return op_audit.entry_names() + list(PRECISION_EXTRA)


def _width(dtype: str) -> int:
    """Itemsize of a floating dtype name, 0 otherwise."""
    return _FLOAT_WIDTH.get(dtype, 0)


def _sub_f32(dtype: str) -> bool:
    return 0 < _width(dtype) < 4


def _bump(d: dict, key: str) -> None:
    d[key] = d.get(key, 0) + 1


# ------------------------------------------------------- extra builders

def build_extra(name, device=None):
    """-> (fn, args) for one PRECISION_EXTRA entry at the JAX audit's
    shapes (JAX precision_audit.py `_build_extra`), concrete from numpy
    seed 0 on `device`."""
    device = audit_device(device)
    import numpy as np
    import torch

    rng = np.random.default_rng(0)

    def t(*shape):
        return torch.as_tensor(rng.standard_normal(shape, dtype=np.float32),
                               device=device)

    def i8(*shape):
        return torch.as_tensor(rng.integers(-127, 128, shape, np.int8),
                               device=device)

    B, S, H, D, PS = 2, 256, 2, 64, 64
    n_pages = S // PS
    if name == "decode_attention/cached":
        from deeplearning4j_tpu_torch.ops.decode_attention import \
            decode_attention

        pos = torch.as_tensor(rng.integers(0, S, B), device=device)
        return decode_attention, (t(B, H, D), t(B, S, H, D), t(B, S, H, D),
                                  pos)
    if name == "decode_attention/q8":
        from deeplearning4j_tpu_torch.ops.decode_attention import \
            cache_attention_q8

        scales = [torch.as_tensor(rng.uniform(0.01, 0.1, (B, n_pages, H))
                                  .astype(np.float32), device=device)
                  for _ in range(2)]
        lim = torch.as_tensor(rng.integers(1, S + 1, (B, 1)), device=device)
        return (lambda q, kc, vc, ks, vs, lim: cache_attention_q8(
            q, kc, vc, ks, vs, lim, PS)), (
            t(B, H, 1, D), i8(B, S, H, D), i8(B, S, H, D), *scales, lim)
    if name == "decode_attention/q8_update":
        from deeplearning4j_tpu_torch.ops.decode_attention import \
            quantized_cache_update

        T = 8
        scales = torch.as_tensor(rng.uniform(0.01, 0.1, (B, n_pages, H))
                                 .astype(np.float32), device=device)
        rows = torch.arange(B, device=device)
        start = rng.integers(0, S - T, B)
        pos = torch.as_tensor(start[:, None] + np.arange(T, dtype=np.int64),
                              device=device)
        return (lambda c, s, nv, r, p: quantized_cache_update(
            c, s, nv, r, p, PS)), (i8(B, S, H, D), scales, t(B, T, H, D),
                                   rows, pos)
    if name == "fused_sampling/sample":
        from deeplearning4j_tpu_torch.ops.fused_sampling import (
            fused_sample,
            gumbel_noise,
        )

        V = 1024
        gen = torch.Generator(device=device).manual_seed(0)
        return (lambda lg, nz: fused_sample(lg, nz, temperature=0.8,
                                            top_k=64, top_p=0.9)), (
            t(8, V), gumbel_noise(gen, 8, V, device=device))
    if name == "fused_neg_softmax/scores":
        from deeplearning4j_tpu_torch.ops.fused_neg_softmax import \
            neg_softmax_scores

        return neg_softmax_scores, (t(8, 128), t(8, 128), t(8, 5, 128))
    raise KeyError(name)


def _runner(build):
    fn, args = build()
    return lambda: fn(*args)


def record(name: str, device=None, build=None):
    """The op audit's record of one stage-5 entry (warmed, recorded once;
    its `profile` and `precision` fields are this stage's): an op-audit
    entry, an extra, or a fixture's `build`."""
    device = audit_device(device)
    from deeplearning4j_tpu_torch.analysis import op_audit

    if build is not None:
        return op_audit.record_call(name, _runner(build), device)
    if name in PRECISION_EXTRA:
        return op_audit.record_call(
            name, _runner(lambda: build_extra(name, device)), device)
    return op_audit.record_entry(name, device)


# ------------------------------------------------------------ profiling

def returned_serials(rec, result) -> set:
    """The serials of the tensors a recorded call returned: values that
    escape the call, which the P002 and P003 walks leave alone."""
    import torch
    from torch.utils._pytree import tree_flatten

    flat, _ = tree_flatten(result)
    return {s for s in (rec.serial_of(x) for x in flat
                        if isinstance(x, torch.Tensor)) if s is not None}


def _first_in(node, pos=0):
    return node.ins[pos] if len(node.ins) > pos else None


def _chain_hits(serial, producer, targets, hops, depth=24) -> bool:
    """Walk the producers of `serial` through `hops` ops (their first
    tensor input); True when one of them is in `targets`."""
    for _ in range(depth):
        node = producer.get(serial)
        if node is None:
            return False
        if node.op in targets:
            return True
        if node.op not in hops or not node.ins:
            return False
        serial = node.ins[1][0] if node.op == "copy_" else node.ins[0][0]
    return False


def _reaches_op(serial, producer, targets, depth) -> bool:
    """Bounded search through every producer of `serial`: does an op in
    `targets` appear in its (shallow) history? A hit through an
    unrelated operand only suppresses a finding."""
    frontier, seen = [serial], set()
    for _ in range(depth):
        nxt = []
        for s in frontier:
            if s in seen:
                continue
            seen.add(s)
            node = producer.get(s)
            if node is None:
                continue
            if node.op in targets:
                return True
            nxt.extend(i[0] for i in node.ins)
        if not nxt:
            return False
        frontier = nxt
    return False


def _scale_multiplied(serial, consumers, depth=_P002A_DEPTH) -> bool:
    """P002a: the dequantized codes must reach a `mul` (the page scale)
    within a few pass-through hops."""
    frontier = [serial]
    for _ in range(depth):
        nxt = []
        for s in frontier:
            for node in consumers.get(s, ()):
                if node.op in ("mul", "mul_"):
                    return True
                if node.op in _DEQUANT_HOPS:
                    nxt.extend(o[0] for o in node.outs)
        if not nxt:
            return False
        frontier = nxt
    return False


def _depends(serial, on, producer, floor) -> bool:
    """Does the value `serial` depend on the value `on`, written by the
    node of index `floor`? Nodes before it cannot read it, so the search
    stops at them. A buffer allocated after it and filled by no op (a
    kernel's output: the launch does not dispatch) may depend on it, so
    it counts as a dependence: the search errs toward no finding."""
    stack, seen = [serial], set()
    while stack and len(seen) < _SEARCH_CAP:
        s = stack.pop()
        if s == on:
            return True
        if s in seen:
            continue
        seen.add(s)
        node = producer.get(s)
        if node is None or node.idx <= floor:
            continue
        if node.op in _UNFILLED:
            return True
        stack.extend(i[0] for i in node.ins)
    return len(seen) >= _SEARCH_CAP


def _carry_runs(nodes, producer) -> list:
    """The loop-carried sub-f32 adds: [(length, node)] for each add that
    ends a run of at least CARRY_MIN_ADDS same-shape adds, each carrying
    the one before's output while its other operand does not depend on
    it (outside the backward)."""
    run = {}
    hits = []
    for node in nodes:
        if node.op not in _ADDS or node.backward or len(node.ins) < 2 \
                or not node.outs or not _sub_f32(node.outs[0][1]):
            continue
        best = 1
        for carried, other in ((node.ins[0], node.ins[1]),
                               (node.ins[1], node.ins[0])):
            prev = producer.get(carried[0])
            if prev is None or prev.idx not in run or \
                    carried[2] != node.outs[0][2]:
                continue
            if not _depends(other[0], carried[0], producer, prev.idx):
                best = max(best, run[prev.idx] + 1)
        run[node.idx] = best
        if best >= CARRY_MIN_ADDS:
            hits.append((best, node))
    return hits


def profile_record(rec, name: str, launches=None, escapes=()):
    """-> (profile, P001-P004 findings) of one recorded call (an
    `OpRecorder` after its `with`). The profile is the frozen-manifest
    unit: JSON-stable and rank-comparable (P005 diffs two)."""
    nodes, producer, consumers = rec.nodes, rec.producer, rec.consumers
    profile = {"dots": {}, "reductions": {}, "collectives": {},
               "converts": {}, "convert_round_trips": 0,
               "q8": {"quantize": 0, "dequantize": 0},
               "launches": dict(sorted((launches or {}).items()))}
    findings: list[Finding] = []
    flagged: set[str] = set()
    escapes = set(escapes)

    def flag(rule, message, fixit, snippet):
        if snippet in flagged:       # one finding per (rule, site class)
            return
        flagged.add(snippet)
        findings.append(Finding(rule, name, 0, 0, message, fixit,
                                snippet=snippet, stage="precision"))

    # the widest floating input of the call — P004's reference width
    in_width = max((_width(d) for d in rec.leaves.values()), default=0)
    dequants, requants = [], []

    for node in nodes:
        op = node.op
        out = node.outs[0] if node.outs else None
        if op in DOTS:
            a, b = DOTS[op]
            if len(node.ins) > b and out is not None:
                _bump(profile["dots"],
                      f"{node.ins[a][1]},{node.ins[b][1]}->{out[1]}")
        elif op in ADDITIVE or op in CUMULATIVE:
            if out is None:
                continue
            _bump(profile["reductions"], f"{op.rstrip('_')}:{out[1]}")
            if not _sub_f32(out[1]) or node.backward:
                continue
            if op in CUMULATIVE:
                flag("P001",
                     f"`{op}` accumulates in {out[1]} — a cumulative chain "
                     "compounds sub-f32 rounding at every step",
                     "compute the cumulative op in f32 (dtype=torch."
                     "float32 or .float()) and downcast the result",
                     f"cum-subf32:{op}:{out[1]}")
                continue
            operand = _first_in(node, ADDITIVE[op])
            if operand is not None and _chain_hits(
                    operand[0], producer, set(DOTS) | set(ADDITIVE),
                    _CHAIN_HOPS):
                flag("P001",
                     f"`{op}` in {out[1]} directly over a product or a "
                     "reduction — a chained reduction accumulating below "
                     "f32",
                     "accumulate in f32 (the product's output in f32, or "
                     "reduce before the downcast)",
                     f"chain-subf32:{op}:{out[1]}")
        elif node.item is not None:
            key_dt = node.operand[0] if node.operand else "?"
            _bump(profile["collectives"], f"{op}:{key_dt}")
            if op in ACC_COLLECTIVES and _sub_f32(key_dt):
                flag("P001",
                     f"`{op}` reduces a {key_dt} operand across ranks — "
                     "the cross-rank sum is itself a sub-f32 accumulation "
                     "chain",
                     "all-reduce in f32 (upcast the operand; downcast "
                     "after)", f"psum-subf32:{op}:{key_dt}")
            wide = max((_width(d) for d in node.operand), default=0)
            if in_width and wide > in_width:
                flag("P004",
                     f"`{op}` moves a {key_dt} operand while the entry's "
                     f"widest floating input is {in_width * 8}-bit — "
                     "widened bytes on the wire",
                     "downcast before the collective (or keep the f32 "
                     "master copy local, ZeRO-style)",
                     f"widening:{op}:{key_dt}")
        elif op in CONVERTS and out is not None and node.ins:
            src = node.ins[1] if op == "copy_" and len(node.ins) > 1 \
                else node.ins[0]
            if src[1] == out[1]:
                continue
            _bump(profile["converts"], f"{src[1]}->{out[1]}")
            if src[1] == "int8" and _width(out[1]):
                profile["q8"]["dequantize"] += 1
                dequants.append(node)
            elif _width(src[1]) and out[1] == "int8":
                profile["q8"]["quantize"] += 1
                requants.append(node)
            # P003: a convert of a convert landing back on the inner
            # input's dtype, the middle value read by nothing else
            prev = producer.get(src[0])
            if node.backward or prev is None or prev.op not in CONVERTS \
                    or prev.backward or not prev.ins:
                continue
            inner = prev.ins[1] if prev.op == "copy_" and \
                len(prev.ins) > 1 else prev.ins[0]
            only_here = all(c is node for c in consumers.get(src[0], ())) \
                and src[0] not in escapes
            if only_here and out[1] == inner[1] != src[1]:
                profile["convert_round_trips"] += 1
                flag("P003",
                     f"convert {inner[1]}->{src[1]}->{out[1]} round trip — "
                     "the value never changed; both converts are memory "
                     "traffic",
                     "delete the ping-pong (keep the value in its working "
                     "dtype)", f"churn:{inner[1]}->{src[1]}")

    for length, node in sorted(_carry_runs(nodes, producer),
                               key=lambda hit: -hit[0]):
        dt = node.outs[0][1]
        flag("P001",
             f"a loop carry add-accumulates in {dt} ({length} chained "
             "adds of one shape) — running sums below f32 lose low bits "
             "every iteration",
             "carry the accumulator in f32 and downcast after the loop "
             "(the flash and decode kernels' pattern)",
             f"carry-subf32:{dt}")

    # P002: the quantize <-> dequantize pairing of the int8 path
    for node in dequants:
        serial = node.outs[0][0]
        if serial in escapes or not consumers.get(serial):
            continue            # escapes the call: the caller's problem
        if not _scale_multiplied(serial, consumers):
            flag("P002",
                 "int8 codes converted to float but never scale-multiplied "
                 "nearby — a raw-code read (missing dequant) on the q8 "
                 "cache path",
                 "multiply by the per-(row, page, head) scale right after "
                 "the convert (ops/decode_attention.py's dequant idiom)",
                 "q8-read-unscaled")
    if dequants and requants:
        # a read-modify-write: the requantize must sit behind a mask of
        # the positions past the write head
        for node in requants:
            src = node.ins[1] if node.op == "copy_" and len(node.ins) > 1 \
                else node.ins[0]
            if not _reaches_op(src[0], producer, _MASKS, _P002B_DEPTH):
                flag("P002",
                     "requantize in a read-modify-write q8 path without "
                     "masking past the write head — stale values from a "
                     "prior tenancy inflate the page maxabs and crush fresh "
                     "precision",
                     "torch.where positions past the row's write head to 0 "
                     "before recomputing scales (quantized_cache_update's "
                     "zeroing step)", "q8-requant-unmasked")

    for k in ("dots", "reductions", "collectives", "converts"):
        profile[k] = dict(sorted(profile[k].items()))
    return profile, findings


# ----------------------------------------------------- rank simulation

def check_rank_independence(name: str, build=None,
                            device=None) -> list[Finding]:
    """Record the entry under simulated rank 0 and rank 1 of a world of
    two (collective_audit.simulated_process_group) and compare the
    profiles. A divergent profile is deadlock-class (P005), as stage 3's
    C003: the replicas would run different mixed-precision programs."""
    device = audit_device(device)
    from deeplearning4j_tpu_torch.analysis.collective_audit import (
        SIMULATED_PROCESSES,
        simulated_process_group,
    )

    profiles = {}
    for pid in SIMULATED_PROCESSES:
        with simulated_process_group(pid, len(SIMULATED_PROCESSES),
                                     device):
            profiles[pid] = record(name, device, build).profile
    p0, p1 = (profiles[p] for p in SIMULATED_PROCESSES)
    if p0 != p1:
        diff = _diff_keys(p0, p1)
        return [Finding(
            "P005", name, 0, 0,
            "rank-divergent precision profile — process 0 and process 1 "
            f"disagree on {diff}: replicas running different "
            "mixed-precision programs desync exactly like a divergent "
            "collective sequence (DEADLOCK class)",
            "make dtype decisions rank-invariant; never branch dtypes on "
            "the rank",
            snippet="rank-divergent-precision", stage="precision")]
    return []


# -------------------------------------------------------------- manifest

def _dev(device) -> str:
    return "cuda" if str(device).startswith("cuda") else "cpu"


def load_budget(path: str | None = None, device=None) -> dict:
    """{entry: frozen profile} of `device`'s section."""
    device = audit_device(device)
    try:
        with open(path or BUDGET_PATH) as fh:
            data = json.load(fh)
    except FileNotFoundError:
        return {}
    return dict(data.get("entries", {}).get(_dev(device), {}))


def write_budget(profiles: dict, device: str,
                 path: str | None = None) -> None:
    """Freeze `profiles` as `device`'s section, keeping the other's."""
    path = path or BUDGET_PATH
    try:
        with open(path) as fh:
            entries = json.load(fh).get("entries", {})
    except FileNotFoundError:
        entries = {}
    entries[_dev(device)] = {k: profiles[k] for k in sorted(profiles)}
    with open(path, "w") as fh:
        json.dump(
            {"comment": "frozen per-entry precision manifest (graftlint "
                        "stage 5), keyed by device: dtype-keyed counts of "
                        "products / additive reductions / collectives / "
                        "converts, int8 quantize/dequantize tallies and "
                        "kernel launches. A drift here is a mixed-"
                        "precision regression unless deliberate: "
                        "port_tools/graftlint.py --update-precision "
                        "--device cpu|cuda",
             "entries": {k: entries[k] for k in sorted(entries)}},
            fh, indent=1)
        fh.write("\n")


def _diff_keys(frozen: dict, got: dict) -> list[str]:
    return sorted(k for k in set(frozen) | set(got)
                  if frozen.get(k) != got.get(k))


def audit(names=None, device=None, budget_path: str | None = None,
          *, divergence: bool = True, records=None):
    """Run the stage-5 audit on `device` -> (findings, {entry: profile}).
    `records` {entry: EntryRecord} are the op audit's records of the same
    run (`--stage all`): an entry recorded there is not run again."""
    device = audit_device(device)
    budget = load_budget(budget_path, device)
    findings, profiles = [], {}
    records = records or {}
    for name in names if names is not None else entry_names():
        rec = records.get(name) or record(name, device)
        profiles[name] = rec.profile
        findings.extend(rec.precision)
        frozen = budget.get(name)
        if frozen is None:
            findings.append(Finding(
                "PB01", name, 0, 0,
                f"entry point has no frozen precision profile on "
                f"{_dev(device)} (recorded "
                f"{sum(rec.profile['dots'].values())} product(s), "
                f"{sum(rec.profile['converts'].values())} convert(s))",
                "run `python3 port_tools/graftlint.py --update-precision "
                f"--device {_dev(device)}`",
                snippet="missing-precision-profile", stage="precision"))
        elif frozen != rec.profile:
            findings.append(Finding(
                "PB01", name, 0, 0,
                "precision profile drift vs the frozen manifest in "
                f"{_diff_keys(frozen, rec.profile)} — an accumulation "
                "dtype, convert, quant count or kernel launch changed",
                "find what changed the dtype flow; only then refreeze "
                "(--update-precision)",
                snippet="precision-drift", stage="precision"))
        if divergence and name in PRECISION_EXTRA:
            findings.extend(check_rank_independence(name, device=device))
    return findings, profiles


# --------------------------------------------------- external fixtures

def load_entry_module(path: str) -> dict:
    """The GRAFTLINT_PRECISION_ENTRIES hook ({name: builder}) a fixture .py
    defines, or {} (`core.load_hook`)."""
    return load_hook(path, ENTRY_HOOK)


def audit_paths(paths, device=None):
    """Profile and P-check every external entry the given .py files
    expose (no frozen-manifest requirement: fixture entries) ->
    (findings, {entry: profile})."""
    device = audit_device(device)
    findings, profiles = [], {}
    for path in paths:
        if not (path.endswith(".py") and os.path.isfile(path)):
            continue
        for name, build in load_entry_module(path).items():
            rec = record(name, device, build)
            profiles[name] = rec.profile
            findings.extend(rec.precision)
            findings.extend(check_rank_independence(name, build, device))
    return findings, profiles
