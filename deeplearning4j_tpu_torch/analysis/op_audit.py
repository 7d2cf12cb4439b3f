"""Stage 2: the op audit of the port's public entry points — the
counterpart of deeplearning4j_tpu/analysis/jaxpr_audit.py for eager
PyTorch.

The JAX audit traces each jitted entry point and reads its jaxpr. The
port has no traced program: it runs each entry once to warm it (kernel
builds, cuBLAS handles, the caching allocator's first blocks — a first
call may sync for those reasons), then runs it a second time under an
`OpRecorder` and audits what that call did:

- every aten op it dispatched, through a TorchDispatchMode (autograd
  propagates the mode to the threads that run the backward, and the
  recorder counts the ops it sees there: a gradient entry whose
  backward records no op is an error, not a pass);
- every hand-written kernel it launched, as deltas of the kernel
  wrappers' LAUNCHES counters (`ops.launch_counts`): the ctypes kernels
  never pass through the dispatcher;
- the call as a graph of `OpNode`s (each op's input and output tensors
  as versioned serials) and its c10d ops in order, which the collective
  audit (stage 3) and the precision audit (stage 5) read.

The rules (the JAX IDs and meanings):

- J001: a host sync inside the entry. On any device: the ops that make
  the host wait for the card (`_local_scalar_dense` — `.item()`,
  `float()` of a tensor —, `nonzero`, `masked_select`, a boolean
  `index`/`index_put_`, `unique`, `repeat_interleave` without an output
  size, `equal`, `is_nonzero`) and copies from the card to the CPU. On
  CUDA also every warning of `torch.cuda.set_sync_debug_mode("warn")`,
  which torch raises for any synchronizing call. Each is recorded
  with the innermost port frame that made it. A sync listed under the
  entry's `known_syncs` in the budget (ROADMAP Queue C) is reported
  apart and does not fail; any other does.
- J002: the op count plus the launches over the frozen bound of
  analysis/op_budget.json, keyed by device (`"cpu"` runs the plain
  versions where `"cuda"` runs kernels); a gradient entry's backward
  unseen.
- J003: a float64 tensor into or out of any op.
- J004: an entry missing from the budget for its device.

Entries are the JAX audit's (`jaxpr_audit.entry_names`, the keys of
its jaxpr_budget.json) at the JAX audit's shapes: the flash attention
variants, the chunked tier at T = 4096, the fused LayerNorm and
softmax-xent head, and `lm_step/<mode>` — the port's train step
(`net._get_train_step()` on `net._batch_dict(net._to_mds(ds))`) for
each LM bench mode. On CUDA the modes run at their full dims in bf16;
on the CPU at the bench's CPU smoke dims in f32 (bench.py
`lm_mode_net_ds` off the accelerator), so the CPU budget stays a
tier-1 cost.

torch and the port's modules load inside the functions, so the AST
stage (which imports this package) stays torch-free.
"""

from __future__ import annotations

import dataclasses
import json
import os
import time
import traceback
import warnings
import weakref

from deeplearning4j_tpu_torch.analysis.core import Finding

BUDGET_PATH = os.path.join(os.path.dirname(__file__), "op_budget.json")

# op-count bounds get this headroom over the observed count when
# (re)generated, then stay FROZEN until explicitly regenerated.
_BUDGET_HEADROOM = 1.25
_BUDGET_QUANTUM = 25

_LM_STEP_PREFIX = "lm_step/"
_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_ROOT = os.path.dirname(_PKG_DIR)

VOCAB_LM = 10000

# The port's copy of bench.py's LM_MODE_DIMS (the dims of every
# Transformer-LM bench mode); tests hold the two equal.
LM_MODE_DIMS = {
    "transformer": dict(d_model=256, n_heads=2, d_ff=1024, seq=512,
                        batch=32, steps=40),
    "transformer_d64": dict(d_model=256, n_heads=4, d_ff=1024, seq=512,
                            batch=32, steps=40),
    "transformer_large": dict(d_model=1024, n_heads=8, d_ff=4096, seq=512,
                              batch=32, steps=5),
    "masked": dict(d_model=256, n_heads=2, d_ff=1024, seq=512, batch=32,
                   steps=40, masked=True),
    "dropout": dict(d_model=256, n_heads=2, d_ff=1024, seq=512, batch=32,
                    steps=40, masked=True, attention_dropout=0.1),
    "longcontext": dict(d_model=256, n_heads=2, d_ff=1024, seq=4096,
                        batch=4, steps=20),
    "longcontext_chunked": dict(d_model=256, n_heads=2, d_ff=1024,
                                seq=32768, batch=8, steps=2),
    "longcontext_chunked_dropout": dict(d_model=256, n_heads=2, d_ff=1024,
                                        seq=32768, batch=8, steps=2,
                                        masked=True, attention_dropout=0.1),
}

# bench.py's CPU smoke dims for every mode off the accelerator
CPU_DIMS = dict(d_model=128, n_heads=2, d_ff=512, seq=128, batch=2)

KERNEL_ENTRIES = (
    "flash_attention/causal",
    "flash_attention/masked",
    "flash_attention/dropout",
    "flash_attention/grad",
    "flash_attention_qkv/causal",
    "chunked_flash_attention/seq4096",
    "fused_layer_norm",
    "softmax_xent_head",
)

# The kernels each entry (of this audit and of the precision audit)
# must launch on the card: every group needs at least one launch (K1-K13
# as in PERF.md). The LM steps run the packed
# K2/K6 at head dim 128, the pair kernels K3/K7 at 64, and the flat
# K1/K5 at T = 4096 and past it (the chunked tier's tiles).
_PACKED = ({"K8"}, {"K9"}, {"K2"}, {"K6"})
_FLAT = ({"K8"}, {"K9"}, {"K1"}, {"K5"})
EXPECTED_KERNELS = {
    "flash_attention/causal": ({"K1"},),
    "flash_attention/masked": ({"K1"},),
    "flash_attention/dropout": ({"K1"},),
    "flash_attention/grad": ({"K1"}, {"K4", "K5"}),
    "flash_attention_qkv/causal": ({"K2"},),
    "chunked_flash_attention/seq4096": ({"K1"},),
    "fused_layer_norm": ({"K10"},),
    "softmax_xent_head": ({"K8"},),
    **{_LM_STEP_PREFIX + m: _PACKED
       for m in ("transformer", "transformer_large", "masked", "dropout")},
    _LM_STEP_PREFIX + "transformer_d64": ({"K8"}, {"K9"}, {"K3"}, {"K7"}),
    **{_LM_STEP_PREFIX + m: _FLAT for m in (
        "longcontext", "longcontext_chunked",
        "longcontext_chunked_dropout")},
    # the precision audit's extras (precision_audit.PRECISION_EXTRA):
    # the decode path is plain PyTorch, the serving kernels are K12, K13
    "decode_attention/cached": (),
    "decode_attention/q8": (),
    "decode_attention/q8_update": (),
    "fused_sampling/sample": ({"K12"},),
    "fused_neg_softmax/scores": ({"K13"},),
}

# torch.cuda.set_sync_debug_mode("warn") warns of every synchronizing
# call ("called a synchronizing CUDA operation"), and once that the mode
# itself is a prototype, which is no sync
_PROTOTYPE_NOTICE = "prototype feature"

# ops that make the host wait for the card's result
SYNC_OPS = frozenset({
    "aten::_local_scalar_dense", "aten::nonzero", "aten::masked_select",
    "aten::_unique2", "aten::unique_dim", "aten::unique_consecutive",
    "aten::is_nonzero", "aten::equal",
})


def entry_names() -> list[str]:
    """All auditable entry points (stable order): the JAX audit's."""
    return list(KERNEL_ENTRIES) + [_LM_STEP_PREFIX + mode
                                   for mode in sorted(LM_MODE_DIMS)]


def lm_mode_net_ds(mode, device):
    """(net, ds, cfg) for an LM bench mode, as bench.py builds it: the
    stock transformer_lm and its token batch (seed 0). On CUDA the
    mode's full dims in bf16; elsewhere the CPU smoke dims in f32."""
    import numpy as np

    from deeplearning4j_tpu_torch.datasets import DataSet
    from deeplearning4j_tpu_torch.models.transformer import transformer_lm

    cfg = dict(LM_MODE_DIMS[mode])
    full_dims = str(device).startswith("cuda")
    if not full_dims:
        cfg.update(CPU_DIMS)
    rng = np.random.default_rng(0)
    seq, batch = cfg["seq"], cfg["batch"]
    toks = np.asarray(rng.integers(0, VOCAB_LM, (batch, seq)), np.int32)
    kw = {}
    if cfg.get("masked"):
        lengths = rng.integers(seq // 2, seq + 1, batch)
        kw["features_mask"] = (np.arange(seq, dtype=np.int64)[None, :]
                               < lengths[:, None]).astype(np.float32)
    ds = DataSet(toks, np.roll(toks, -1, axis=1), **kw)
    net = transformer_lm(
        vocab_size=VOCAB_LM, d_model=cfg["d_model"], n_heads=cfg["n_heads"],
        n_layers=cfg.get("n_layers", 6), d_ff=cfg["d_ff"], max_length=seq,
        attention_dropout=cfg.get("attention_dropout"),
        dtype="bfloat16" if full_dims else "float32", device=device)
    net.init()
    return net, ds, cfg


def _build(name, device):
    """-> a no-argument callable that runs one call of the entry point
    on `device` (inputs made once, from numpy seed 0)."""
    import numpy as np
    import torch

    if name.startswith(_LM_STEP_PREFIX):
        net, ds, _cfg = lm_mode_net_ds(name[len(_LM_STEP_PREFIX):], device)
        batch = net._batch_dict(net._to_mds(ds))
        step = net._get_train_step()

        def run():
            net.params, net.opt_state, net.state, loss, _ = step(
                net.params, net.opt_state, net.state, net._generator, batch)
            return loss
        return run

    from deeplearning4j_tpu_torch.ops.flash_attention import (
        chunked_flash_attention,
        flash_attention,
        flash_attention_qkv,
    )
    from deeplearning4j_tpu_torch.ops.fused_layernorm import fused_layer_norm
    from deeplearning4j_tpu_torch.ops.fused_softmax_xent import (
        softmax_xent_head,
    )

    rng = np.random.default_rng(0)

    def t(*shape, grad=False):
        x = torch.as_tensor(rng.standard_normal(shape, dtype=np.float32),
                            device=device)
        return x.requires_grad_(grad)

    B, H, T, D = 2, 2, 512, 64
    if name == "flash_attention/causal":
        q, k, v = t(B, H, T, D), t(B, H, T, D), t(B, H, T, D)
        return lambda: flash_attention(q, k, v, causal=True)
    if name == "flash_attention/masked":
        q, k, v = t(B, H, T, D), t(B, H, T, D), t(B, H, T, D)
        lengths = rng.integers(T // 2, T + 1, B)
        mask = torch.as_tensor((np.arange(T, dtype=np.int64)[None, :]
                                < lengths[:, None])
                               .astype(np.float32), device=device)
        return lambda: flash_attention(q, k, v, causal=True, mask=mask)
    if name == "flash_attention/dropout":
        q, k, v = t(B, H, T, D), t(B, H, T, D), t(B, H, T, D)
        gen = torch.Generator(device=device).manual_seed(0)
        return lambda: flash_attention(q, k, v, causal=True, dropout=0.1,
                                       generator=gen)
    if name == "flash_attention/grad":
        q, k, v = (t(B, H, T, D, grad=True) for _ in range(3))
        return lambda: torch.autograd.grad(
            flash_attention(q, k, v, causal=True).sum(), (q, k, v))
    if name == "flash_attention_qkv/causal":
        # d_model 256 / 2 heads -> D=128, the packed-qkv regime
        qkv = t(B, T, 3 * 256)
        return lambda: flash_attention_qkv(qkv, 2, causal=True)
    if name == "chunked_flash_attention/seq4096":
        q, k, v = (t(1, 2, 4096, D) for _ in range(3))
        return lambda: chunked_flash_attention(q, k, v, causal=True)
    if name == "fused_layer_norm":
        x, g, b = t(1024, 512), t(512), t(512)
        return lambda: fused_layer_norm(x, g, b)
    if name == "softmax_xent_head":
        x, w, b = t(1024, 256), t(256, 10000), t(10000)
        labels = torch.as_tensor(rng.integers(0, 10000, 1024),
                                 device=device)
        return lambda: softmax_xent_head(x, w, b, labels)
    raise KeyError(name)


# ------------------------------------------------------------ recording

_SKIP_FRAMES = frozenset({os.path.abspath(__file__),
                          os.path.abspath(warnings.__file__)})


def _port_frame(stack) -> str:
    """'relpath:function:line' of the innermost frame in the port's
    package outside analysis/; else of the innermost frame outside
    torch, this module and the stdlib's warnings module; else of the
    innermost torch frame (from an extract_stack() list)."""
    outside, in_torch = None, None
    for fr in reversed(stack):
        path = os.path.abspath(fr.filename)
        if path.startswith(_PKG_DIR + os.sep) and \
                os.sep + "analysis" + os.sep not in path[len(_PKG_DIR):]:
            rel = os.path.relpath(path, _ROOT).replace(os.sep, "/")
            return f"{rel}:{fr.name}:{fr.lineno}"
        if path in _SKIP_FRAMES:
            continue
        where = f"{os.path.basename(path)}:{fr.name}:{fr.lineno}"
        if os.sep + "torch" + os.sep in path:
            in_torch = in_torch or where
        else:
            outside = outside or where
    return outside or in_torch or "<unknown>"


def frame_key(frame: str) -> str:
    """A frame without its line number ('relpath:function'): what the
    budget's known_syncs list, so an edit above a sync keeps it known."""
    return frame.rsplit(":", 1)[0]


def _sync_reason(func, args, kwargs):
    """Why this op makes the host wait, or None."""
    import torch

    name = func._schema.name
    if name in SYNC_OPS:
        return name
    if name in ("aten::index", "aten::index_put", "aten::index_put_") and \
            len(args) > 1 and any(
                isinstance(i, torch.Tensor) and i.dtype == torch.bool
                for i in (args[1] or ())):
        return f"{name} (boolean mask)"
    if name == "aten::repeat_interleave" and \
            kwargs.get("output_size") is None and args and \
            isinstance(args[0], torch.Tensor) and \
            not (len(args) > 1 and isinstance(args[1], int)):
        return f"{name} (no output_size)"
    if name in ("aten::_to_copy", "aten::to", "aten::copy_") and args:
        src = args[1] if name == "aten::copy_" else args[0]
        dst = (args[0].device if name == "aten::copy_"
               else kwargs.get("device"))
        if isinstance(src, torch.Tensor) and dst is not None and \
                torch.device(dst).type == "cpu" and src.device.type != "cpu":
            return f"{name} (to the CPU)"
    return None


def dtype_name(dtype) -> str:
    """'float32' for torch.float32: the dtype spelling the profiles and
    signatures use (the JAX package's)."""
    return str(dtype).replace("torch.", "")


class OpNode:
    """One op of a recorded call: its schema name ('aten::mm',
    'c10d::allreduce_'), the tensors it read and wrote as (serial,
    dtype, shape) — a serial names one version of one tensor: every op's
    outputs get new ones, in-place outputs too —, whether it ran inside
    autograd's backward, and for a c10d op its signature item and the
    dtypes of its operand."""

    __slots__ = ("idx", "name", "ins", "outs", "backward", "item",
                 "operand")

    def __init__(self, idx, name, ins, outs, backward, item=None,
                 operand=()):
        self.idx, self.name, self.ins, self.outs = idx, name, ins, outs
        self.backward, self.item, self.operand = backward, item, operand

    @property
    def op(self) -> str:
        """The name without its namespace ('mm', 'allreduce_')."""
        return self.name.split("::", 1)[-1]


# the argument of a c10d op that holds its operand (else argument 0)
_C10D_OPERAND = {"_allgather_base_": 1, "allgather_": 1,
                 "_reduce_scatter_base_": 1}
# point-to-point c10d ops: their signature item names the peer relative
# to this rank, so a ring's signature is the same on every rank
P2P_OPS = frozenset({"send", "recv_", "recv_any_source_"})


def _process_group(obj):
    """The ProcessGroup a c10d op's ScriptObject argument boxes, or None
    (a ReduceOp, a Work)."""
    import torch
    import torch.distributed as dist

    if not isinstance(obj, torch.ScriptObject):
        return None
    try:
        return dist.ProcessGroup.unbox(obj)
    except RuntimeError:
        return None


def c10d_item(func, args):
    """(signature item, operand dtypes) of one c10d op: a collective as
    'op@group-size dtype[shape]', a point-to-point op as 'send@+k
    dtype[shape]' with k = (peer - rank) mod the group's size."""
    import torch
    from torch.utils._pytree import tree_flatten

    op = func._schema.name.split("::", 1)[-1]
    pg = next((g for g in map(_process_group, args) if g is not None),
              None)
    size, rank = (pg.size(), pg.rank()) if pg is not None else (1, 0)
    if op in P2P_OPS:
        peer = next((a for a in args[2:] if isinstance(a, int)), None)
        where = "+?" if peer is None else f"+{(peer - rank) % size}"
    else:
        where = str(size)
    pos = _C10D_OPERAND.get(op, 0)
    flat, _ = tree_flatten(args[pos] if pos < len(args) else ())
    tensors = [t for t in flat if isinstance(t, torch.Tensor)]
    if op == "barrier":
        tensors = []
    desc = ",".join(f"{dtype_name(t.dtype)}[{','.join(map(str, t.shape))}]"
                    for t in tensors)
    return (f"{op}@{where} {desc}".strip(),
            tuple(dtype_name(t.dtype) for t in tensors))


def _recorder_class():
    import torch
    from torch.utils._python_dispatch import TorchDispatchMode
    from torch.utils._pytree import tree_flatten

    class OpRecorder(TorchDispatchMode):
        """Counts every aten op dispatched under it (and those of the
        backward it reaches), records host syncs and float64 tensors
        with the port frame that made them, the c10d ops in order
        (`collectives`, the collective audit's signature), and the call
        as a graph of `OpNode`s: `producer` maps a tensor serial to the
        node that wrote it, `consumers` to the nodes that read it (the
        precision audit's chain walks). Tensors map to their serials
        weakly (`_serials`: id -> (weak reference, serial), an entry
        whose tensor died and whose id was reused is stale): the
        recorder keeps none alive."""

        def __init__(self):
            super().__init__()
            self.ops: dict[str, int] = {}
            self.backward_ops = 0
            self.syncs: list[tuple[str, str]] = []
            self.f64: dict[str, str] = {}
            self.collectives: list[str] = []
            self.nodes: list[OpNode] = []
            self.producer: dict[int, OpNode] = {}
            self.consumers: dict[int, list] = {}
            self.leaves: dict[int, str] = {}     # serial -> dtype
            self._serials: dict[int, tuple] = {}
            self._next = 0

        def _new(self, t):
            self._next += 1
            self._serials[id(t)] = (weakref.ref(t), self._next)
            return self._next

        def _read(self, t):
            serial = self.serial_of(t)
            if serial is None:
                serial = self._new(t)
                self.leaves[serial] = dtype_name(t.dtype)
            return (serial, dtype_name(t.dtype), tuple(t.shape))

        def serial_of(self, t):
            """The serial of `t`'s last version, or None."""
            entry = self._serials.get(id(t))
            return entry[1] if entry is not None and entry[0]() is t \
                else None

        @property
        def aten_ops(self) -> int:
            return sum(n for k, n in self.ops.items()
                       if k.startswith("aten."))

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            kwargs = kwargs or {}
            key = str(func)
            self.ops[key] = self.ops.get(key, 0) + 1
            backward = torch._C._current_autograd_node() is not None
            if backward:
                self.backward_ops += 1
            reason = _sync_reason(func, args, kwargs)
            flat_in, _ = tree_flatten((args, kwargs))
            ins = tuple(self._read(x) for x in flat_in
                        if isinstance(x, torch.Tensor))
            item, operand = (c10d_item(func, args)
                             if func.namespace == "c10d" else (None, ()))
            out = func(*args, **kwargs)
            flat_out, _ = tree_flatten(out)
            outs = tuple((self._new(x), dtype_name(x.dtype), tuple(x.shape))
                         for x in flat_out if isinstance(x, torch.Tensor))
            node = OpNode(len(self.nodes), func._schema.name, ins, outs,
                          backward, item, operand)
            self.nodes.append(node)
            for serial, _, _ in ins:
                self.consumers.setdefault(serial, []).append(node)
            for serial, _, _ in outs:
                self.producer[serial] = node
            if item is not None:
                self.collectives.append(item)
            if reason is not None:
                self.syncs.append(
                    (reason, _port_frame(traceback.extract_stack())))
            if key not in self.f64 and any(
                    isinstance(x, torch.Tensor) and x.dtype == torch.float64
                    for x in flat_in + flat_out):
                self.f64[key] = _port_frame(traceback.extract_stack())
            return out

    return OpRecorder


@dataclasses.dataclass
class EntryRecord:
    """What one audited call of an entry did."""
    name: str
    device: str
    ops: int                 # aten ops dispatched
    backward_ops: int        # of which inside autograd's backward
    launches: dict           # kernel -> launches (nonzero only)
    syncs: list              # [(op or "cuda-sync", frame)]
    f64: dict                # op -> frame
    dense_routes: int        # attention calls sent to the dense path
    ms: float                # CUDA: one unrecorded call, CUDA events;
                             # CPU: the recorded call's wall time
    top_ops: list            # [(op, count)], the 8 most frequent
    profile: dict = dataclasses.field(default_factory=dict)
                             # the precision profile (precision_audit)
    precision: list = dataclasses.field(default_factory=list)
                             # its P001-P004 findings

    @property
    def count(self) -> int:
        """What J002 bounds: the ops plus the kernel launches."""
        return self.ops + sum(self.launches.values())

    def to_json(self) -> dict:
        return {**dataclasses.asdict(self), "count": self.count}


def _needs_backward(name: str) -> bool:
    return name == "flash_attention/grad" or name.startswith(_LM_STEP_PREFIX)


def record_entry(name: str, device: str = "cuda") -> EntryRecord:
    """Warm the entry with one call, then record a second: its ops,
    launches, syncs and float64 (`record_call`)."""
    return record_call(name, _build(name, device), device)


def record_call(name: str, run, device: str) -> EntryRecord:
    """`run()` once to warm, once under the OpRecorder (with the sync
    debug mode on CUDA), and on CUDA a third time unrecorded, timed with
    events; on the CPU `ms` is the recorded call's wall time. The one
    recorded call also gives the precision profile with its findings
    (analysis/precision_audit.py), so stage 2 and stage 5 share it."""
    import torch

    from deeplearning4j_tpu_torch.analysis import precision_audit
    from deeplearning4j_tpu_torch.ops import flash_attention as fa
    from deeplearning4j_tpu_torch.ops import launch_counts

    cuda = str(device).startswith("cuda")
    run()
    if cuda:
        torch.cuda.synchronize()
    before, dense0 = launch_counts(), fa.DENSE_ROUTES["head_dim"]
    rec = _recorder_class()()
    sync_warnings: list[tuple[str, str]] = []
    with warnings.catch_warnings():
        warnings.simplefilter("always")
        show = warnings.showwarning

        def hook(message, category, filename, lineno, file=None,
                 line=None):
            text = str(message)
            if "synchroniz" in text and _PROTOTYPE_NOTICE not in text:
                sync_warnings.append(
                    ("cuda-sync", _port_frame(traceback.extract_stack())))
            else:
                show(message, category, filename, lineno, file, line)

        warnings.showwarning = hook
        if cuda:
            mode = torch.cuda.get_sync_debug_mode()
            torch.cuda.set_sync_debug_mode("warn")
        t0 = time.perf_counter()
        try:
            with rec:
                result = run()
        finally:
            if cuda:
                torch.cuda.set_sync_debug_mode(mode)
        ms = (time.perf_counter() - t0) * 1e3
    after = launch_counts()
    escapes = precision_audit.returned_serials(rec, result)
    del result
    if cuda:
        torch.cuda.synchronize()
        start, end = (torch.cuda.Event(enable_timing=True)
                      for _ in range(2))
        start.record()
        run()
        end.record()
        end.synchronize()
        ms = start.elapsed_time(end)
    launches = {k: after[k] - before.get(k, 0) for k in after
                if after[k] != before.get(k, 0)}
    top = sorted(rec.ops.items(), key=lambda kv: (-kv[1], kv[0]))[:8]
    profile, pfindings = precision_audit.profile_record(rec, name, launches,
                                                        escapes)
    del run
    if cuda:
        torch.cuda.empty_cache()
    return EntryRecord(
        name=name, device=str(device), ops=sum(rec.ops.values()),
        backward_ops=rec.backward_ops, launches=launches,
        syncs=rec.syncs + sync_warnings, f64=dict(rec.f64),
        dense_routes=fa.DENSE_ROUTES["head_dim"] - dense0, ms=ms,
        top_ops=top, profile=profile, precision=pfindings)


# ------------------------------------------------------------ budget

def load_budget(path: str = BUDGET_PATH) -> dict:
    try:
        with open(path) as fh:
            return json.load(fh)
    except FileNotFoundError:
        return {}


def budget_for(device: str, path: str = BUDGET_PATH) -> dict[str, int]:
    return {k: int(v) for k, v in
            load_budget(path).get("ops", {}).get(_dev(device), {}).items()}


def known_syncs(device: str, path: str = BUDGET_PATH) -> dict[str, list]:
    """entry -> the sync frames ('relpath:function') listed as known
    differences from the reference (ROADMAP Queue C)."""
    return load_budget(path).get("known_syncs", {}).get(_dev(device), {})


def _dev(device) -> str:
    return "cuda" if str(device).startswith("cuda") else "cpu"


def write_budget(counts: dict[str, int], device: str,
                 path: str = BUDGET_PATH) -> None:
    """Freeze `counts` (with headroom) as `device`'s bounds, keeping the
    other device's section and the known syncs."""
    data = load_budget(path)
    ops = {}
    for name, count in sorted(counts.items()):
        padded = int(count * _BUDGET_HEADROOM)
        ops[name] = padded + (-padded % _BUDGET_QUANTUM)
    data.setdefault("ops", {})[_dev(device)] = ops
    data.setdefault("known_syncs", {})
    data["comment"] = (
        "frozen op-count (aten ops + kernel launches) upper bounds per "
        "entry point and device (graftlint stage `ops`), and the host "
        "syncs each entry is known to make (ROADMAP Queue C). Regenerate "
        "only when a legitimate change grows the step: "
        "port_tools/graftlint.py --update-budget --device cpu|cuda")
    with open(path, "w") as fh:
        json.dump({k: data[k] for k in ("comment", "ops", "known_syncs")},
                  fh, indent=1, sort_keys=True)
        fh.write("\n")


# ------------------------------------------------------------ audit

def check_entry(rec: EntryRecord, bound: int | None,
                known: list) -> list[Finding]:
    """J001-J004 over one entry's record."""
    name, out = rec.name, []
    for op, frame in rec.syncs:
        if frame_key(frame) in known:
            continue
        out.append(Finding(
            "J001", name, 0, 0,
            f"host sync `{op}` at {frame} inside the entry (the "
            "reference's jitted step is transfer-clean)",
            "keep the value on the card (or move the read after the "
            "step); if it cannot go yet, list its frame under "
            "known_syncs with a ROADMAP Queue C item",
            snippet=f"{op}@{frame_key(frame)}", stage="ops"))
    for op, frame in sorted(rec.f64.items()):
        out.append(Finding(
            "J003", name, 0, 0,
            f"`{op}` at {frame} reads or writes a float64 tensor — dtype "
            "drift into the step",
            "pin the dtype at the source (np.float32 constant / explicit "
            "dtype=)", snippet=f"f64:{op}", stage="ops"))
    if _needs_backward(name) and rec.backward_ops == 0:
        out.append(Finding(
            "J002", name, 0, 0,
            "the entry's backward recorded no op: the recorder did not "
            "see autograd's threads, so the count is not the step's",
            "record the backward (the mode must reach autograd's device "
            "threads) before trusting the bound",
            snippet="backward-unseen", stage="ops"))
    if bound is None:
        out.append(Finding(
            "J004", name, 0, 0,
            f"entry point has no frozen op budget on {rec.device} "
            f"(recorded {rec.count} ops + launches)",
            "run `python3 port_tools/graftlint.py --update-budget "
            f"--device {_dev(rec.device)}`",
            snippet="missing-budget", stage="ops"))
    elif rec.count > bound:
        out.append(Finding(
            "J002", name, 0, 0,
            f"{rec.ops} ops + {sum(rec.launches.values())} launches = "
            f"{rec.count}, over the frozen bound of {bound} — the step "
            "grew",
            "find what grew the step; only then refresh the budget "
            "(--update-budget)", snippet="over-budget", stage="ops"))
    return out


def audit(names=None, device: str = "cuda", budget_path: str = BUDGET_PATH):
    """Run the stage-2 audit on `device` -> (findings, {entry:
    EntryRecord})."""
    budget = budget_for(device, budget_path)
    known = known_syncs(device, budget_path)
    findings, records = [], {}
    for name in names if names is not None else entry_names():
        rec = records[name] = record_entry(name, device)
        findings.extend(check_entry(rec, budget.get(name),
                                    known.get(name, [])))
    return findings, records
