"""Stage 3: the collective-consistency audit (SPMD divergence detection)
— the counterpart of deeplearning4j_tpu/analysis/collective_audit.py
for eager PyTorch.

The JAX audit reads each entry's collectives from its jaxpr (shard_map
programs) or its compiled HLO (pjit programs). The port issues every
collective explicitly through `torch.distributed`, so its **signature**
is the ordered list of what one call of the entry issues through c10d,
recorded by the op audit's `OpRecorder` (a TorchDispatchMode sees every
c10d op with its operands, the backward's included):

- a collective as 'op@group-size dtype[shape]' ('allreduce_@8
  float32[83]');
- a point-to-point op as 'send@+k dtype[shape]' or 'recv_@+k ...', k
  = (peer - rank) mod the group's size: the relative peer makes a
  ring's signature the same on every rank.

The call runs under `simulated_process_group(rank, world)`, the twin of
the JAX `simulated_process_index`: the env contract's process id and
count, and torch's fake process group (no communication: a received
buffer keeps what it held), so one process runs an entry as any rank of
any world.

- C001: the signature (of simulated rank 0) drifts from the frozen one
  in analysis/collective_budget.json. The signature does not depend on
  the device, so there is one section, and the card must match it.
- C002: the entry is missing from that file.
- C003: the entry re-run as rank 0 and as rank 1 issues different
  sequences — a program that DEADLOCKS a live fleet, reported naming
  both sequences — or, where the entry's program is the same on every
  rank, the same sequence with different aten op counts. The reshard
  entry's ranks issue different point-to-point ops by design, so it is
  run at every rank of its world instead, and C003 there means that
  some send r -> s lacks a matching recv on s from r, of the same dtype
  and shape, in the same order.

Entries are the JAX audit's five, by the same names, at its builders'
sizes, inputs concrete from numpy seed 0. A .py passed to `graftlint
--stage spmd` that defines ``GRAFTLINT_SPMD_ENTRIES = {name: builder}``
(builder() -> (fn, args), called under the simulated group) gets each
entry divergence-checked at a world of two.

torch loads inside the functions, so the AST stages stay torch-free.
"""

from __future__ import annotations

import contextlib
import json
import os
import re

from deeplearning4j_tpu_torch.analysis.core import (
    Finding,
    audit_device,
    load_hook,
)

BUDGET_PATH = os.path.join(os.path.dirname(__file__),
                           "collective_budget.json")

# the hook external fixture modules expose: {entry_name: builder}
ENTRY_HOOK = "GRAFTLINT_SPMD_ENTRIES"

SIMULATED_PROCESSES = (0, 1)

RESHARD_ENTRY = "reshard/live_transpose_2x4"


def entry_names() -> list[str]:
    """Auditable stage-3 entry points (stable order): the JAX audit's."""
    return [
        "distributed/allreduce_step_2x4",
        "distributed/overlap_step_2x4",
        RESHARD_ENTRY,
        "ring_attention/seq4",
        "sequence_parallel/sp_step_seq2",
    ]


# ----------------------------------------------------- rank simulation

@contextlib.contextmanager
def simulated_process_group(rank: int, world: int, device=None):
    """Run the enclosed code as rank `rank` of a fleet of `world`, in
    this process (the twin of the JAX `simulated_process_index`): the
    env contract's process id and count, torch's fake process group as
    the default group (collectives are issued, nothing moves) and
    `device` as this process's device; restored on exit. Refuses to run
    inside a live group (`distributed/bootstrap.py` `simulated_group`)."""
    device = audit_device(device)
    from deeplearning4j_tpu_torch.distributed import bootstrap

    with bootstrap.simulated_group(rank, world, device):
        yield


def record_signature(build, rank: int, world: int, device=None):
    """-> (signature, aten op count) of one call of `fn(*args)` (from
    `build()`, called under the simulation) as rank `rank` of
    `world`."""
    device = audit_device(device)
    from deeplearning4j_tpu_torch.analysis import op_audit

    with simulated_process_group(rank, world, device):
        fn, args = build()
        rec = op_audit._recorder_class()()
        with rec:
            fn(*args)
        return list(rec.collectives), rec.aten_ops


def check_divergence(name: str, build, world: int = 2, device=None, *,
                     same_program: bool = True,
                     first=None) -> list[Finding]:
    """Record one entry as simulated rank 0 and rank 1 and hold the two
    signatures equal: a divergent pair is a DEADLOCK finding (C003)
    naming both; with `same_program`, equal signatures with different
    aten op counts are the same class. `first`: rank 0's (signature,
    count) when the caller has it."""
    device = audit_device(device)
    results = {0: first} if first is not None else {}
    for pid in SIMULATED_PROCESSES:
        if pid not in results:
            results[pid] = record_signature(build, pid, world, device)
    (sig0, n0), (sig1, n1) = (results[p] for p in SIMULATED_PROCESSES)
    if sig0 != sig1:
        return [Finding(
            "C003", name, 0, 0,
            "rank-divergent collective sequence — this program DEADLOCKS "
            f"a live fleet (NCCL and gloo wait forever): process 0 issues "
            f"{sig0 or '[]'} but process 1 issues {sig1 or '[]'}",
            "remove the rank-dependent branch around the collective "
            "(G010); every process must issue the identical sequence",
            snippet="rank-divergent-collectives", stage="spmd")]
    if same_program and n0 != n1:
        return [Finding(
            "C003", name, 0, 0,
            f"rank-divergent program — identical collective sequences but "
            f"{n0} vs {n1} aten ops under simulated process 0 vs 1: a "
            "rank-dependent value steers the program (G011 shape) and the "
            "replicas will desync",
            "make the program rank-invariant; read the rank only in "
            "host-side code that issues no op",
            snippet="rank-divergent-ops", stage="spmd")]
    return []


_P2P = re.compile(r"^(send|recv_)@\+(\d+) (.*)$")


def unmatched_moves(signatures: dict, world: int) -> list[str]:
    """Point-to-point pairs that do not match over the ranks of a world
    ({rank: signature}, the default group): for each ordered pair (r,
    s), the sends r -> s, in order, must equal the recvs s <- r, same
    dtype and shape. -> one description a mismatched pair."""
    sends, recvs = {}, {}
    for r, sig in signatures.items():
        for item in sig:
            m = _P2P.match(item)
            if m is None:
                continue
            peer = (r + int(m.group(2))) % world
            if m.group(1) == "send":
                sends.setdefault((r, peer), []).append(m.group(3))
            else:
                recvs.setdefault((peer, r), []).append(m.group(3))
    out = []
    for pair in sorted(set(sends) | set(recvs)):
        if sends.get(pair, []) != recvs.get(pair, []):
            out.append(f"{pair[0]}->{pair[1]}: sends "
                       f"{sends.get(pair, [])} but recvs "
                       f"{recvs.get(pair, [])}")
    return out


def check_moves(name: str, build_at, world: int, device=None,
                first=None) -> list[Finding]:
    """Record the entry at every rank of `world` (`build_at(rank)` ->
    builder) and match its sends with its recvs (C003)."""
    device = audit_device(device)
    sigs = {0: first[0]} if first is not None else {}
    for r in range(world):
        if r not in sigs:
            sigs[r] = record_signature(build_at(r), r, world, device)[0]
    bad = unmatched_moves(sigs, world)
    if bad:
        return [Finding(
            "C003", name, 0, 0,
            "unmatched point-to-point moves — a send with no matching "
            "recv (or one out of order) DEADLOCKS a live fleet: "
            + "; ".join(bad),
            "every rank must run the same move plan; a piece sent r -> s "
            "is received on s from r, in the same order",
            snippet="unmatched-moves", stage="spmd")]
    return []


# -------------------------------------------------------- entry points

def _mln(device, overlap=None):
    """The JAX builders' net (6 -> 8 tanh -> 3 softmax, mcxent, SGD, lr
    0.1, seed 7) over {"data": 8} and its train step on a 32-row batch
    (this rank's rows)."""
    import numpy as np

    from deeplearning4j_tpu_torch.datasets import DataSet
    from deeplearning4j_tpu_torch.nn.conf import (DenseLayer,
                                                  NeuralNetConfiguration,
                                                  OutputLayer)
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
    from deeplearning4j_tpu_torch.parallel.mesh import make_mesh
    from deeplearning4j_tpu_torch.parallel.placement import local_dataset

    conf = (NeuralNetConfiguration.builder()
            .seed(7).learning_rate(0.1).updater("sgd").list()
            .layer(DenseLayer(n_in=6, n_out=8, activation="tanh"))
            .layer(OutputLayer(n_in=8, n_out=3, activation="softmax",
                               loss_function="mcxent"))
            .build())
    net = MultiLayerNetwork(conf, device=device).init()
    # 128-byte buckets split the 83-param net into several buckets
    net.set_mesh(make_mesh({"data": 8}), overlap=overlap)
    rng = np.random.default_rng(0)
    x = rng.random((32, 6), dtype=np.float32)
    y = np.eye(3, dtype=np.float32)[rng.integers(0, 3, 32)]
    batch = net._batch_dict(local_dataset(net, DataSet(x, y)))
    step = net._get_train_step()
    return step, (net.params, net.opt_state, net.state, net._generator,
                  batch)


def _reshard(device, rank):
    """The live move of the JAX entry: w [8, 8] split on its columns over
    "model" of {data 2, model 4} to its rows over "model" of {data 4,
    model 2}, and b [8] split over "model" to replicated; this rank's
    pieces by `reshard/executor.py` `execute_moves`."""
    from types import SimpleNamespace

    import torch

    from deeplearning4j_tpu_torch.reshard import executor as tex

    like = {("w",): ((8, 8), torch.float32), ("b",): ((8,), torch.float32)}
    src = tex.PortLayout(like, 8, tex.virtual_mesh({"data": 2, "model": 4},
                                                  device),
                         SimpleNamespace(leaves={("w",): ("model", 1, None),
                                                 ("b",): ("model", 0, None)}))
    dst = tex.PortLayout(like, 8, tex.virtual_mesh({"data": 4, "model": 2},
                                                  device),
                         SimpleNamespace(leaves={("w",): ("model", 0, None)}))
    mplan = tex.MovePlan(tex.leaf_keys(like, {}, {}), src, dst,
                         lambda k: like[k[-1]])
    whole = {("w",): torch.arange(64, dtype=torch.float32).reshape(8, 8),
             ("b",): torch.arange(8, dtype=torch.float32)}
    values = {}
    for key, path, _ in tex.leaf_keys(like, {}, {}):
        t = whole[path]
        for dim, idx in src.holding(rank, path).items():
            t = t.index_select(dim, idx)
        values[key] = t.to(device)
    return (lambda: tex.execute_moves(mplan, {rank: values}, (rank,),
                                      device)), ()


def _ring(device):
    """ring_self_attention over {"seq": 4}, q = k = v [1, 1, 8, 4] f32
    (local blocks of 2: the einsum route) through ProcessGroupRing."""
    import numpy as np
    import torch

    from deeplearning4j_tpu_torch.parallel.mesh import make_mesh
    from deeplearning4j_tpu_torch.parallel.ring_attention import \
        ring_self_attention

    mesh = make_mesh({"seq": 4})
    x = torch.as_tensor(np.random.default_rng(0).standard_normal(
        (1, 1, 8, 4), dtype=np.float32), device=device)
    return (lambda q, k, v: ring_self_attention(q, k, v, mesh)), (x, x, x)


def _sp(device):
    """make_sp_train_step on transformer_lm(vocab 17, d_model 8, 2 heads,
    1 layer, d_ff 16, max_length 8, seed 3) over {"seq": 2}, tokens zeros
    [2, 8] (this rank's block of 4)."""
    import numpy as np

    from deeplearning4j_tpu_torch.datasets import DataSet
    from deeplearning4j_tpu_torch.models.transformer import transformer_lm
    from deeplearning4j_tpu_torch.parallel.mesh import make_mesh
    from deeplearning4j_tpu_torch.parallel.sequence_parallel import \
        make_sp_train_step

    net = transformer_lm(vocab_size=17, d_model=8, n_heads=2, n_layers=1,
                         d_ff=16, max_length=8, seed=3,
                         seq_parallel_axis="seq", device=device)
    net.init()
    mesh = make_mesh({"seq": 2})
    step = make_sp_train_step(net, mesh, seq_axis="seq")
    toks = np.zeros((2, 8), np.int32)
    i, Tl = mesh.axis_index("seq"), 4
    block = toks[:, i * Tl:(i + 1) * Tl]
    batch = net._batch_dict(net._to_mds(DataSet(block, np.roll(block, -1,
                                                               axis=1))))
    return step, (net.params, net.opt_state, net.state, net._generator,
                  batch)


# name -> (builder of (fn, args) on a device, world size, whether every
# rank runs the same program: a causal ring skips a rank's future
# blocks, so its ranks' op counts differ by design)
_ENTRIES = {
    "distributed/allreduce_step_2x4": (lambda d: _mln(d), 8, True),
    "distributed/overlap_step_2x4": (lambda d: _mln(d, overlap=128), 8,
                                     True),
    "ring_attention/seq4": (_ring, 4, False),
    "sequence_parallel/sp_step_seq2": (_sp, 2, False),
}


def _builder(name, device, rank=0):
    if name == RESHARD_ENTRY:
        return lambda: _reshard(device, rank)
    return lambda: _ENTRIES[name][0](device)


def world_of(name: str) -> int:
    return 8 if name == RESHARD_ENTRY else _ENTRIES[name][1]


# -------------------------------------------------------------- audit

def load_budget(path: str | None = None) -> dict[str, list[str]]:
    try:
        with open(path or BUDGET_PATH) as fh:
            return {k: list(v)
                    for k, v in json.load(fh)["signatures"].items()}
    except FileNotFoundError:
        return {}


def write_budget(signatures: dict[str, list[str]],
                 path: str | None = None) -> None:
    with open(path or BUDGET_PATH, "w") as fh:
        json.dump(
            {"comment": "frozen ordered collective signatures per entry "
                        "point, as simulated rank 0 issues them (graftlint "
                        "stage 3; the same on every device). A drift here "
                        "is a rank-divergence regression unless "
                        "deliberate: port_tools/graftlint.py "
                        "--update-collectives",
             "signatures": {k: signatures[k] for k in sorted(signatures)}},
            fh, indent=1)
        fh.write("\n")


def audit(names=None, budget_path: str | None = None, *,
          divergence: bool = True, device=None):
    """Run the stage-3 audit -> (findings, {entry: signature})."""
    device = audit_device(device)
    budget = load_budget(budget_path)
    findings, signatures = [], {}
    for name in names if names is not None else entry_names():
        world = world_of(name)
        first = record_signature(_builder(name, device), 0, world, device)
        sig = signatures[name] = first[0]
        frozen = budget.get(name)
        if frozen is None:
            findings.append(Finding(
                "C002", name, 0, 0,
                f"entry point has no frozen collective signature "
                f"(recorded {len(sig)} c10d op(s))",
                "run `python3 port_tools/graftlint.py "
                "--update-collectives`",
                snippet="missing-signature", stage="spmd"))
        elif frozen != sig:
            findings.append(Finding(
                "C001", name, 0, 0,
                f"collective signature drift — frozen {frozen} but the "
                f"call now issues {sig}: a reordered/added/dropped "
                "collective is how rank-divergence regressions start",
                "find what changed the collective sequence; only then "
                "refreeze (--update-collectives)",
                snippet="signature-drift", stage="spmd"))
        if not divergence:
            continue
        if name == RESHARD_ENTRY:
            findings.extend(check_moves(
                name, lambda r: _builder(name, device, r), world, device,
                first=first))
        else:
            findings.extend(check_divergence(
                name, _builder(name, device), world, device,
                same_program=_ENTRIES[name][2], first=first))
    return findings, signatures


def load_entry_module(path: str) -> dict:
    """The GRAFTLINT_SPMD_ENTRIES hook ({name: builder}) a fixture .py
    defines, or {} (`core.load_hook`)."""
    return load_hook(path, ENTRY_HOOK)


def audit_paths(paths, device=None):
    """Divergence-check every external entry the given .py files expose
    at a world of two (no frozen-signature requirement: fixture entries)
    -> (findings, {entry: rank 0's signature})."""
    device = audit_device(device)
    findings, signatures = [], {}
    world = len(SIMULATED_PROCESSES)
    for path in paths:
        if not (path.endswith(".py") and os.path.isfile(path)):
            continue
        for name, build in load_entry_module(path).items():
            first = record_signature(build, 0, world, device)
            signatures[name] = first[0]
            findings.extend(check_divergence(name, build, world, device,
                                             first=first))
    return findings, signatures
