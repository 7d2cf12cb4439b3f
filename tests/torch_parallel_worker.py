"""Rank program of the port's multi-rank CPU tests
(tests/test_torch_parallel.py, test_torch_sequence_parallel.py,
test_torch_tensor_parallel.py, test_torch_pipeline.py,
test_torch_reshard.py and others).

Run by `deeplearning4j_tpu_torch.distributed.launcher.launch_local` as N
processes on the CPU (gloo), one intra-op thread each:

    python tests/torch_parallel_worker.py SPEC.json

SPEC names a directory and a list of cases; each case reads its inputs
(initial params as the JAX package made them, the batches) from
``<dir>/<case>.npz`` and every rank writes what the case produced to
``<dir>/out_rank<r>.npz`` under ``<case>/<key>``, for the test, which
holds it against the JAX package in its own process. This program
imports neither jax nor the JAX package.
"""

from __future__ import annotations

import json
import sys
from pathlib import Path

import numpy as np
import torch

from deeplearning4j_tpu_torch.datasets import DataSet
from deeplearning4j_tpu_torch.datasets.iterators import ListDataSetIterator
from deeplearning4j_tpu_torch.distributed import bootstrap
from deeplearning4j_tpu_torch.models.resnet import resnet20
from deeplearning4j_tpu_torch.models.transformer import (
    transformer_lm,
    transformer_moe_lm,
)
from deeplearning4j_tpu_torch.nn import conf as conf_mod
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
from deeplearning4j_tpu_torch.parallel.data_parallel import (
    DataParallelTrainer,
    ParameterAveragingTrainer,
)
from deeplearning4j_tpu_torch.parallel.mesh import make_mesh
from deeplearning4j_tpu_torch.parallel.overlap import plan_buckets
from deeplearning4j_tpu_torch.parallel.ring_attention import (
    ProcessGroupRing,
    ring_attention,
    ring_self_attention,
)
from deeplearning4j_tpu_torch.parallel.sequence_parallel import (
    SequenceParallelTrainer,
)
from deeplearning4j_tpu_torch.util.checkpoint import Checkpointer
from deeplearning4j_tpu_torch.weights_io import (
    params_from_jax,
    params_to_numpy,
    state_from_jax,
    state_to_numpy,
)


def flatten(tree, prefix=""):
    """{"layer/name": array} of a nested dict of arrays."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(flatten(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = np.asarray(v)
    return out


def unflatten(flat, prefix):
    """The nested dict under `prefix` of a flattened npz."""
    out = {}
    for key in flat.files if hasattr(flat, "files") else flat:
        if not key.startswith(prefix):
            continue
        node = out
        parts = key[len(prefix):].split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = np.asarray(flat[key])
    return out


def set_updater(net, case):
    """The case's updater, learning rate and momentum on a net's conf
    (JAX package's or port's) before init: the global settings and every
    layer's, which the conf builder copied from them (a case without an
    updater keeps the model's); and its gradient normalization
    (`grad_norm`) on every layer."""
    g = net.conf.conf
    layers = ([v.layer for v in net.layer_vertices.values()]
              if hasattr(net, "layer_vertices") else net.layer_confs)
    if "updater" in case:
        g.updater, g.learning_rate = case["updater"], case["lr"]
        if "momentum" in case:
            g.momentum = case["momentum"]
        for lc in layers:
            lc.updater, lc.learning_rate = case["updater"], None
    if "grad_norm" in case:
        for lc in layers:
            lc.gradient_normalization = case["grad_norm"]
    return net


def mlp_conf(conf_mod):
    """The two-layer classifier of the JAX package's tests/test_parallel.py
    (`_net`), from either package's conf module."""
    return (conf_mod.NeuralNetConfiguration.builder().seed(5)
            .learning_rate(0.1).updater(conf_mod.Updater.SGD).list()
            .layer(conf_mod.DenseLayer(n_in=4, n_out=8, activation="tanh"))
            .layer(conf_mod.OutputLayer(n_in=8, n_out=2,
                                        activation="softmax"))
            .build())


def bn_graph_conf(conf_mod):
    """The batch-norm stack of the JAX package's tests/test_unified_mesh.py
    (`test_pp_batchnorm_stack_trains`): four uniform dense + batch-norm
    blocks and a softmax head, from either package's conf module."""
    g = (conf_mod.NeuralNetConfiguration.builder().seed(7)
         .learning_rate(0.01).updater("sgd").graph_builder())
    g.add_inputs("in")
    src = "in"
    for b in range(4):
        g.add_layer(f"blk{b}_fc", conf_mod.DenseLayer(
            n_in=16, n_out=16, activation="relu"), src)
        g.add_layer(f"blk{b}_bn", conf_mod.BatchNormalization(
            n_in=16, n_out=16), f"blk{b}_fc")
        src = f"blk{b}_bn"
    g.add_layer("out", conf_mod.OutputLayer(
        n_in=16, n_out=3, activation="softmax", loss_function="mcxent"), src)
    g.set_outputs("out")
    return g.build()


def _net(case, inputs):
    """The case's net on the CPU with the JAX package's initial params
    (and batch-norm state), its updater set as the case says."""
    if case["model"] == "bn":
        from deeplearning4j_tpu_torch.nn.graph import ComputationGraph

        net = ComputationGraph(bn_graph_conf(conf_mod), device="cpu")
    elif case["model"] == "lm":
        # `sp_axis`: the port's conf built for sequence parallelism (the
        # JAX package's params are the same with or without it)
        cfg = dict(case["cfg"])
        if case.get("sp_axis"):
            cfg["seq_parallel_axis"] = case["sp_axis"]
        net = transformer_lm(**cfg, device="cpu")
    elif case["model"] == "moe":
        net = transformer_moe_lm(**case["cfg"], device="cpu")
    elif case["model"] == "mlp":
        net = MultiLayerNetwork(mlp_conf(conf_mod), device="cpu")
    else:
        net = resnet20(device="cpu")
    set_updater(net, case)
    net.init()
    # layers without params or state (npz keeps no empty dict) keep {}
    net.params = {**{k: {} for k in net.params},
                  **params_from_jax(unflatten(inputs, "params/"), "cpu")}
    net.state = {**{k: {} for k in net.state},
                 **state_from_jax(unflatten(inputs, "state/"), "cpu")}
    net.opt_state = net.tx.init(net.params)
    return net


def _batches(inputs):
    out = []
    i = 0
    while f"x{i}" in inputs.files:
        kw = {}
        if f"lmask{i}" in inputs.files:
            kw["labels_mask"] = inputs[f"lmask{i}"]
        if f"fmask{i}" in inputs.files:
            kw["features_mask"] = inputs[f"fmask{i}"]
        out.append(DataSet(inputs[f"x{i}"], inputs[f"y{i}"], **kw))
        i += 1
    return out


def _trained(net):
    out = {f"params/{k}": v
           for k, v in flatten(params_to_numpy(net)).items()}
    out.update({f"state/{k}": v
                for k, v in flatten(state_to_numpy(net.state)).items()})
    out["score"] = np.asarray(net.score_value)
    return out


def case_dp(case, inputs):
    """DataParallelTrainer (monolithic, or `overlap` bucket bytes) over
    a data mesh of every rank, one fit() per batch."""
    net = _net(case, inputs)
    mesh = make_mesh({"data": -1}, device="cpu")
    trainer = DataParallelTrainer(net, mesh, overlap=case.get("overlap"))
    for ds in _batches(inputs):
        trainer.fit(ds)
    out = _trained(net)
    out["n_buckets"] = np.asarray(
        0 if net._overlap_plan is None else len(net._overlap_plan.buckets))
    return out


def case_pa(case, inputs):
    """ParameterAveragingTrainer(averaging_frequency=k) over the batches
    in one fit()."""
    net = _net(case, inputs)
    mesh = make_mesh({"data": -1}, device="cpu")
    trainer = ParameterAveragingTrainer(net, mesh,
                                        averaging_frequency=case["k"])
    trainer.fit(ListDataSetIterator(_batches(inputs)))
    return _trained(net)


def case_eval(case, inputs):
    """output() and evaluate() under a data mesh, and the same net's
    after set_mesh(None)."""
    net = _net(case, inputs)
    x, y = inputs["x"], inputs["y"]
    net.set_mesh(make_mesh({"data": -1}, device="cpu"))
    out = {"mesh_out": net.output(x).numpy(),
           "mesh_out_odd": net.output(x[:-1]).numpy(),
           "mesh_cm": net.evaluate(DataSet(x, y)).confusion.matrix}
    net.set_mesh(None)
    out["local_out"] = net.output(x).numpy()
    return out


def case_ring(case, inputs):
    """ring_self_attention over a seq mesh of every rank (both causal
    cases), and the gradients of this rank's block through the
    per-shard ring."""
    mesh = make_mesh({"seq": -1}, device="cpu")
    q, k, v = (torch.from_numpy(inputs[n]) for n in "qkv")
    out = {}
    for causal in (True, False):
        out[f"out_causal{int(causal)}"] = ring_self_attention(
            q, k, v, mesh, causal=causal).numpy()
    ring = ProcessGroupRing(mesh.group("seq"), mesh.axis_size("seq"),
                            mesh.axis_index("seq"))
    Tl = q.shape[2] // ring.n
    sl = slice(ring.index * Tl, (ring.index + 1) * Tl)
    blocks = [t[:, :, sl].clone().requires_grad_() for t in (q, k, v)]
    o = ring_attention(*blocks, transport=ring, causal=True,
                       hop_chunk=case.get("hop_chunk"))
    (o.float() ** 2).sum().backward()
    for name, t in zip("qkv", blocks):
        out[f"d{name}"] = t.grad.numpy()
    out["block_out"] = o.detach().numpy()
    return out


def case_sp(case, inputs):
    """SequenceParallelTrainer on a seq (or data x seq) mesh, or with
    `roles` set_mesh with those roles ("seq" with "model"), one fit()
    per batch. With `record_seeds`: every ring dropout seed the split
    attention layers folded (the step seed, the slice offset, the
    folded seed), and this rank's mesh coordinates."""
    net = _net(case, inputs)
    mesh = make_mesh(case["axes"], device="cpu")
    seeds = []
    if case.get("record_seeds"):
        from deeplearning4j_tpu_torch.nn.layers import attention

        fold = attention.fold_slices

        def recording(seed, offset):
            out = fold(seed, offset)
            seeds.append((int(seed), int(offset), int(out)))
            return out

        attention.fold_slices = recording
    if case.get("roles"):
        net.set_mesh(mesh, axes=case["roles"])
        fit = net.fit
    else:
        fit = SequenceParallelTrainer(net, mesh, seq_axis="seq",
                                      data_axis=case.get("data_axis")).fit
    for ds in _batches(inputs):
        fit(ds)
    out = _trained(net)
    if case.get("record_seeds"):
        attention.fold_slices = fold
        out["seeds"] = np.asarray(seeds, np.int64).reshape(-1, 3)
        out["coords"] = np.asarray([mesh.axis_index(a)
                                    for a in ("seq", "model")])
    return out


def case_solver(case, inputs):
    """fit() through the Solver path (`algo`, `iterations` a batch) under
    set_mesh with the case's mesh, roles, tp_rules and zero1, one fit()
    per batch; the number of split leaves."""
    net = _net(case, inputs)
    net.conf.conf.optimization_algo = case["algo"]
    net.conf.conf.iterations = case.get("iterations", 3)
    mesh = make_mesh(case["mesh"], device="cpu")
    net.set_mesh(mesh, axes=case.get("axes"), tp_rules=case.get("tp_rules"),
                 zero1=case.get("zero1", False))
    for ds in _batches(inputs):
        net.fit(ds)
    out = _trained(net)
    out["iterations"] = np.asarray(net.iteration_count)
    out["n_split"] = np.asarray(0 if net._split_plan is None
                                else len(net._split_plan.leaves))
    return out


def flat_opt_state(opt_state):
    """{"label/moment/leaf path": array} of an Optimizer state: copies,
    which the next in-place update leaves as they are."""
    out = {}
    for label, st in opt_state.items():
        for name, v in st.items():
            if name == "keys" or not isinstance(v, list):
                continue
            for key, t in zip(st["keys"], v):
                out[f"{label}/{name}/{'/'.join(key)}"] = np.array(
                    t.detach().float().numpy())
    return out


def case_mesh(case, inputs):
    """set_mesh with the case's mesh, roles, zero1 and overlap (a
    "psum_scatter" bucket plan when `overlap_mode` says so), one fit()
    per batch. Returns the canonical params and optimizer state, the
    local shape of every split param and ZeRO-1 moment, and whether the
    checkpoint this rank saves holds exactly the canonical trees."""
    net = _net(case, inputs)
    mesh = make_mesh(case["mesh"], device="cpu")
    overlap = case.get("overlap")
    if case.get("overlap_mode"):
        overlap = plan_buckets(net.params, overlap,
                               layer_order=list(net.params),
                               mode=case["overlap_mode"])
    net.set_mesh(mesh, axes=case.get("axes"), zero1=case.get("zero1", False),
                 overlap=overlap)
    for ds in _batches(inputs):
        net.fit(ds)
    out = _trained(net)
    out.update({f"opt/{k}": v for k, v in flat_opt_state(
        net.canonical_opt_state()).items()})
    if net._split_plan is not None:
        for path in net._split_plan.leaves:
            t = net.params[path[0]]["/".join(path[1:])]
            out[f"split/{'/'.join(path)}"] = np.asarray(t.shape)
    if net._zero1 is not None:
        for k, t in flat_opt_state(net.opt_state).items():
            out[f"zero1/{k}"] = np.asarray(t.shape)
    d = Path(case["ckpt"]) / f"rank{mesh.rank}"
    Checkpointer(str(d)).save(net)
    saved = torch.load(d / f"step_{net.iteration_count}" / "model.pt",
                       weights_only=True)
    same = all(np.array_equal(a, out[f"params/{k}"]) for k, a in flatten(
        params_to_numpy(saved["params"])).items())
    same &= all(np.array_equal(a, out[f"opt/{k}"]) for k, a in
                flat_opt_state(saved["opt_state"]).items())
    out["ckpt_is_canonical"] = np.asarray(same)
    return out


def case_before_init(case, inputs):
    """set_mesh before init (the JAX package's test_tp_set_mesh_before_init):
    the placement follows the automatic init; the net then trains as a
    meshless net of the same (port-made) init on the same batches."""
    out = {}
    for arm in ("meshless", "placed"):
        net = transformer_lm(**case["cfg"], device="cpu")
        set_updater(net, case)
        if arm == "placed":
            net.set_mesh(make_mesh(case["mesh"], device="cpu"),
                         axes=case["axes"])
            out["placed_before_fit"] = np.asarray(
                net._split_plan is not None and bool(net._split_plan.layers))
        for ds in _batches(inputs):
            net.fit(ds)
        out.update({f"{arm}/{k}": v for k, v in _trained(net).items()})
    return out


def _fit_all(net, batches, scanned=False):
    """Fit the batches (one fit() each, or one fit_scanned over them);
    the loss of every step."""
    if scanned:
        net.fit_scanned(ListDataSetIterator(batches))
        return np.asarray([float(x) for x in net._step_losses.reshape(-1)])
    losses = []
    for ds in batches:
        net.fit(ds)
        losses.append(float(net.score_value))
    return np.asarray(losses)


def case_pipe(case, inputs):
    """set_mesh with a "pipe" role (and the case's other roles) and M
    microbatches, then the batches (`scanned`: through fit_scanned).
    Returns the canonical params, state and optimizer state, each step's
    loss, the layers this rank holds, the output and score of the eval
    batch; with `inproc`, rank 0 also trains a twin through the
    in-process pipeline of as many stages and reports whether params,
    optimizer state and losses equal the fleet's bit for bit."""
    from deeplearning4j_tpu_torch.parallel.pipeline import place_in_process

    net = _net(case, inputs)
    mesh = make_mesh(case["mesh"], device="cpu")
    net.set_mesh(mesh, axes=case["axes"], n_microbatches=case["M"])
    batches = _batches(inputs)
    losses = _fit_all(net, batches, case.get("scanned", False))
    out = _trained(net)
    out["losses"] = losses
    out["held"] = np.asarray(sorted(net.params))
    opt = flat_opt_state(net.canonical_opt_state())
    out.update({f"opt/{k}": v for k, v in opt.items()})
    if "x" in inputs.files:
        x, y = inputs["x"], inputs["y"]
        out["output"] = net.output(x).float().numpy()
        out["eval_score"] = np.asarray(net.score(DataSet(x, y)))
    if case.get("odd_T"):
        # a sequence length the seq axis does not divide: the JAX
        # package's error text
        ds = batches[0]
        try:
            net.fit(DataSet(ds.features[:, :-1], ds.labels[:, :-1]))
            out["odd_T_error"] = np.asarray("")
        except ValueError as e:
            out["odd_T_error"] = np.asarray(str(e))
    if case.get("inproc") and mesh.rank == 0:
        twin = _net(case, inputs)
        place_in_process(twin, mesh.axis_size(case["axes"]["pipe"]),
                         case["M"])
        twin_losses = _fit_all(twin, batches, case.get("scanned", False))
        mine = flatten(params_to_numpy(twin))
        same = all(np.array_equal(mine[k[len("params/"):]], v)
                   for k, v in out.items() if k.startswith("params/"))
        same &= all(np.array_equal(v, opt[k]) for k, v in flat_opt_state(
            twin.opt_state).items())
        out["inproc_same"] = np.asarray(
            same and np.array_equal(twin_losses, losses))
    return out


def _placed_net(case, inputs, spec):
    """The case's net from the JAX params, placed as `spec` {"mesh",
    "axes", "zero1", "M"} says (no set_mesh for a spec of None)."""
    net = _net(case, inputs)
    if spec is not None:
        net.set_mesh(make_mesh(spec["mesh"], device="cpu"),
                     axes=spec.get("axes"), zero1=spec.get("zero1", False),
                     n_microbatches=spec.get("M"))
    return net


def _canonical(net, prefix=""):
    out = {f"{prefix}params/{k}": v
           for k, v in flatten(params_to_numpy(net)).items()}
    out.update({f"{prefix}opt/{k}": v for k, v in flat_opt_state(
        net.canonical_opt_state()).items()})
    return out


def _recorded(fn):
    """fn() under an in-memory telemetry recorder: (its result, the
    recorder's events)."""
    from deeplearning4j_tpu_torch.telemetry import Recorder, set_default

    rec = Recorder(path=None)
    prev = set_default(rec)
    try:
        return fn(), list(rec.events)
    finally:
        set_default(prev)


def _span_bytes(events):
    spans = [e for e in events if e.get("event") == "span"
             and e.get("name") == "reshard"]
    plans = [e for e in events if e.get("event") == "reshard_plan"]
    return (len(plans), sum(e.get("bytes_moved", 0) for e in spans),
            sum(e.get("bytes_planned", 0) for e in spans),
            sum(e.get("bytes_lower_bound", 0) for e in spans))


def case_reshard(case, inputs):
    """The resharding matrix on this fleet. mode "save": the net placed
    as `src`, `fit` steps, its checkpoint under <ckpt>/rank<r>; "restore":
    a fresh net placed as `dst` restores <src_ckpt> (rank 0's), then
    takes one step, against a twin restored meshless and placed the same
    way; "live": the net placed as each of `chain` in turn (one step
    under the first), the canonical trees after every move, its
    reshard_plan events and the bytes its spans moved and planned, and
    the plans' lower bounds; "resume": a fresh net restores <src_ckpt>
    (rank 0's) by `resume_from(target_mesh=..., target_axes=...)` into
    `dst`, against a twin that resumes whole and then takes set_mesh,
    both then one step; a missing named step and an empty directory
    beside."""
    batches = _batches(inputs)
    rank = bootstrap_rank()
    out = {}
    if case["mode"] == "save":
        net = _placed_net(case, inputs, case["src"])
        for ds in batches[:case.get("fit", 1)]:
            net.fit(ds)
        out.update(_canonical(net))
        Checkpointer(str(Path(case["ckpt"]) / f"rank{rank}")).save(net)
    elif case["mode"] == "resume":
        import tempfile

        src = str(Path(case["src_ckpt"]) / "rank0")
        dst = case["dst"]
        mesh = make_mesh(dst["mesh"], device="cpu")
        net = _placed_net(case, inputs, None)
        start, events = _recorded(lambda: net.resume_from(
            src, target_mesh=mesh, target_axes=dst.get("axes")))
        out["start"] = np.asarray(start)
        out.update(_canonical(net, "restored/"))
        out["restore_plans"] = np.asarray(len(
            [e for e in events if e.get("event") == "reshard_plan"
             and e.get("path") == "checkpoint"]))
        _, moved, planned, _ = _span_bytes(events)
        out["restore_moved"] = np.asarray(moved)
        out["restore_planned"] = np.asarray(planned)
        out["placed"] = np.asarray(net._split_plan is not None
                                   or net._pipe is not None)
        twin = _placed_net(case, inputs, None)
        twin.resume_from(src)
        twin.set_mesh(mesh, axes=dst.get("axes"))
        net.fit(batches[0])
        twin.fit(batches[0])
        out.update(_canonical(net, "stepped/"))
        out.update(_canonical(twin, "twin/"))
        out["stepped_score"] = np.asarray(net.score_value)
        out["twin_score"] = np.asarray(twin.score_value)
        try:
            _placed_net(case, inputs, None).resume_from(
                src, 99, target_mesh=mesh, target_axes=dst.get("axes"))
            out["missing_raises"] = np.asarray(False)
        except FileNotFoundError:
            out["missing_raises"] = np.asarray(True)
        with tempfile.TemporaryDirectory() as empty:
            out["cold_start"] = np.asarray(_placed_net(
                case, inputs, None).resume_from(
                    empty, target_mesh=mesh, target_axes=dst.get("axes")))
    elif case["mode"] == "restore":
        src = str(Path(case["src_ckpt"]) / "rank0")
        net = _placed_net(case, inputs, case["dst"])
        _, events = _recorded(lambda: Checkpointer(src).restore(net))
        out.update(_canonical(net, "restored/"))
        out["restore_plans"] = np.asarray(len(
            [e for e in events if e.get("event") == "reshard_plan"
             and e.get("path") == "checkpoint"]))
        _, moved, planned, _ = _span_bytes(events)
        out["restore_moved"] = np.asarray(moved)
        out["restore_planned"] = np.asarray(planned)
        twin = _placed_net(case, inputs, None)
        Checkpointer(src).restore(twin)
        dst = case["dst"]
        twin.set_mesh(make_mesh(dst["mesh"], device="cpu"),
                      axes=dst.get("axes"), zero1=dst.get("zero1", False),
                      n_microbatches=dst.get("M"))
        net.fit(batches[0])
        twin.fit(batches[0])
        out.update(_canonical(net, "stepped/"))
        out.update(_canonical(twin, "twin/"))
        out["stepped_score"] = np.asarray(net.score_value)
        out["twin_score"] = np.asarray(twin.score_value)
    else:
        chain = case["chain"]
        net = _placed_net(case, inputs, chain[0])
        net.fit(batches[0])
        out.update(_canonical(net, "0/"))
        for i, spec in enumerate(chain[1:], start=1):
            mesh = (None if spec is None
                    else make_mesh(spec["mesh"], device="cpu"))
            _, events = _recorded(lambda: net.set_mesh(
                mesh, axes=None if spec is None else spec.get("axes"),
                zero1=False if spec is None else spec.get("zero1", False),
                n_microbatches=None if spec is None else spec.get("M")))
            out.update(_canonical(net, f"{i}/"))
            n_plans, moved, planned, bound = _span_bytes(events)
            out[f"{i}/plans"] = np.asarray(n_plans)
            out[f"{i}/bytes_moved"] = np.asarray(moved)
            out[f"{i}/bytes_planned"] = np.asarray(planned)
            out[f"{i}/bytes_lower_bound"] = np.asarray(bound)
        net.fit(batches[1])
        out["after_score"] = np.asarray(net.score_value)
    return out


def case_search(case, inputs):
    """search_placement of the case's net for the fleet of every rank
    (`FleetShape(1, world)`, the global batch of the case's batches):
    its winner fed to set_mesh unmodified, then the batches; and each
    of `placements` (JSON) fed likewise. Returns the winner, the
    placement_search events, and each arm's canonical params and
    score."""
    import torch.distributed as dist

    from deeplearning4j_tpu_torch.reshard import (
        FleetShape,
        Objective,
        Placement,
        search_placement,
    )
    from deeplearning4j_tpu_torch.reshard.search import emit_search_event

    batches = _batches(inputs)
    out = {}
    net = _net(case, inputs)
    B = int(np.asarray(inputs["x0"]).shape[0])

    def search():
        res = search_placement(net, FleetShape(1, dist.get_world_size()),
                               objective=Objective(global_batch=B))
        emit_search_event(res, path="test", search_ms=0.0)
        return res

    result, events = _recorded(search)
    out["winner"] = np.asarray(result.winner.describe())
    out["search_events"] = np.asarray(len(
        [e for e in events if e.get("event") == "placement_search"]))
    arms = [("winner", result.winner)] + [
        (f"p{i}", Placement.from_json(pl))
        for i, pl in enumerate(case.get("placements", []))]
    for name, placement in arms:
        arm = net if name == "winner" else _net(case, inputs)
        arm.set_mesh(placement)
        out[f"{name}/split"] = np.asarray(
            0 if arm._split_plan is None else len(arm._split_plan.leaves))
        out[f"{name}/pipe"] = np.asarray(
            0 if arm._pipe is None else arm._pipe.S)
        for ds in batches:
            arm.fit(ds)
        out.update({f"{name}/params/{k}": v
                    for k, v in flatten(params_to_numpy(arm)).items()})
        out[f"{name}/score"] = np.asarray(arm.score_value)
    return out


def case_serve(case, inputs):
    """GenerationEngine over the LM split over the case's "model" ranks,
    in lockstep, once over each of the case's cache dtypes: rank 0
    serves the prompts greedily, all submitted at once over 2 slots; a
    follower's generate raises NotLeaderError. Every rank returns the
    plans its worker stepped and whether it retired at the end."""
    from deeplearning4j_tpu_torch.serving import (BucketLattice,
                                                  GenerationEngine)
    from deeplearning4j_tpu_torch.serving.engine import NotLeaderError

    net = _net(case, inputs)
    net.set_mesh(make_mesh(case["mesh"], device="cpu"), axes=case["axes"])
    out = {}
    for kv in case["kv_dtypes"]:
        engine = GenerationEngine(net, BucketLattice(
            (1,), seq_lens=tuple(case["seq_lens"])), slots=2,
            max_new_tokens=case["new"], kv_dtype=kv)
        engine.warmup()
        engine.start()
        if engine.leader:
            reqs = [engine.submit_generate(np.asarray(p), case["new"])
                    for p in case["prompts"]]
            for i, r in enumerate(reqs):
                if not r.wait(120) or r.error is not None:
                    raise RuntimeError(f"{kv} request {i}: {r.error}")
                out[f"{kv}/tokens{i}"] = np.asarray(r.emitted)
        else:
            try:
                engine.generate(np.asarray(case["prompts"][0]), 1)
                out[f"{kv}/refused"] = np.asarray(False)
            except NotLeaderError:
                out[f"{kv}/refused"] = np.asarray(True)
        engine.drain(timeout=120)
        (worker,) = engine.fleet_workers()
        out[f"{kv}/plans"] = np.asarray(worker.plans)
        out[f"{kv}/retired"] = np.asarray(worker.lifecycle == "retired")
    return out


def _fails_at(n, step):
    """`step`, raising on its n-th call before it runs."""
    calls = [0]

    def wrapped(*args):
        calls[0] += 1
        if calls[0] == n:
            raise RuntimeError("injected step failure")
        return step(*args)
    return wrapped


def case_serve_fault(case, inputs):
    """case_serve's lockstep engine over a "model" group of its own whose
    collectives time out after the case's `timeout_s`, once for each
    rank as the one whose step raises before any collective of the step:
    rank 0's second prefill chunk after warmup, another rank's second
    decode step. Every rank returns, for each failing rank, its worker's
    lifecycle and whether its thread ended; rank 0 which of its requests
    finished with an error."""
    from datetime import timedelta

    import torch.distributed as dist

    from deeplearning4j_tpu_torch.parallel.mesh import Mesh
    from deeplearning4j_tpu_torch.serving import (BucketLattice,
                                                  GenerationEngine)

    world, rank = dist.get_world_size(), dist.get_rank()
    out = {}
    for bad in range(world):
        dist.barrier()  # the short timeout binds the group's setup too
        group = dist.new_group(list(range(world)), timeout=timedelta(
            seconds=case["timeout_s"]))
        mesh = Mesh({"model": world}, bootstrap.process_device(),
                    {"model": group}, {"model": rank}, rank)
        net = _net(case, inputs)
        net.set_mesh(mesh, axes=case["axes"])
        engine = GenerationEngine(net, BucketLattice(
            (1,), seq_lens=tuple(case["seq_lens"])), slots=2,
            max_new_tokens=case["new"])
        dist.barrier(group=group)
        engine.warmup()
        (worker,) = engine.fleet_workers()
        if rank == bad:
            step = "_prefill" if bad == 0 else "_decode"
            setattr(worker, step, _fails_at(2, getattr(worker, step)))
        engine.start()
        if engine.leader:
            reqs = [engine.submit_generate(np.asarray(p), case["new"])
                    for p in case["prompts"]]
            out[f"{bad}/failed"] = np.asarray(
                [r.wait(120) and r.error is not None for r in reqs])
        engine.drain(timeout=120)
        worker.join(120)
        out[f"{bad}/state"] = np.asarray(worker.lifecycle)
        out[f"{bad}/ended"] = np.asarray(not worker._thread.is_alive())
    return out


def bootstrap_rank():
    import torch.distributed as dist

    return dist.get_rank()


CASES = {"dp": case_dp, "pa": case_pa, "eval": case_eval,
         "ring": case_ring, "sp": case_sp, "mesh": case_mesh,
         "solver": case_solver,
         "before_init": case_before_init, "pipe": case_pipe,
         "reshard": case_reshard, "search": case_search,
         "serve": case_serve, "serve_fault": case_serve_fault}


def main(argv) -> int:
    spec = json.loads(Path(argv[0]).read_text())
    root = Path(spec["dir"])
    torch.set_num_threads(1)
    info = bootstrap.initialize(device="cpu", connect_timeout=30.0)
    rank = info["process_id"]
    out = {}
    try:
        for case in spec["cases"]:
            inputs = np.load(root / f"{case['name']}.npz")
            res = CASES[case["kind"]](case, inputs)
            out.update({f"{case['name']}/{k}": v for k, v in res.items()})
            print(f"case {case['name']} done", flush=True)
    finally:
        bootstrap.shutdown()
    np.savez(root / f"out_rank{rank}.npz", **out)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
