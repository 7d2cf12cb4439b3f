"""`net.set_mesh(mesh, axes={...})` for the network containers (JAX
counterpart deeplearning4j_tpu/parallel/placement.py).

Roles map to mesh axis names:

    net.set_mesh(mesh)                                     # DP on "data"
    net.set_mesh(mesh, axes={"data": "data"})              # DP
    net.set_mesh(mesh, axes={"seq": "seq"})                # SP
    net.set_mesh(mesh, axes={"data": "data", "seq": "seq"})  # DP x SP
    net.set_mesh(mesh, axes={"data": "data", "model": "model"})  # DP x TP
    net.set_mesh(mesh, axes={"data": "data", "expert": "expert"})  # DP x EP
    net.set_mesh(mesh, axes={"data": "data", "model": "model",
                             "pipe": "pipe"}, n_microbatches=8)  # x PP
    net.set_mesh(mesh, zero1=True)                         # DP, ZeRO-1
    net.set_mesh(mesh, overlap=True | bucket_bytes | BucketPlan)
    net.set_mesh(search_placement(net, fleet).winner)      # a Placement

- "data": each rank steps on its contiguous rows of the global batch
  (`data/sharding.process_slice`, rank r holding the rows JAX device r
  holds) and the gradients are mean-reduced over the axis: one
  all-reduce after the backward (monolithic: the one-device result on
  the global batch) or per bucket during it (`overlap`, the per-shard
  step, parallel/overlap.py).
- "seq": time shards over the axis — ring attention and offset
  positional encodings (parallel/sequence_parallel.py). Needs a conf
  built with seq_parallel_axis; composes with "data", with "model" (the
  ring over each rank's heads) and with "pipe" (the ring inside the
  stages; parallel/pipeline.py), not with "expert" (as in the JAX
  package).
- "model": Megatron tensor parallelism by the placement rules
  (tensor_parallel.TRANSFORMER_TP_RULES, or `tp_rules` first): each
  rank keeps its slice of the split params and the split layers run
  their collectives over the axis (parallel/tensor_parallel.py).
- "expert": the MoE layers' experts split over the axis
  (tensor_parallel.MOE_EP_RULES; parallel/expert_parallel.py).
  "model" and "expert" compose with "data" and with each other: the
  gradients are mean-reduced over the data axis only.
- "pipe": the graph's layer stack cut into stages, one a rank, trained
  by the GPipe step over `n_microbatches` (2·S by default;
  parallel/pipeline.py). Composes with "data", "model" and "expert".
- `zero1=True`: the optimizer state split over "data" (ZeRO-1,
  nn/training.Zero1); composes with "data" only.
- a `reshard.Placement` (`search_placement(...).winner`): the mesh over
  every rank of the process group is built from its axes, the roles and
  zero1 from its own.

A placed net hands back canonical params — whole leaves in the JAX
layout — through `canonical_params` / `canonical_opt_state` (and so
`params_flat`, checkpoints and `weights_io.params_to_numpy`). Placing a
net moves its params and optimizer state from where they are to where
the new placement keeps them (reshard/executor.py): an unplaced net
cuts its own shares; a placed one goes through `reshard_net_live`, with
the plan on the record; `set_mesh(None)` puts them back whole.
"""

from __future__ import annotations

import numpy as np

from deeplearning4j_tpu_torch.parallel.mesh import Mesh, local_slice

ROLES = ("data", "model", "pipe", "expert", "seq")


def _iter_layer_confs(net):
    if hasattr(net, "layer_vertices"):
        return [v.layer for v in net.layer_vertices.values()]
    return list(net.layer_confs)


def _layer_order(net):
    return (list(net.layer_vertices) if hasattr(net, "layer_vertices")
            else list(net.layer_names))


def _check_overlap(net, mesh, axes, overlap):
    """Validate and build the bucket plan of set_mesh(overlap=...):
    pure DP only, no TBPTT (the overlap step does not thread carries),
    the plan derived from the params in the net's layer order. Emits a
    `bucket_plan` telemetry event."""
    from deeplearning4j_tpu_torch.nn.training import is_tbptt
    from deeplearning4j_tpu_torch.parallel.overlap import (
        DEFAULT_BUCKET_BYTES,
        BucketPlan,
        plan_buckets,
    )
    from deeplearning4j_tpu_torch.telemetry import get_default

    if mesh is None:
        raise ValueError("overlap=... requires a mesh")
    roles = set(axes) if axes else {"data"}
    if roles - {"data"}:
        raise ValueError(
            f"overlap composes with the 'data' role only (got "
            f"{sorted(roles)}); model/expert/pipe/seq placement keeps "
            "the monolithic or manual steps")
    data_ax = (axes or {}).get("data", "data")
    if data_ax not in mesh.axis_names:
        raise ValueError(
            f"overlap needs the data axis {data_ax!r} on the mesh "
            f"(mesh has {mesh.axis_names})")
    if is_tbptt(net.conf):
        raise ValueError(
            "overlap does not support TRUNCATED_BPTT (the bucketed step "
            "does not thread carries) — drop overlap or the TBPTT config")
    if net.params is None:
        net.init()
    if isinstance(overlap, BucketPlan):
        plan = overlap
    else:
        plan = plan_buckets(
            net.params,
            DEFAULT_BUCKET_BYTES if overlap is True else int(overlap),
            layer_order=_layer_order(net))
    get_default().event("bucket_plan", axis=data_ax, **plan.summary())
    return plan


def _check_roles(net, mesh, axes):
    bad = set(axes) - set(ROLES)
    if bad:
        raise ValueError(f"unknown mesh roles {sorted(bad)}; valid: {ROLES}")
    for role, ax in axes.items():
        if ax not in mesh.axis_names:
            raise ValueError(
                f"axes[{role!r}]={ax!r} is not a mesh axis "
                f"(mesh has {mesh.axis_names})")
    if "seq" not in axes:
        return
    if "expert" in axes:
        raise ValueError(
            "the 'seq' axis composes with 'data', 'model' and 'pipe' "
            "(time-sharded ring attention runs manual inside the SP step; "
            "'expert' needs a different schedule)")
    if not hasattr(net, "layer_vertices"):
        raise ValueError(
            "the 'seq' axis requires the ComputationGraph container "
            "(only its train step routes through the sequence-parallel "
            "step); build the model via .graph_builder()")
    if (len(net.conf.network_inputs) != 1
            or len(net.conf.network_outputs) != 1):
        raise ValueError(
            "the 'seq' axis supports single-input single-output graphs "
            "(the SP step shards one token/label pair over time)")
    sp_layers = [lc for lc in _iter_layer_confs(net)
                 if getattr(lc, "seq_parallel_axis", "")]
    if not sp_layers:
        raise ValueError(
            "axes['seq'] needs a sequence-parallel-ready conf: build the "
            "model with seq_parallel_axis set to the mesh axis name (e.g. "
            f"transformer_lm(seq_parallel_axis={axes['seq']!r}))")
    for lc in sp_layers:
        if lc.seq_parallel_axis != axes["seq"]:
            raise ValueError(
                f"conf layer '{getattr(lc, 'name', '?')}' is built for seq "
                f"axis {lc.seq_parallel_axis!r} but axes['seq'] is "
                f"{axes['seq']!r}")


def _check_zero1(mesh, axes):
    if set(axes or ()) - {"data"}:
        raise ValueError("zero1 currently composes with the 'data' axis "
                         "only — drop it or the model/pipe/expert/seq axes")
    data_ax = (axes or {}).get("data", "data")
    if data_ax not in mesh.shape:
        raise ValueError(f"zero1 needs the data axis {data_ax!r} on the "
                         f"mesh (mesh has {mesh.axis_names})")
    return data_ax


# ------------------------------------------------ canonical views

def _placed(net) -> bool:
    return any(getattr(net, a, None) is not None
               for a in ("_split_plan", "_zero1", "_pipe_mesh"))


def canonical_like(net) -> dict:
    """{leaf path: (shape, dtype)} of the canonical params, without a
    collective (recorded when the net was placed)."""
    from deeplearning4j_tpu_torch.nn import tree

    like = getattr(net, "_canonical_like", None)
    if like is not None:
        return like
    return {p: (tuple(t.shape), t.dtype) for p, t in tree.leaves(net.params)}


def canonical_template(net) -> dict:
    """The canonical params as tensors on the meta device: their shapes
    and dtypes, under a placement too."""
    import torch

    from deeplearning4j_tpu_torch.nn import tree

    if not _placed(net):
        return tree.tree_map(lambda t: torch.empty(
            t.shape, dtype=t.dtype, device="meta"), net.params)
    out = tree.from_leaves((p, torch.empty(s, dtype=d, device="meta"))
                           for p, (s, d) in canonical_like(net).items())
    for layer in _layer_order(net):
        out.setdefault(layer, {})
    return out


def canonical_labels(net) -> dict:
    """{optimizer label: [leaf path]} of the canonical params, in the
    order a meshless net's optimizer state keeps them."""
    return dict(net.tx._groups(canonical_template(net)))


def canonical_opt_template(net):
    """The canonical optimizer state's structure with meta tensors for
    its moments (counts and other entries as the net holds them); None
    without an optimizer state."""
    import torch

    if net.opt_state is None:
        return None
    like = canonical_like(net)
    labels = canonical_labels(net)
    out = {}
    for label, st in net.opt_state.items():
        paths = labels.get(label, [])
        new = {"keys": paths}
        for name, v in st.items():
            if name == "keys":
                continue
            if isinstance(v, list):
                v = [torch.empty(like[p][0], dtype=like[p][1],
                                 device="meta") for p in paths]
            new[name] = v
        out[label] = new
    return out


def current_layout(net, world=None):
    """The `reshard.executor.PortLayout` of the net's placement (every
    leaf whole on every rank for an unplaced net)."""
    from deeplearning4j_tpu_torch.reshard.executor import PortLayout

    mesh = getattr(net, "_mesh", None)
    if not _placed(net):
        return PortLayout(canonical_like(net),
                          mesh.size if mesh is not None else (world or 1))
    return PortLayout(canonical_like(net), mesh.size, mesh,
                      net._split_plan, net._zero1,
                      getattr(net, "_pipe", None) if net._pipe_mesh else None)


def _gather(net, dst, with_opt):
    """(params, opt_state) of layout `dst` from the net's, moved by the
    executor without a record; the net is left as it is."""
    from deeplearning4j_tpu_torch.reshard.executor import NetMoves

    return NetMoves(net, current_layout(net), dst, with_opt).apply(
        net.params, net.opt_state if with_opt else None)


def _whole_layout(net):
    from deeplearning4j_tpu_torch.reshard.executor import PortLayout

    return PortLayout(canonical_like(net), net._mesh.size)


def canonical_params(net):
    """The net's params whole, in the JAX layout: gathered over the
    mesh where a placement split or staged them (every rank calls it),
    else the params themselves. A leaf this rank holds whole is the
    net's own tensor, as a meshless net's are: copy what must outlast
    the next step."""
    if not _placed(net):
        return net.params
    return _gather(net, _whole_layout(net), False)[0]


def canonical_opt_state(net):
    """The net's optimizer state whole (ZeRO-1's rows, split leaves'
    moments and other stages' moments gathered), as a meshless net of
    the same params holds it; a moment this rank holds whole is the
    net's own tensor."""
    if not _placed(net) or net.opt_state is None:
        return net.opt_state
    return _gather(net, _whole_layout(net), True)[1]


def inference_params(net):
    """The params a forward of this rank runs on: a pipelined net's
    other stages gathered (a "model" / "expert" split kept, its layers
    run their collectives), else the params themselves."""
    from deeplearning4j_tpu_torch.reshard.executor import PortLayout

    if getattr(net, "_pipe_mesh", None) is None:
        return net.params
    dst = PortLayout(canonical_like(net), net._mesh.size, net._mesh,
                     net._split_plan, None, None)
    return _gather(net, dst, False)[0]


def num_params(net) -> int:
    """The canonical params' count."""
    import torch

    return sum(int(torch.Size(s).numel())
               for s, _ in canonical_like(net).values())


def set_canonical_params(net, params):
    """Set the net's params from canonical (whole) `params`: each rank
    keeps its share."""
    from deeplearning4j_tpu_torch.reshard.executor import (
        NetMoves,
        PortLayout,
    )

    if not _placed(net):
        net.params = params
        return
    whole = PortLayout(canonical_like(net), net._mesh.size)
    net.params = NetMoves(net, whole, current_layout(net), False).apply(
        params)[0]


def leave_placement(net):
    """Put a placed net's params and optimizer state back whole (the
    canonical layout) and end its layers' splits and its pipeline; a
    no-op for a net without one. Every rank of the old mesh calls it."""
    pipe = getattr(net, "_pipe", None)
    if pipe is not None and getattr(net, "_pipe_mesh", None) is None:
        net._pipe = None  # an in-process pipeline holds whole params
        net.tx.norm_ties = {}
    split = getattr(net, "_inproc_split", None)
    if split is not None:  # an in-process split holds whole params too
        split.unregister()
        net._inproc_split = None
    if not _placed(net):
        return
    params, opt = _gather(net, _whole_layout(net), True)
    net.params = params
    if net.opt_state is not None:
        net.opt_state = opt
    _drop_placement(net)


def _drop_placement(net):
    if net._split_plan is not None:
        net._split_plan.unregister()
    net._split_plan = None
    net._zero1 = None
    net._pipe = None
    net._pipe_mesh = None
    net._canonical_like = None
    net.tx.split_groups = {}
    net.tx.norm_ties = {}


# ------------------------------------------------------------ set_mesh

def _as_mesh(net, mesh, axes, zero1):
    """(Mesh, axes, zero1) from set_mesh's first argument (a Mesh, None
    or a `reshard.Placement`, whose axes build the mesh over every rank
    and whose roles and zero1 apply where the call gives none)."""
    from deeplearning4j_tpu_torch.reshard.planner import Placement

    if mesh is None or isinstance(mesh, Mesh):
        return mesh, axes, zero1
    if isinstance(mesh, Placement):
        from deeplearning4j_tpu_torch.parallel.mesh import make_mesh

        placement = mesh
        mesh = make_mesh(dict(placement.mesh_axes), device=net.device)
        if axes is None:
            axes = {r: a for r, a in placement.roles}
        return mesh, axes, bool(zero1 or placement.zero1)
    raise TypeError(f"set_mesh takes a parallel.mesh.Mesh, a "
                    f"reshard.Placement or None, got {type(mesh).__name__}")


def _check_pipe(net, mesh, axes, n_microbatches, like):
    """The pipeline plan of a "pipe" placement and its microbatch count,
    or (None, None); raises the JAX package's errors."""
    from deeplearning4j_tpu_torch.parallel.pipeline import (
        PipelinePlan,
        check_pp_supported,
    )

    if "pipe" not in (axes or {}):
        return None, None
    if not hasattr(net, "layer_vertices"):
        raise ValueError(
            "the 'pipe' axis requires the ComputationGraph container "
            "(stage partitioning runs on the DAG conf); wrap the "
            "layer stack in a graph via .graph_builder()")
    check_pp_supported(net)
    plan = PipelinePlan(net, mesh.axis_size(axes["pipe"]),
                        params=like)
    M = 2 * plan.S if n_microbatches is None else int(n_microbatches)
    return plan, M


def _split_groups(net, mesh, axes, split, z1, pipe):
    """{leaf path: process group} whose norms sum over it: a split
    leaf's axis, a ZeRO-1 leaf's data axis, a stage leaf's pipe axis
    (with its split axis where it has one). The groups over two axes
    are made here, on every rank in one order."""
    from deeplearning4j_tpu_torch.nn import tree

    groups = {**(split.groups() if split else {}),
              **(z1.groups() if z1 else {})}
    if pipe is None or pipe.S == 1:
        return groups
    pipe_ax = axes["pipe"]
    combos = sorted({ax for ax, _, _ in split.leaves.values()}) if split \
        else []
    made = {ax: mesh.subgroup((pipe_ax, ax)) for ax in combos}
    for path, _ in tree.leaves(net.params):
        if path[0] in pipe.plan.stage_of:
            leaf = split.leaves.get(path) if split else None
            groups[path] = (made[leaf[0]] if leaf
                            else mesh.group(pipe_ax))
    return groups


def configure_mesh(net, mesh, *, zero1=False, axes=None,
                   n_microbatches=None, tp_rules=None, overlap=None):
    """The body of MultiLayerNetwork/ComputationGraph.set_mesh.
    Validates before it changes anything; then an unplaced net's params,
    layer state and optimizer state are made rank 0's on every rank
    (`replicate`), and the params and optimizer state move to where the
    new placement keeps them: an unplaced net cuts its shares, a placed
    one is re-placed by `reshard_net_live` (a `reshard_plan` event and
    a `reshard` span on the record), `set_mesh(None)` gathers them
    whole. The next step is built for the mesh."""
    from deeplearning4j_tpu_torch.nn.training import Zero1
    from deeplearning4j_tpu_torch.parallel.mesh import replicate
    from deeplearning4j_tpu_torch.parallel.pipeline import (
        PipeRuntime,
        ProcessGroupPipe,
    )
    from deeplearning4j_tpu_torch.parallel.tensor_parallel import (
        SplitPlan,
        resolve_rules,
    )
    from deeplearning4j_tpu_torch.reshard import executor as ex

    mesh, axes, zero1 = _as_mesh(net, mesh, axes, zero1)
    if mesh is not None and net.tx is not None:
        from deeplearning4j_tpu_torch.nn.updater import (
            Optimizer,
            OptimizerPlacementError,
        )

        if not isinstance(net.tx, Optimizer):
            raise OptimizerPlacementError(
                "set_mesh places the port's Optimizer state only; this "
                f"net trains with a custom {type(net.tx).__name__} "
                "(set_optimizer): set an Optimizer, or train it meshless")
    plan = (None if overlap is None
            else _check_overlap(net, mesh, axes, overlap))
    if mesh is not None and axes is not None:
        _check_roles(net, mesh, axes)
    data_ax = (_check_zero1(mesh, axes) if zero1 and mesh is not None
               else None)
    if mesh is not None and mesh.device.type != net.device.type:
        raise ValueError(f"the net lives on {net.device} but this rank's "
                         f"mesh device is {mesh.device}")
    if net.params is None:
        net.init()
    like = canonical_template(net)
    pipe_plan, M = (_check_pipe(net, mesh, axes, n_microbatches, like)
                    if mesh is not None else (None, None))
    was_placed = _placed(net)
    if mesh is None or not was_placed:
        leave_placement(net)
    src_layout = current_layout(net, mesh.size if mesh is not None else 1)
    src_pl = ex.net_placement(net)
    net._train_step = None
    net._overlap_plan = None
    if mesh is None:
        net._mesh = None
        net._mesh_axes = None
        return net
    net.device = mesh.device
    if not was_placed:
        for t in (net.params, net.state, net.opt_state):
            replicate(t, mesh)
    like_map = canonical_like(net)
    split = None
    if set(axes or ()) & {"model", "expert"}:
        split = SplitPlan(net, mesh, resolve_rules(axes, tp_rules),
                          params=like)
    z1 = Zero1(like, mesh, data_ax) if data_ax else None
    pipe = None
    if pipe_plan is not None:
        pipe = PipeRuntime(pipe_plan, ProcessGroupPipe(mesh, axes["pipe"]),
                           M, mesh, axes["pipe"], axes.get("data"),
                           axes.get("seq"))
        pipe.shard_group  # made here, on every rank in one order
    dst_layout = ex.PortLayout(like_map, mesh.size, mesh, split, z1, pipe)
    if was_placed:
        old = net._split_plan
        ex.reshard_net_live(
            net, src_layout, dst_layout, src_pl=src_pl,
            dst_pl=ex.mesh_placement(mesh, axes, zero1=bool(data_ax)))
        if old is not None:
            old.unregister()
    else:
        ex.reshard_net_live(net, src_layout, dst_layout)
    net._mesh = mesh
    net._mesh_axes = dict(axes) if axes else None
    net._overlap_plan = plan
    net._canonical_like = like_map
    net._split_plan = split
    net._zero1 = z1
    net._pipe = pipe
    net._pipe_mesh = mesh if pipe is not None else None
    if split is not None:
        split.register()
    net.tx.split_groups = _split_groups(net, mesh, axes, split, z1, pipe)
    net.tx.norm_ties = {}
    if not (split or z1 or pipe):
        net._canonical_like = None
    return net


def mesh_axis(net, role: str):
    """The mesh axis the net's `role` runs on, or None: with no axes
    given, "data" when the mesh has it (set_mesh(mesh) is pure DP)."""
    mesh = getattr(net, "_mesh", None)
    if mesh is None:
        return None
    axes = getattr(net, "_mesh_axes", None)
    if axes is None:
        return "data" if role == "data" and "data" in mesh.shape else None
    return axes.get(role)


def _rows(a, sl, dim=0):
    if a is None:
        return None
    a = np.asarray(a)  # graftlint: disable=G002 — host arrays
    if a.ndim <= dim:
        return a
    idx = [slice(None)] * a.ndim
    idx[dim] = sl
    return a[tuple(idx)]


def local_dataset(net, ds, process_local: bool = False):
    """This rank's part of a global DataSet / MultiDataSet under the
    net's mesh: its rows along the data axis (unless the batch is
    `process_local` already, as `ShardedDataSetIterator`'s are) and its
    time block along the seq axis. The DataSet itself without a mesh."""
    mesh = getattr(net, "_mesh", None)
    if mesh is None:
        return ds
    pipe, data_ax = getattr(net, "_pipe", None), mesh_axis(net, "data")
    seq_ax = mesh_axis(net, "seq")
    if pipe is not None and seq_ax is not None:
        from deeplearning4j_tpu_torch.datasets.api import MultiDataSet

        T = np.asarray(ds.features[0] if isinstance(ds, MultiDataSet)  # graftlint: disable=G002 — host arrays
                       else ds.features).shape[1]
        if T % mesh.axis_size(seq_ax):
            raise ValueError(
                f"sequence length {T} not divisible over the "
                f"{mesh.axis_size(seq_ax)}-way seq axis")
    if pipe is not None and data_ax is not None and not process_local:
        # the pipelined step's rows: this shard's part of every
        # microbatch (pipeline.microbatch_rows)
        from deeplearning4j_tpu_torch.parallel.pipeline import (
            microbatch_rows,
        )

        from deeplearning4j_tpu_torch.datasets.api import MultiDataSet

        B = np.asarray(ds.features[0] if isinstance(ds, MultiDataSet)  # graftlint: disable=G002 — host arrays
                       else ds.features).shape[0]
        rows = microbatch_rows(B, pipe.n_microbatches,
                               mesh.axis_size(data_ax),
                               mesh.axis_index(data_ax))
        return shard_dataset(ds, mesh, None, seq_ax, rows=rows,
                             masks_ok=True)
    return shard_dataset(
        ds, mesh, None if process_local else data_ax, seq_ax,
        masks_ok=pipe is not None)


def shard_dataset(ds, mesh, data_axis=None, seq_axis=None, n_rows=None,
                  rows=None, masks_ok=False):
    """This rank's rows of `ds` along `data_axis` (of its first `n_rows`
    rows, all by default: the rest are dropped) and its time block along
    `seq_axis`; an axis of None is left whole. `rows`: the row indices
    to keep instead. Masks are cut along time too where `masks_ok` (the
    pipelined step takes them); else a mask under `seq_axis` raises."""
    from deeplearning4j_tpu_torch.datasets.api import DataSet, MultiDataSet

    multi = isinstance(ds, MultiDataSet)
    feats = list(ds.features) if multi else [ds.features]
    labs = list(ds.labels) if multi else [ds.labels]
    fm = (list(ds.features_masks) if multi and ds.features_masks
          else [ds.features_mask] if not multi else None)
    lm = (list(ds.labels_masks) if multi and ds.labels_masks
          else [ds.labels_mask] if not multi else None)
    if data_axis is not None or rows is not None:
        if n_rows is None:
            n_rows = np.asarray(feats[0]).shape[0]  # graftlint: disable=G002 — host arrays
        sl = rows if rows is not None else local_slice(n_rows, mesh,
                                                       data_axis)
        feats, labs = [_rows(a, sl) for a in feats], [_rows(a, sl)
                                                      for a in labs]
        fm = None if fm is None else [_rows(a, sl) for a in fm]
        lm = None if lm is None else [_rows(a, sl) for a in lm]
    if seq_axis is not None:
        if not masks_ok and any(m is not None
                                for m in (fm or []) + (lm or [])):
            raise ValueError("masks are not supported under sequence "
                             "parallelism — pad to full length")
        sl = local_slice(np.asarray(feats[0]).shape[1], mesh, seq_axis)  # graftlint: disable=G002 — host arrays
        feats = [_rows(a, sl, 1) for a in feats]
        labs = [_rows(a, sl, 1) for a in labs]
        fm = None if fm is None else [_rows(a, sl, 1) for a in fm]
        lm = None if lm is None else [_rows(a, sl, 1) for a in lm]
    if multi:
        return MultiDataSet(feats, labs, fm, lm)
    return DataSet(feats[0], labs[0], None if fm is None else fm[0],
                   None if lm is None else lm[0])


def sharded_forward(net, inputs, forward):
    """`forward(*inputs)` -> a list of [batch, ...] outputs, run on this
    rank's rows of `inputs` along the net's data axis and all-gathered,
    the batch padded to a multiple of the axis and sliced back (the JAX
    package's data-sharded `output`; reference EvaluateFlatMapFunction).
    Without a data axis: `forward(*inputs)`."""
    import torch
    import torch.distributed as dist

    mesh, ax = getattr(net, "_mesh", None), mesh_axis(net, "data")
    if ax is None or mesh.axis_size(ax) == 1:
        return forward(*inputs)
    n = mesh.axis_size(ax)
    arrs = [np.asarray(x.cpu() if isinstance(x, torch.Tensor) else x)
            for x in inputs]
    B = arrs[0].shape[0]
    pad = (-B) % n
    if pad:
        arrs = [np.concatenate([a, np.zeros((pad,) + a.shape[1:], a.dtype)])
                for a in arrs]
    sl = local_slice(B + pad, mesh, ax)
    ys = forward(*[a[sl] for a in arrs])
    out = []
    for y in ys:
        parts = [torch.empty_like(y) for _ in range(n)]
        dist.all_gather(parts, y.contiguous(), group=mesh.group(ax))
        out.append(torch.cat(parts)[:B])
    return out
