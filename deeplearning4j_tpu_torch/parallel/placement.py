"""`net.set_mesh(mesh, axes={...})` for the network containers (JAX
counterpart deeplearning4j_tpu/parallel/placement.py).

Roles map to mesh axis names:

    net.set_mesh(mesh)                                     # DP on "data"
    net.set_mesh(mesh, axes={"data": "data"})              # DP
    net.set_mesh(mesh, axes={"seq": "seq"})                # SP
    net.set_mesh(mesh, axes={"data": "data", "seq": "seq"})  # DP x SP
    net.set_mesh(mesh, axes={"data": "data", "model": "model"})  # DP x TP
    net.set_mesh(mesh, axes={"data": "data", "expert": "expert"})  # DP x EP
    net.set_mesh(mesh, zero1=True)                         # DP, ZeRO-1
    net.set_mesh(mesh, overlap=True | bucket_bytes | BucketPlan)

- "data": each rank steps on its contiguous rows of the global batch
  (`data/sharding.process_slice`, rank r holding the rows JAX device r
  holds) and the gradients are mean-reduced over the axis: one
  all-reduce after the backward (monolithic: the one-device result on
  the global batch) or per bucket during it (`overlap`, the per-shard
  step, parallel/overlap.py).
- "seq": time shards over the axis — ring attention and offset
  positional encodings (parallel/sequence_parallel.py). Needs a conf
  built with seq_parallel_axis; composes with "data".
- "model": Megatron tensor parallelism by the placement rules
  (tensor_parallel.TRANSFORMER_TP_RULES, or `tp_rules` first): each
  rank keeps its slice of the split params and the split layers run
  their collectives over the axis (parallel/tensor_parallel.py).
- "expert": the MoE layers' experts split over the axis
  (tensor_parallel.MOE_EP_RULES; parallel/expert_parallel.py).
  "model" and "expert" compose with "data" and with each other: the
  gradients are mean-reduced over the data axis only.
- `zero1=True`: the optimizer state split over "data" (ZeRO-1,
  nn/training.Zero1); composes with "data" only.

A placed net hands back canonical params — whole leaves in the JAX
layout — through `canonical_params` / `canonical_opt_state` (and so
`params_flat`, checkpoints and `weights_io.params_to_numpy`), and
`set_mesh(None)` or a new `set_mesh` puts them back whole first. The
"pipe" role and `n_microbatches`, "seq" with "model" or "expert", and a
`reshard.Placement` raise NotImplementedError: they wait for the rest
of ROADMAP Queue A item 7. `set_mesh(None)` clears the mesh and returns
the net.
"""

from __future__ import annotations

import numpy as np

from deeplearning4j_tpu_torch.parallel.mesh import Mesh, local_slice

ROLES = ("data", "model", "pipe", "expert", "seq")
_PORTED_ROLES = ("data", "seq", "model", "expert")


def not_ported(what: str):
    raise NotImplementedError(
        f"{what} is not ported yet: it waits for the rest of ROADMAP "
        "Queue A item 7 (A7, parallel and distributed)")


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
    if "model" in axes:
        not_ported("the 'seq' axis with the 'model' role (ring attention "
                   "over tensor-parallel heads)")
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


def leave_placement(net):
    """Put a placed net's params and optimizer state back whole (the
    canonical layout) and end its layers' splits; a no-op for a net
    without one. Every rank of the old mesh calls it."""
    split = getattr(net, "_split_plan", None)
    zero1 = getattr(net, "_zero1", None)
    if split is None and zero1 is None:
        return
    if net.opt_state is not None:
        net.opt_state = canonical_opt_state(net)
    if split is not None:
        net.params = split.whole(net.params)
        split.unregister()
    net._split_plan = None
    net._zero1 = None
    net.tx.split_groups = {}


def canonical_params(net):
    """The net's params whole, in the JAX layout: gathered over the
    mesh where a placement split them (every rank calls it), else the
    params themselves."""
    split = getattr(net, "_split_plan", None)
    return net.params if split is None else split.whole(net.params)


def canonical_opt_state(net):
    """The net's optimizer state whole (ZeRO-1's rows and split leaves'
    moments gathered), as a meshless net of the same params holds it."""
    state = net.opt_state
    zero1 = getattr(net, "_zero1", None)
    if zero1 is not None:
        state = zero1.whole_state(state)
    split = getattr(net, "_split_plan", None)
    if split is not None:
        state = split.whole_state(state)
    return state


def configure_mesh(net, mesh, *, zero1=False, axes=None,
                   n_microbatches=None, tp_rules=None, overlap=None):
    """The body of MultiLayerNetwork/ComputationGraph.set_mesh.
    Validates before it changes anything; then a placed net is put back
    whole (`leave_placement`), its params, layer state and optimizer
    state are made rank 0's on every rank (`replicate`), the "model" /
    "expert" placement and ZeRO-1 cut them to this rank's shares, and
    the next step is built for the mesh. A split that cannot run
    (experts that do not divide) raises after the old placement ended:
    the net is then left without a mesh."""
    from deeplearning4j_tpu_torch.nn.training import Zero1
    from deeplearning4j_tpu_torch.parallel.mesh import replicate
    from deeplearning4j_tpu_torch.parallel.tensor_parallel import (
        SplitPlan,
        resolve_rules,
    )

    if mesh is not None and not isinstance(mesh, Mesh):
        if hasattr(mesh, "mesh_axes") and hasattr(mesh, "roles"):
            not_ported("a reshard.Placement (automatic placement search)")
        raise TypeError(f"set_mesh takes a parallel.mesh.Mesh or None, got "
                        f"{type(mesh).__name__}")
    if n_microbatches is not None:
        not_ported("n_microbatches (pipeline parallelism)")
    later = sorted(set(axes or ()) & (set(ROLES) - set(_PORTED_ROLES)))
    if later:
        not_ported(f"the mesh role(s) {later} (pipeline parallelism)")
    plan = (None if overlap is None
            else _check_overlap(net, mesh, axes, overlap))
    if mesh is not None and axes is not None:
        _check_roles(net, mesh, axes)
    data_ax = (_check_zero1(mesh, axes) if zero1 and mesh is not None
               else None)
    if mesh is not None and mesh.device.type != net.device.type:
        raise ValueError(f"the net lives on {net.device} but this rank's "
                         f"mesh device is {mesh.device}")
    leave_placement(net)
    net._mesh = None
    net._mesh_axes = None
    net._overlap_plan = None
    net._train_step = None
    if mesh is None:
        return net
    net.device = mesh.device
    if net.params is None:
        net.init()
    for t in (net.params, net.state, net.opt_state):
        replicate(t, mesh)
    split = None
    if set(axes or ()) & {"model", "expert"}:
        split = SplitPlan(net, mesh, resolve_rules(axes, tp_rules))
    z1 = Zero1(net.params, mesh, data_ax) if data_ax else None
    net._mesh = mesh
    net._mesh_axes = dict(axes) if axes else None
    net._overlap_plan = plan
    if split is not None:
        net.params = split.local(net.params)
        net.opt_state = split.local_state(net.opt_state)
        split.register()
        net._split_plan = split
    if z1 is not None:
        net.opt_state = z1.local_state(net.opt_state)
        net._zero1 = z1
    net.tx.split_groups = {**(split.groups() if split else {}),
                           **(z1.groups() if z1 else {})}
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
    a = np.asarray(a)
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
    return shard_dataset(
        ds, mesh, None if process_local else mesh_axis(net, "data"),
        mesh_axis(net, "seq"))


def shard_dataset(ds, mesh, data_axis=None, seq_axis=None, n_rows=None):
    """This rank's rows of `ds` along `data_axis` (of its first `n_rows`
    rows, all by default: the rest are dropped) and its time block along
    `seq_axis`; an axis of None is left whole."""
    from deeplearning4j_tpu_torch.datasets.api import DataSet, MultiDataSet

    multi = isinstance(ds, MultiDataSet)
    feats = list(ds.features) if multi else [ds.features]
    labs = list(ds.labels) if multi else [ds.labels]
    fm = (list(ds.features_masks) if multi and ds.features_masks
          else [ds.features_mask] if not multi else None)
    lm = (list(ds.labels_masks) if multi and ds.labels_masks
          else [ds.labels_mask] if not multi else None)
    if data_axis is not None:
        if n_rows is None:
            n_rows = np.asarray(feats[0]).shape[0]
        sl = local_slice(n_rows, mesh, data_axis)
        feats, labs = [_rows(a, sl) for a in feats], [_rows(a, sl)
                                                      for a in labs]
        fm = None if fm is None else [_rows(a, sl) for a in fm]
        lm = None if lm is None else [_rows(a, sl) for a in lm]
    if seq_axis is not None:
        if any(m is not None for m in (fm or []) + (lm or [])):
            raise ValueError("masks are not supported under sequence "
                             "parallelism — pad to full length")
        sl = local_slice(np.asarray(feats[0]).shape[1], mesh, seq_axis)
        feats = [_rows(a, sl, 1) for a in feats]
        labs = [_rows(a, sl, 1) for a in labs]
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
