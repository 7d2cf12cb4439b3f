"""`net.set_mesh(mesh, axes={...})` for the network containers (JAX
counterpart deeplearning4j_tpu/parallel/placement.py).

Roles map to mesh axis names:

    net.set_mesh(mesh)                                     # DP on "data"
    net.set_mesh(mesh, axes={"data": "data"})              # DP
    net.set_mesh(mesh, axes={"seq": "seq"})                # SP
    net.set_mesh(mesh, axes={"data": "data", "seq": "seq"})  # DP x SP
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

The roles "model", "expert" and "pipe", ZeRO-1 and a
`reshard.Placement` raise NotImplementedError: they wait for the rest of
ROADMAP Queue A item 7. `set_mesh(None)` clears the mesh and returns the
net.
"""

from __future__ import annotations

import numpy as np

from deeplearning4j_tpu_torch.parallel.mesh import Mesh, local_slice

ROLES = ("data", "model", "pipe", "expert", "seq")
_PORTED_ROLES = ("data", "seq")


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


def configure_mesh(net, mesh, *, zero1=False, axes=None,
                   n_microbatches=None, tp_rules=None, overlap=None):
    """The body of MultiLayerNetwork/ComputationGraph.set_mesh.
    Validates before it changes anything; on success the net's params,
    layer state and optimizer state are made rank 0's on every rank
    (`replicate`), and the next step is built for the mesh."""
    from deeplearning4j_tpu_torch.parallel.mesh import replicate

    if mesh is not None and not isinstance(mesh, Mesh):
        if hasattr(mesh, "mesh_axes") and hasattr(mesh, "roles"):
            not_ported("a reshard.Placement (automatic placement search)")
        raise TypeError(f"set_mesh takes a parallel.mesh.Mesh or None, got "
                        f"{type(mesh).__name__}")
    if zero1:
        not_ported("ZeRO-1 (zero1=True; gloo has no reduce-scatter)")
    if n_microbatches is not None or tp_rules is not None:
        not_ported("n_microbatches / tp_rules (pipeline and tensor "
                   "parallelism)")
    later = sorted(set(axes or ()) & (set(ROLES) - set(_PORTED_ROLES)))
    if later:
        not_ported(f"the mesh role(s) {later} (tensor, expert and "
                   "pipeline parallelism)")
    plan = (None if overlap is None
            else _check_overlap(net, mesh, axes, overlap))
    if mesh is not None and axes is not None:
        _check_roles(net, mesh, axes)
    if mesh is not None and mesh.device.type != net.device.type:
        raise ValueError(f"the net lives on {net.device} but this rank's "
                         f"mesh device is {mesh.device}")
    net._mesh = mesh
    net._mesh_axes = dict(axes) if axes else None
    net._overlap_plan = plan
    net._train_step = None
    if mesh is None:
        return net
    net.device = mesh.device
    if net.params is None:
        net.init()
    for t in (net.params, net.state, net.opt_state):
        replicate(t, mesh)
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
