"""Resharding executors of the port (JAX counterpart
deeplearning4j_tpu/reshard/executor.py): how a net's canonical leaves
move between placements when each device is a process.

`plan_for_placements` and `plan_net_reshard` give the reference's plan:
the same spec trees (`param_spec_tree`, `opt_spec_tree`) and leaf
layouts, asked of the same pure planner. Its cost model is the
reference's device-level one, which credits a slice as resident where
any replica of it sits in the source mesh; the tests hold it to the JAX
plans.

What runs is decided by the port's own layouts (`PortLayout`): which
rank holds which part of each canonical leaf under a placement — a
"model" / "expert" split along one dim (a packed QKV projection by
heads: q, k and v columns of a shard's heads,
`tensor_parallel.qkv_columns`), ZeRO-1's rows of an optimizer moment, a
pipeline stage's layers on the ranks of that stage only, whole
everywhere else. From two layouts a `MovePlan` decides, once and the
same on every rank, each leaf's action (keep, slice_exchange,
allgather_shard, or host_fallback for a read from a checkpoint) and its
pieces: the part each rank needs and the rank it takes it from (itself
where it can). Its `plan()` is that move as a `planner.ReshardPlan`
with the port's bytes, and `execute_moves` runs exactly its pieces, so
the bytes moved are the plan's.

- **live path** (`reshard_net_live`, used by `set_mesh`): pieces
  between ranks go by point-to-point calls of the process group
  (`batch_isend_irecv`: NCCL on CUDA, gloo on the CPU); a leaf the plan
  keeps is not touched. `reshard_in_process` runs the same plan among
  the ranks of a mesh one process holds (what one card runs), each
  piece a copy on the device.
- **checkpoint path** (`checkpoint_template`, `restore_placed`, used by
  `util/checkpoint.Checkpointer.restore` into a placed net): the
  checkpoint holds the canonical trees, memory-mapped, and each rank
  copies out only the parts its layout holds.

Both put the plan on the record before moving a byte (`run_plan`): a
`reshard_plan` event with its summary, then a `reshard` span with the
plan's bytes (`bytes_planned`, `bytes_lower_bound`) and those that
moved (`bytes_moved`, summed over the ranks).
"""

from __future__ import annotations

import re
from typing import Optional

import torch

from deeplearning4j_tpu_torch import resolve_device
from deeplearning4j_tpu_torch.nn import tree
from deeplearning4j_tpu_torch.reshard.planner import (
    ALLGATHER_SHARD,
    HOST_FALLBACK,
    KEEP,
    SLICE_EXCHANGE,
    LeafLayout,
    LeafPlan,
    Placement,
    ReshardPlan,
    plan_reshard,
)

# the holder of a piece read from the host (a checkpoint's trees)
HOST = -1


# ------------------------------------------------------------ placements

def mesh_placement(mesh, axes=None, *, zero1: bool = False) -> Placement:
    """A `planner.Placement` for a live Mesh and role map (`axes` as
    set_mesh takes it; None: the data role on a 'data' axis when the
    mesh has one). Each rank is a process."""
    mesh_axes = {str(a): int(s) for a, s in mesh.shape.items()}
    if axes is None:
        axes = {"data": "data"} if "data" in mesh_axes else {}
    return Placement.of(mesh_axes, dict(axes), process_count=mesh.size,
                        zero1=zero1)


def net_placement(net) -> Placement:
    """The placement a network container trains under;
    `Placement.solo()` for an unplaced net."""
    mesh = getattr(net, "_mesh", None)
    if mesh is None:
        return Placement.solo()
    return mesh_placement(mesh, getattr(net, "_mesh_axes", None),
                          zero1=getattr(net, "_zero1", None) is not None)


# ------------------------------------------------------------ spec trees

def _rule_spec(name: str, placement: Placement, rules) -> tuple:
    """The spec one param name resolves to under the placement's mesh —
    the pure twin of `tensor_parallel.spec_for` (whole when no rule
    matches or a named axis is absent or of size 1)."""
    sizes = placement.axis_sizes
    for pat, spec in rules or ():
        if re.match(pat, name):
            entries = tuple(spec)
            if all(not isinstance(ax, str)
                   or (ax in sizes and sizes[ax] > 1)
                   for ax in entries):
                return tuple(ax if isinstance(ax, str) else None
                             for ax in entries)
            break
    return ()


def param_spec_tree(params, placement: Placement, rules):
    """The param nest with a spec tuple at every leaf."""
    def walk(t, prefix=""):
        out = {}
        for k, v in t.items():
            name = f"{prefix}{k}"
            out[k] = (walk(v, name + "/") if isinstance(v, dict)
                      else _rule_spec(name, placement, rules))
        return out

    return walk(params)


def opt_spec_tree(opt_state, pspecs, placement: Placement, like):
    """{label: {moment: [spec a key]}} for an optimizer state: moments
    follow their params' specs, or under zero1 split their leading dim
    over the data axis where it divides (nn/training.zero1_opt_shardings);
    counts have none."""
    if opt_state is None:
        return None
    data_ax = placement.axis_for("data")
    n = placement.axis_sizes.get(data_ax, 1) if data_ax else 1
    out = {}
    for label, st in opt_state.items():
        keys = [tuple(k) for k in st["keys"]]
        specs = []
        for k in keys:
            shape = like[k][0]
            if placement.zero1 and n > 1:
                specs.append((data_ax,) + (None,) * (len(shape) - 1)
                             if len(shape) >= 1 and shape[0] >= n
                             and shape[0] % n == 0 else ())
            else:
                specs.append(tree.get(pspecs, k))
        out[label] = {name: specs for name, v in st.items()
                      if name != "keys" and _per_leaf(v, keys)}
    return out


def _per_leaf(v, keys):
    return (isinstance(v, list) and len(v) == len(keys)
            and all(isinstance(t, torch.Tensor) for t in v))


def _keystr(path) -> str:
    return "".join(f"[{k!r}]" for k in path)


def build_layouts(params, p_src, p_dst, opt_state=None, o_src=None,
                  o_dst=None):
    """[LeafLayout] of the params (named `params['layer']['W']`, as the
    JAX package names them) and the optimizer moments."""
    out = []
    for path, t in tree.leaves(params):
        out.append(LeafLayout(
            name="params" + _keystr(path), shape=tuple(t.shape),
            itemsize=t.element_size(), src_spec=tree.get(p_src, path),
            dst_spec=tree.get(p_dst, path)))
    for label, st in (opt_state or {}).items():
        keys = [tuple(k) for k in st["keys"]]
        for name in sorted(o_src.get(label, {})):
            for i, k in enumerate(keys):
                t = st[name][i]
                out.append(LeafLayout(
                    name=f"opt_state{_keystr((label, name))}{_keystr(k)}",
                    shape=tuple(t.shape), itemsize=t.element_size(),
                    src_spec=o_src[label][name][i],
                    dst_spec=o_dst[label][name][i]))
    return out


def plan_for_placements(params, src_pl: Placement, dst_pl: Placement, *,
                        opt_state=None, tp_rules=None):
    """The pure planning half: (plan, dst param spec tree) for moving
    canonical `params` (and `opt_state`) between two placements."""
    from deeplearning4j_tpu_torch.parallel.tensor_parallel import (
        resolve_rules,
    )

    src_roles, dst_roles = dict(src_pl.roles), dict(dst_pl.roles)
    src_rules = resolve_rules(src_roles, tp_rules) if src_roles else []
    dst_rules = resolve_rules(dst_roles, tp_rules) if dst_roles else []
    p_src = param_spec_tree(params, src_pl, src_rules)
    p_dst = param_spec_tree(params, dst_pl, dst_rules)
    like = {p: (tuple(t.shape), t.dtype) for p, t in tree.leaves(params)}
    o_src = opt_spec_tree(opt_state, p_src, src_pl, like)
    o_dst = opt_spec_tree(opt_state, p_dst, dst_pl, like)
    layouts = build_layouts(params, p_src, p_dst, opt_state, o_src, o_dst)
    return plan_reshard(src_pl, dst_pl, layouts), p_dst


def plan_net_reshard(net, dst_pl: Placement, *,
                     src: Optional[Placement] = None, tp_rules=None):
    """Plan moving `net`'s canonical params and optimizer state from
    its current (or the given `src`) placement to `dst_pl`; shapes
    only, no collective."""
    from deeplearning4j_tpu_torch.parallel.placement import (
        canonical_opt_template,
        canonical_template,
    )

    src_pl = src if src is not None else net_placement(net)
    plan, _ = plan_for_placements(
        canonical_template(net), src_pl, dst_pl,
        opt_state=canonical_opt_template(net), tp_rules=tp_rules)
    return plan


# --------------------------------------------------------------- layouts

class PortLayout:
    """Which part of each canonical leaf each rank holds under one of
    the port's placements. `holding(rank, path, moment)` is None (the
    rank holds none of it: a stage layer of another pipe stage), {}
    (all of it) or {dim: sorted canonical indices} (a slice along one
    dim). `mesh` None: every one of `world` ranks holds every leaf
    whole (an unplaced net)."""

    def __init__(self, like, world, mesh=None, split=None, zero1=None,
                 pipe=None):
        self.like = like
        self.world = world
        self.mesh = mesh
        self.split = split
        self.zero1 = zero1
        self.pipe = pipe

    def holding(self, rank, path, moment=False):
        if self.mesh is None:
            return {}
        coords = self.mesh.coords_of(rank)
        if self.pipe is not None and self.pipe.pipe_axis is not None:
            g = self.pipe.plan.stage_of.get(path[0])
            if g is not None and coords[self.pipe.pipe_axis] != g:
                return None
        shape = self.like[path][0]
        if moment and self.zero1 is not None and path in self.zero1.paths:
            n = self.mesh.axis_size(self.zero1.axis)
            w = shape[0] // n
            i = coords[self.zero1.axis]
            return {0: torch.arange(i * w, (i + 1) * w)}
        if self.split is not None and path in self.split.leaves:
            from deeplearning4j_tpu_torch.parallel.tensor_parallel import (
                qkv_columns,
            )

            axis, dim, heads = self.split.leaves[path]
            n, i = self.mesh.axis_size(axis), coords[axis]
            if heads is not None:
                return {dim: qkv_columns(shape[dim] // 3, heads, n, i)}
            w = shape[dim] // n
            return {dim: torch.arange(i * w, (i + 1) * w)}
        return {}

    def spec(self, path, moment=False):
        """A leaf's partition as a planner spec: the mesh axis at the
        dim this layout splits, None before it; () for a leaf held whole
        (a pipeline stage's leaves are whole on the ranks of their
        stage)."""
        if self.mesh is None:
            return ()
        if moment and self.zero1 is not None and path in self.zero1.paths:
            return (self.zero1.axis,)
        if self.split is not None and path in self.split.leaves:
            axis, dim, _ = self.split.leaves[path]
            return (None,) * dim + (axis,)
        return ()

    def held_layers(self, net):
        """The layers of `net` whose params this process holds (a
        pipelined net's own stage's and the unstaged ones), in its
        order."""
        layers = (list(net.layer_vertices) if hasattr(net, "layer_vertices")
                  else list(net.layer_names))
        if self.pipe is None or self.pipe.pipe_axis is None:
            return layers
        return [n for n in layers if self.pipe.owns(n)]

    def local_shape(self, region, path):
        shape = list(self.like[path][0])
        for d, idx in region.items():
            shape[d] = len(idx)
        return tuple(shape)


def _intersect(a, b):
    """The intersection of two regions ({dim: sorted indices}), or None
    when it is empty."""
    out = dict(a)
    for d, idx in b.items():
        if d in out:
            idx = out[d][torch.isin(out[d], idx)]
        out[d] = idx
    if any(len(idx) == 0 for idx in out.values()):
        return None
    return out


def _positions(region, holding):
    """{dim: positions of region's indices in a tensor holding
    `holding`} (canonical indices along the dims it holds whole)."""
    return {d: (torch.searchsorted(holding[d], idx) if d in holding
                else idx) for d, idx in region.items()}


def _extract(t, region, holding):
    for d, pos in _positions(region, holding).items():
        t = t.index_select(d, pos.to(t.device))
    return t.contiguous()


def _place(out, piece, region, holding):
    pos = sorted(_positions(region, holding).items())

    def put(dst, src, dims):
        if not dims:
            dst.copy_(src)
            return
        (d, p), rest = dims[0], dims[1:]
        p = p.to(dst.device)
        if not rest:
            dst.index_copy_(d, p, src)
            return
        sub = dst.index_select(d, p)
        put(sub, src, rest)
        dst.index_copy_(d, p, sub)

    if not pos:
        out.copy_(piece)
    else:
        put(out, piece, pos)


def _sig(h):
    """A hashable form of a holding (None, {} or {dim: indices})."""
    if h is None:
        return None
    return tuple(sorted((d, tuple(i.tolist())) for d, i in h.items()))


def _region_bytes(shape, region, item):
    n = item
    for d, size in enumerate(_region_shape(shape, region)):
        n *= size
    return n


def _leaf_name(key) -> str:
    """A key's leaf name as `build_layouts` (and the JAX package) names
    it: `params['layer']['W']`, `opt_state['label']['m']['layer']['W']`."""
    if key[0] == "p":
        return "params" + _keystr(key[1])
    return f"opt_state{_keystr(key[1:3])}{_keystr(key[3])}"


class MovePlan:
    """The move of canonical leaves from layout `src` to layout `dst`,
    decided once and the same on every rank. For each leaf
    (`leaves`: [(key, action, pieces)]) the pieces every rank takes
    [(rank, holder, region)] — from itself where its `src` holding
    covers the piece, else from the first rank holding it — and its
    action: `keep` where every rank of `dst` holding part of it holds
    that part already (the tensor stays as it is), `slice_exchange`
    where each rank's part comes from one source shard, and
    `allgather_shard` where a rank puts its part together from several.
    `src` None plans a read from the host: every rank takes its part of
    each leaf from `HOST` (a checkpoint's memory-mapped trees), action
    `host_fallback`.

    `plan(src_pl, dst_pl)` is the move as a `planner.ReshardPlan` with
    the port's bytes (`leaf_bytes`): those of the pieces that change
    rank (or come from the host), the lower bound (the bytes each rank
    needs and does not hold under `src`), what a gather of every leaf
    whole to each of those ranks would move, and the host path's. The
    executor runs exactly these pieces, so the bytes it moves are the
    plan's."""

    def __init__(self, keys, src: Optional[PortLayout], dst: PortLayout,
                 like_of):
        self.src, self.dst, self.like_of = src, dst, like_of
        self.leaves, self.leaf_bytes = [], []
        for key, path, moment in keys:
            shape, dtype = like_of(key)
            item = torch.empty((), dtype=dtype).element_size()
            if src is None:
                shards = [({}, [HOST])]
            else:
                by_sig = {}
                for r in range(src.world):
                    h = src.holding(r, path, moment)
                    if h is not None:
                        by_sig.setdefault(_sig(h), (h, []))[1].append(r)
                shards = list(by_sig.values())
            pieces, keep, single = [], src is not None, True
            need_total = resident = moved = gather = 0
            nbytes = _region_bytes(shape, {}, item)
            for d in range(dst.world):
                need = dst.holding(d, path, moment)
                if need is None:
                    continue
                have = (src.holding(d, path, moment)
                        if src is not None and d < src.world else None)
                keep &= _sig(have) == _sig(need)
                region = None if have is None else _intersect(need, have)
                own = (0 if region is None
                       else _region_bytes(shape, region, item))
                got = []
                for h, holders in shards:
                    region = _intersect(need, h)
                    if region is not None:
                        got.append((d, d if d in holders else holders[0],
                                    region))
                single &= len(got) == 1
                pieces += got
                moved += sum(_region_bytes(shape, g[2], item)
                             for g in got if g[1] != d)
                need_total += _region_bytes(shape, need, item)
                resident += own
                gather += nbytes - own
            action = (HOST_FALLBACK if src is None else KEEP if keep
                      else SLICE_EXCHANGE if single else ALLGATHER_SHARD)
            self.leaves.append((key, action, [] if keep else pieces))
            self.leaf_bytes.append(dict(
                bytes_leaf=nbytes, bytes_moved=0 if keep else moved,
                bytes_lower_bound=need_total - resident,
                bytes_slice=need_total - resident,
                bytes_gather=max(gather, need_total - resident),
                bytes_host=nbytes + need_total))

    @property
    def bytes_moved(self) -> int:
        return sum(b["bytes_moved"] for b in self.leaf_bytes)

    def plan(self, src_pl: Placement, dst_pl: Placement) -> ReshardPlan:
        leaves = []
        for (key, action, _), b in zip(self.leaves, self.leaf_bytes):
            path, moment = key[-1], key[0] == "o"
            leaves.append(LeafPlan(
                name=_leaf_name(key), action=action,
                src_spec=(() if self.src is None
                          else self.src.spec(path, moment)),
                dst_spec=self.dst.spec(path, moment), **b))
        return ReshardPlan(src=src_pl, dst=dst_pl, leaves=tuple(leaves))


def execute_moves(mplan: MovePlan, values, ranks, device):
    """Run `mplan` in a process that holds `ranks` (one rank of a
    process group, or every rank of an in-process mesh): `values`
    {rank: {key: tensor}} are the tensors of those ranks (and `HOST`'s
    for a read). A piece between two ranks of this process, or from the
    host to one of them, is a copy on the device; a piece with one end
    here and the other in another process goes by the process group's
    point-to-point calls (`batch_isend_irecv`; every process calls this
    with the same plan). Returns ({rank: {key: new tensor}}, the bytes
    of the pieces this process sent to another rank or took from the
    host)."""
    import torch.distributed as dist

    src, dst = mplan.src, mplan.dst
    local = set(ranks)
    out = {r: {} for r in ranks}
    sent = 0

    def have(holder, path, moment):
        return {} if holder == HOST else src.holding(holder, path, moment)

    for key, action, pieces in mplan.leaves:
        path, moment = key[-1], key[0] == "o"
        shape, dtype = mplan.like_of(key)
        if action == KEEP:
            for r in ranks:
                if dst.holding(r, path, moment) is not None:
                    out[r][key] = values[r][key]
            continue
        for r in ranks:
            mine = dst.holding(r, path, moment)
            if mine is not None:
                out[r][key] = torch.empty(dst.local_shape(mine, path),
                                          dtype=dtype, device=device)
        ops, recvs = [], []
        for d, holder, region in pieces:
            if d in local and (holder in local or holder == HOST):
                piece = _extract(values[holder][key], region,
                                 have(holder, path, moment)).to(device)
                _place(out[d][key], piece, region,
                       dst.holding(d, path, moment))
                if holder != d:
                    sent += piece.numel() * piece.element_size()
            elif holder in local:
                buf = _extract(values[holder][key], region,
                               have(holder, path, moment))
                ops.append(dist.P2POp(dist.isend, buf, d))
                sent += buf.numel() * buf.element_size()
            elif d in local and holder != HOST:
                buf = torch.empty(_region_shape(shape, region),
                                  dtype=dtype, device=device)
                ops.append(dist.P2POp(dist.irecv, buf, holder))
                recvs.append((d, region, buf))
        if ops:
            for w in dist.batch_isend_irecv(ops):
                w.wait()
        for d, region, buf in recvs:
            _place(out[d][key], buf, region, dst.holding(d, path, moment))
    return out, sent


def _region_shape(shape, region):
    return tuple(len(region[d]) if d in region else s
                 for d, s in enumerate(shape))


def run_plan(mplan: MovePlan, values, ranks, device, *, src_pl=None,
             dst_pl=None, path="live", world_sum=None):
    """`execute_moves`, put on the record when the placements are given:
    a `reshard_plan` event with the plan's summary first, then a
    `reshard` span around the moves with the plan's bytes
    (`bytes_planned`, `bytes_lower_bound`) and those that moved
    (`bytes_moved`: every process's, summed by `world_sum` when more
    processes take part). The span waits for the device. Returns (the
    new tensors, the bytes moved: this process's without a record)."""
    from deeplearning4j_tpu_torch.telemetry import get_default

    if src_pl is None:
        return execute_moves(mplan, values, ranks, device)
    plan = mplan.plan(src_pl, dst_pl)
    rec = get_default()
    rec.event("reshard_plan", path=path, **plan.summary())
    with rec.span("reshard", path=path, bytes_planned=plan.bytes_moved,
                  bytes_lower_bound=plan.bytes_lower_bound) as span:
        out, moved = execute_moves(mplan, values, ranks, device)
        if world_sum is not None:
            moved = world_sum(moved)
        span["bytes_moved"] = moved
        if torch.device(device).type == "cuda":
            torch.cuda.synchronize(device)
    return out, moved


def mesh_sum(mesh):
    """A `world_sum` over the ranks of a mesh (none at one rank)."""
    if mesh is None or mesh.size == 1:
        return None

    def total(n):
        import torch.distributed as dist

        t = torch.tensor([n], dtype=torch.int64, device=mesh.device)
        dist.all_reduce(t)
        return int(t.item())

    return total


# ------------------------------------------------------------- live path

def flat_values(params, opt_state):
    """{key: tensor}: ("p", path) for the params, ("o", label, moment,
    path) for the optimizer moments."""
    out = {("p", p): t for p, t in tree.leaves(params)}
    for label, st in (opt_state or {}).items():
        keys = [tuple(k) for k in st["keys"]]
        for name, v in st.items():
            if name != "keys" and _per_leaf(v, keys):
                out.update({("o", label, name, k): t
                            for k, t in zip(keys, v)})
    return out


def moment_names(opt_state):
    """{label: [the names of its per-leaf moment lists]} of an optimizer
    state (none for None)."""
    return {label: [n for n, v in st.items()
                    if n != "keys" and isinstance(v, list)]
            for label, st in (opt_state or {}).items()}


def leaf_keys(like, labels, names):
    """[(key, leaf path, is a moment)] of every canonical param of `like`
    and every moment `names` {label: [moment]} keeps for the paths of
    `labels` {label: [path]}, in a fixed order."""
    keys = [(("p", p), p, False) for p in like]
    for label, paths in labels.items():
        for name in names.get(label, ()):
            keys += [(("o", label, name, p), p, True) for p in paths]
    return keys


def rebuild(got, like, labels, opt_template, layers):
    """The params and optimizer state of this rank from its moved
    tensors."""
    params = tree.from_leaves((p, got[("p", p)]) for p in like
                              if ("p", p) in got)
    for layer in layers:
        params.setdefault(layer, {})
    if opt_template is None:
        return params, None
    opt = {}
    for label, st in opt_template.items():
        paths = [p for p in labels[label] if ("p", p) in got]
        new = {"keys": paths}
        for name, v in st.items():
            if name == "keys":
                continue
            if _per_leaf(v, st["keys"]) or (isinstance(v, list)
                                            and not st["keys"]):
                v = [got[("o", label, name, p)] for p in paths]
            new[name] = v
        opt[label] = new
    return params, opt


class NetMoves:
    """The `MovePlan` of a net's canonical leaves (params, and the
    optimizer moments when `with_opt`) from layout `src` (None: the
    host's trees of a checkpoint) to layout `dst`, and `apply`, which
    runs it on this rank's trees. Same on every rank."""

    def __init__(self, net, src: Optional[PortLayout], dst: PortLayout,
                 with_opt: bool):
        from deeplearning4j_tpu_torch.parallel.placement import (
            canonical_labels,
            canonical_opt_template,
        )

        self.net, self.src, self.dst = net, src, dst
        self.labels = canonical_labels(net)
        self.opt_t = canonical_opt_template(net) if with_opt else None
        keys = leaf_keys(dst.like, self.labels if with_opt else {},
                         moment_names(self.opt_t))
        self.plan = MovePlan(keys, src, dst, lambda k: dst.like[k[-1]])

    def apply(self, params, opt_state=None, *, src_pl=None, dst_pl=None,
              path="live"):
        """(params, opt_state) of layout `dst` from this rank's trees of
        layout `src` (every rank calls it), on the record when the
        placements are given (`run_plan`)."""
        mesh = self.dst.mesh if self.dst.mesh is not None else (
            self.src.mesh if self.src is not None else None)
        me = mesh.rank if mesh is not None else 0
        values = {HOST if self.src is None else me:
                  flat_values(params, opt_state)}
        got, _ = run_plan(self.plan, values, (me,), self.net.device,
                          src_pl=src_pl, dst_pl=dst_pl, path=path,
                          world_sum=mesh_sum(mesh))
        # a read from the host keeps the canonical state's counts
        template = opt_state if self.src is None else self.opt_t
        return rebuild(got[me], self.dst.like, self.labels, template,
                       self.dst.held_layers(self.net))


def reshard_net_live(net, src: PortLayout, dst: PortLayout, *,
                     src_pl: Placement = None, dst_pl: Placement = None):
    """Move `net`'s params and optimizer state from layout `src` to
    `dst` by their `MovePlan` (module docstring), on the record when the
    placements are given. Every rank calls it. Returns the plan."""
    moves = NetMoves(net, src, dst, net.opt_state is not None)
    net.params, opt = moves.apply(net.params, net.opt_state, src_pl=src_pl,
                                  dst_pl=dst_pl)
    if net.opt_state is not None:
        net.opt_state = opt
    return moves.plan


# ------------------------------------------------------- checkpoint path

def checkpoint_template(net, dst: PortLayout) -> NetMoves:
    """The restore-side executor input: the read of each leaf's part
    that a rank keeps under `dst` out of the checkpoint's memory-mapped
    canonical trees (a `MovePlan` from the host)."""
    return NetMoves(net, None, dst, True)


def restore_placed(net, trees, src_placement: Placement, dst: PortLayout,
                   dst_pl: Placement):
    """Put the canonical `trees` of a checkpoint (params, opt_state;
    memory-mapped tensors) into placed `net`: each rank copies the part
    of each leaf it keeps to its device. Records the plan and a
    `reshard` span whose bytes are those every rank read. Returns
    (params, opt_state)."""
    return checkpoint_template(net, dst).apply(
        trees["params"], trees["opt_state"], src_pl=src_placement,
        dst_pl=dst_pl, path="checkpoint")


# ------------------------------------------------------------ in process

def virtual_mesh(shape: dict, device=None):
    """A Mesh of `shape` whose ranks are all held by this process (no
    process group: its layouts only read coordinates), on `device` (CUDA
    unless the caller names another)."""
    from deeplearning4j_tpu_torch.parallel.mesh import Mesh

    return Mesh(dict(shape), resolve_device(device), {},
                {a: 0 for a in shape}, 0)


def reshard_in_process(params_by_rank, src: PortLayout, dst: PortLayout, *,
                       src_pl: Placement, dst_pl: Placement):
    """The live move of params among the ranks of a mesh that one process
    holds ({rank: params} in, {rank: params} out): `run_plan` of the
    params' `MovePlan` with every rank local, so each piece is a copy on
    the device. What one card runs to move n shards. Returns (plan,
    bytes that changed rank, {rank: params})."""
    like = src.like
    mplan = MovePlan(leaf_keys(like, {}, {}), src, dst,
                     lambda k: like[k[-1]])
    first = next(iter(params_by_rank.values()))
    device = next(t for _, t in tree.leaves(first)).device
    got, moved = run_plan(mplan, {r: flat_values(p, None)
                                  for r, p in params_by_rank.items()},
                          tuple(range(max(src.world, dst.world))), device,
                          src_pl=src_pl, dst_pl=dst_pl)
    return (mplan.plan(src_pl, dst_pl), moved,
            {d: tree.from_leaves((k[-1], t) for k, t in got[d].items())
             for d in range(dst.world)})
