"""Pipeline parallelism ("pipe"; JAX counterpart
deeplearning4j_tpu/parallel/pipeline.py).

The partition is the JAX package's, computed on the port's conf: the
DAG's topological order is scanned for single-value cuts; the longest
run of structurally identical cut-to-cut segments (fingerprinted on
vertex kinds, configs without their names, wiring and param shapes)
becomes the pipelined body, cut into S stages of equal blocks; what
comes before it is the PRE segment (embedding, positional encoding),
what comes after the POST segment (final LayerNorm, the head and its
loss). `PipelinePlan` holds it with the JAX package's names (`pre_layers`,
`group_layers`, `post_layers`) and error texts; `to_pipelined` /
`to_canonical` restack a tree into the JAX layout ({pre, stages: leaves
stacked on a leading [S] axis, post}) and back.

The step (`make_pp_train_step`) is a GPipe schedule over M
microbatches, written once over a transport:

- forward: at tick t stage s runs microbatch t - s (stage 0 runs PRE
  first); its output goes to stage s + 1, the last stage's to the rank
  that computes that microbatch's POST and loss, j % S (the JAX
  package's "done lane");
- each rank then runs POST and the loss of its microbatches, one at a
  time, and their backward, in reverse. Since POST runs a microbatch at
  a time, M need not be a multiple of S (the JAX step's done lane keeps
  M/S slots a device and refuses any other M): the flagship's batch of
  32 runs 8 microbatches over 3 stages;
- backward: the stages in reverse tick order, the last stage starting
  from the cotangent its microbatch's POST sent back.

Activations and their cotangents move as `torch.autograd.Function`s
(`_Send`, `_Recv`): a send's backward receives the cotangent, a
receive's backward sends one. `ProcessGroupPipe` carries them over the
process group's point-to-point calls (`batch_isend_irecv`: NCCL on
CUDA, gloo on the CPU), one stage a rank; `InProcessPipe` runs all S
stages in one process (queues), which is what one card can run. The
two differ only in how a tensor reaches the next stage, and give the
same bits.

Each pipe rank keeps only its stage's layers (and PRE and POST, which
stay replicated over "pipe"); the gradients of PRE and POST are summed
over "pipe", a stage's stay on its rank; every gradient is summed over
"data" and "seq". With a "seq" axis (the JAX step's stream P(None, data,
seq)) each rank holds its time block of its rows of every microbatch,
and the whole step runs as its `SeqShard`: the stages' attention is the
ring over the stage's seq group, the positional encoding offsets by the
block. A stage's ring hops and its pipe hops run on communicators of
their own, and every rank of a stage issues both in the same order.
The loss is the JAX step's: the mean of the microbatch means, or, with
a labels mask, each microbatch's masked mean weighted by its count of
valid labels against the count over all microbatches and data and seq
shards; an L1/L2 penalty is added once; MoE aux losses as the JAX step
combines them. Layer state (batch norm) runs through the microbatches
in order, stage by stage, each stage's state then handed to every rank.
Dropout draws from the net's generator in schedule order, so it agrees
with the JAX step in distribution only.
"""

from __future__ import annotations

import dataclasses
from collections import defaultdict, deque

import torch

from deeplearning4j_tpu_torch.nn import tree
from deeplearning4j_tpu_torch.nn.conf.graph_conf import LayerVertexConf
from deeplearning4j_tpu_torch.nn.conf.layers import BaseOutputLayer
from deeplearning4j_tpu_torch.nn.layers import l1_l2_penalty  # noqa: F401


def _chain_cuts(conf):
    """Positions in topo order after which exactly ONE activation is
    live (single-edge cuts of the DAG: valid stage boundaries)."""
    topo = [n for n in conf.topological_order()
            if n not in conf.network_inputs]
    pos = {n: i for i, n in enumerate(topo)}
    INF = len(topo) + 1
    last_use = {}
    for n in topo:
        for src in conf.vertex_inputs[n]:
            last_use[src] = max(last_use.get(src, -1), pos[n])
    for out in conf.network_outputs:
        last_use[out] = INF
    cuts = []
    for i, n in enumerate(topo):
        live = [v for v in topo[:i + 1] if last_use.get(v, -1) > i]
        live += [v for v in conf.network_inputs if last_use.get(v, -1) > i]
        if live == [n]:
            cuts.append(i)
    return topo, cuts


def _conf_repr(obj):
    """Structural repr of a (possibly nested) vertex or layer config with
    its identity field ('name') left out: two blocks that differ only in
    layer names fingerprint equal."""
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        fields = ", ".join(
            f"{f.name}={_conf_repr(getattr(obj, f.name))}"
            for f in dataclasses.fields(obj) if f.name != "name")
        return f"{type(obj).__name__}({fields})"
    return repr(obj)


def _fingerprint(conf, params, seg, ext):
    """Structural identity of one cut-to-cut segment: vertex kinds,
    configs, segment-local wiring, param leaf shapes and dtypes."""
    pos = {n: j for j, n in enumerate(seg)}
    entries = []
    for n in seg:
        v = conf.vertices[n]
        wires = tuple(("ext",) if i == ext else ("local", pos[i])
                      for i in conf.vertex_inputs[n])
        shapes = tuple((tuple(t.shape), str(t.dtype))
                       for _, t in tree.leaves(params.get(n, {})))
        entries.append((type(v).__name__, _conf_repr(v), wires, shapes))
    return tuple(entries)


def _longest_periodic_run(fps):
    """(lo, n_units, period): the run of consecutive repeat units of
    `period` segments each, with identical per-unit fingerprints, that
    covers the most segments."""
    n = len(fps)
    best = (0, 1, 1)
    for p in range(1, n // 2 + 1):
        for lo in range(0, n - p + 1):
            unit = tuple(fps[lo:lo + p])
            c = 1
            while (lo + (c + 1) * p <= n
                   and tuple(fps[lo + c * p:lo + (c + 1) * p]) == unit):
                c += 1
            if c > 1 and c * p > best[1] * best[2]:
                best = (lo, c, p)
    return best


class PipelinePlan:
    """Partition of a ComputationGraph into pre / S stages / post (the
    JAX package's `PipelinePlan`, same names and errors). `stage_of`
    {layer: stage} for the body's layers. `params`: the canonical params
    whose shapes the fingerprint reads (the net's by default)."""

    def __init__(self, net, n_stages: int, params=None):
        conf = net.conf
        if len(conf.network_inputs) != 1 or len(conf.network_outputs) != 1:
            raise ValueError(
                "pipeline parallelism supports single-input single-output "
                f"graphs; got {len(conf.network_inputs)} inputs / "
                f"{len(conf.network_outputs)} outputs")
        self.net = net
        self.S = n_stages
        self.input_name = conf.network_inputs[0]
        out_name = conf.network_outputs[0]
        out_v = conf.vertices[out_name]
        if not (isinstance(out_v, LayerVertexConf)
                and isinstance(out_v.layer, BaseOutputLayer)):
            raise ValueError("pipeline parallelism needs an output layer "
                             "as the single network output")
        if net.params is None:
            net.init()
        params = net.params if params is None else params

        topo, cuts = _chain_cuts(conf)
        if not cuts:
            raise ValueError("graph has no single-activation cut points — "
                             "cannot partition into pipeline stages")
        bounds = [-1] + cuts
        segs = [topo[bounds[i] + 1:bounds[i + 1] + 1]
                for i in range(len(bounds) - 1)]
        if bounds[-1] != len(topo) - 1:
            segs.append(topo[bounds[-1] + 1:])
        ext_of = [self.input_name] + [s[-1] for s in segs[:-1]]
        fps = [_fingerprint(conf, params, s, e)
               for s, e in zip(segs, ext_of)]
        lo, units, period = _longest_periodic_run(fps)
        if units % n_stages:
            raise ValueError(
                f"the {units} repeated blocks do not divide into "
                f"{n_stages} pipeline stages. The GPipe schedule runs one "
                "stage program over params stacked on a [S] axis, so the "
                "pipelined body must be a run of structurally IDENTICAL "
                "blocks (uniform transformer blocks qualify; VGG/ResNet-"
                "style conv stacks whose channel widths grow between "
                "stages do not — their per-stage compute differs, which "
                "would need a heterogeneous-stage schedule; shard those "
                "over the data axis instead)")
        per_stage = units // n_stages
        hi = lo + units * period
        body_segs = segs[lo:hi]
        seg_per_stage = per_stage * period
        self.stage_groups = [
            sum(body_segs[g * seg_per_stage:(g + 1) * seg_per_stage], [])
            for g in range(n_stages)]
        self.pre_names = sum(segs[:lo], [])
        post = sum(segs[hi:], [])
        if post and post[-1] == out_name:
            post = post[:-1]  # the loss layer runs in post_loss
        self.post_names = post
        self.out_name = out_name
        self.out_vconf = out_v
        self.pre_ext = self.input_name
        self.body_ext = segs[lo - 1][-1] if lo > 0 else self.input_name
        self.post_ext = body_segs[-1][-1] if body_segs else self.body_ext
        self.loss_ext = conf.vertex_inputs[out_name][0]
        # stage stacking follows topo order within a group ('blk10' <
        # 'blk9' lexicographically would misalign the leaves)
        self.group_layers = [
            [n for n in g if isinstance(conf.vertices[n], LayerVertexConf)]
            for g in self.stage_groups]
        self.pre_layers = [n for n in self.pre_names
                           if isinstance(conf.vertices[n], LayerVertexConf)]
        self.post_layers = [n for n in self.post_names
                            if isinstance(conf.vertices[n], LayerVertexConf)
                            ] + [out_name]
        self.stage_of = {n: g for g, names in enumerate(self.group_layers)
                         for n in names}
        self.has_state = any(
            t.is_floating_point() for n in self.stage_of
            for _, t in tree.leaves(net.state.get(n, {})))

    # ------------------------------------------------------------ regions
    def _region(self, names, ext, params, state, x, mask, *, train,
                generator):
        """Run the vertices `names` on `x` (the value `ext`): (output,
        new state of their layers)."""
        net = self.net
        if x.is_floating_point():
            x = x.to(net.compute_dtype)
        acts = {ext: x}
        masks = {} if mask is None else {ext: mask}
        new_state = {}
        net._run_vertices(names, params, state, acts, masks, new_state,
                          train=train, generator=generator)
        return acts[names[-1]] if names else x, new_state

    def pre_apply(self, params, state, x, *, train, generator, mask=None):
        return self._region(self.pre_names, self.pre_ext, params, state, x,
                            mask, train=train, generator=generator)

    def stage_apply(self, g, params, state, x, *, train, generator,
                    mask=None):
        """Stage g's vertices on x, the value the stage before it ends
        with (`body_ext` for stage 0)."""
        ext = self.body_ext if g == 0 else self.stage_groups[g - 1][-1]
        return self._region(self.stage_groups[g], ext, params, state, x,
                            mask, train=train, generator=generator)

    def post_loss(self, params, state, h, labels, *, train, generator,
                  mask=None, feat_mask=None):
        """POST and the output layer's loss on a batch of finished
        activations: (loss, new state of the POST layers)."""
        net = self.net
        acts = {self.post_ext: h}
        masks = {} if feat_mask is None else {self.post_ext: feat_mask}
        new_state = {}
        net._run_vertices(self.post_names, params, state, acts, masks,
                          new_state, train=train, generator=generator)
        batch = {"labels": (labels,)}
        if mask is not None:
            batch["labels_masks"] = (mask,)
        loss = net._output_losses(params, acts, batch, train=train,
                                  generator=generator)
        return loss, new_state

    # -------------------------------------------------- tree restructure
    def _to_pipelined(self, tree_, default=None):
        def get(n):
            return tree_[n] if default is None else tree_.get(n, default)

        pre = {n: get(n) for n in self.pre_layers}
        post = {n: get(n) for n in self.post_layers}
        per_group = [[t for name in g for _, t in tree.leaves(get(name))]
                     for g in self.group_layers]
        stages = tuple(torch.stack([per_group[g][i] for g in range(self.S)])
                       for i in range(len(per_group[0])))
        return {"pre": pre, "stages": stages, "post": post}

    def _to_canonical(self, pp, like):
        out = dict(pp["pre"])
        out.update(pp["post"])
        for g, names in enumerate(self.group_layers):
            i = 0
            for tmpl, name in zip(self.group_layers[0], names):
                paths = [p for p, _ in tree.leaves(like[tmpl])]
                out[name] = tree.from_leaves(
                    (p, pp["stages"][i + k][g]) for k, p in enumerate(paths))
                if not paths:
                    out[name] = {}
                i += len(paths)
        return out

    def to_pipelined(self, params):
        """The JAX package's pipelined layout of canonical params: {pre,
        stages (each stage leaf stacked on a leading [S] axis, in topo
        order within a group), post}."""
        return self._to_pipelined(params)

    def to_canonical(self, pp):
        return self._to_canonical(pp, self._template())

    def to_pipelined_state(self, state):
        return self._to_pipelined(state, default={})

    def to_canonical_state(self, pp_state, full_state=None):
        out = dict(full_state or {})
        out.update(self._to_canonical(pp_state, {
            n: self.net.state.get(n, {}) for n in self.group_layers[0]}))
        return out

    def _template(self):
        """The group-0 layers' canonical params as meta tensors (their
        leaf paths; no collective)."""
        from deeplearning4j_tpu_torch.parallel.placement import (
            canonical_template,
        )

        params = canonical_template(self.net)
        return {n: params[n] for n in self.group_layers[0]}

    def placements(self, mesh, axes: dict, rules):
        """The pipelined tree's specs (tuples of axis names and None, the
        PartitionSpec's entries): stacked stage leaves split their leading
        [S] dim over the pipe axis composed with the placement rules;
        pre and post follow the rules, whole over pipe."""
        from deeplearning4j_tpu_torch.parallel.placement import (
            canonical_template,
        )
        from deeplearning4j_tpu_torch.parallel.tensor_parallel import (
            spec_for,
        )

        pipe = axes["pipe"]
        params = canonical_template(self.net)

        def named(layer):
            return {"/".join(p): spec_for("/".join((layer,) + p), mesh,
                                          rules)
                    for p, _ in tree.leaves(params[layer])}

        stages = tuple((pipe, *spec_for("/".join((name,) + p), mesh, rules))
                       for name in self.group_layers[0]
                       for p, _ in tree.leaves(params[name]))
        return {"pre": {n: named(n) for n in self.pre_layers},
                "stages": stages,
                "post": {n: named(n) for n in self.post_layers}}


def check_pp_supported(net):
    """Configuration modes the PP step cannot honour raise up front."""
    from deeplearning4j_tpu_torch.nn.conf.enums import GradientNormalization
    from deeplearning4j_tpu_torch.nn.training import is_sgd, is_tbptt

    g = net.conf.conf
    if not is_sgd(net.conf):
        raise ValueError("pipeline parallelism supports SGD-family "
                         "training only (no second-order solvers)")
    if is_tbptt(net.conf):
        raise ValueError("pipeline parallelism does not support TBPTT")
    for name, v in net.layer_vertices.items():
        lc = v.layer
        gn = getattr(lc, "gradient_normalization", None)
        if gn not in (None, GradientNormalization.NONE, "none"):
            raise ValueError(
                f"per-layer gradient normalization on '{name}' is not "
                "supported under pipeline parallelism")
        if (getattr(lc, "updater", None) not in (None, g.updater)
                or getattr(lc, "learning_rate", None) is not None):
            raise ValueError(
                f"per-layer updater/learning-rate override on '{name}' is "
                "not supported under pipeline parallelism (the optimizer "
                "runs on the stacked stage tree)")


# ------------------------------------------------------------ transports

class InProcessPipe:
    """All S stages in one process: a tensor reaches the next stage
    through a queue a (source, destination, kind) channel; the sum over
    "pipe" adds the stages' tensors in stage order."""

    def __init__(self, n_stages: int):
        self.S = n_stages
        self.local_stages = list(range(n_stages))
        self._queues = defaultdict(deque)
        self.needs_shapes = False

    def send(self, t, src, dst, kind):
        self._queues[(src, dst, kind)].append(t.detach())

    def recv(self, src, dst, kind, like=None):
        return self._queues[(src, dst, kind)].popleft()

    def flush(self):
        if any(self._queues.values()):
            raise RuntimeError("a pipeline step left tensors in flight")

    def sum_over_pipe(self, by_stage, like):
        """[tensor]: position by position, the stages' tensors of
        {stage: [tensor or None]} summed in stage order (None: the stage
        holds none, adds nothing)."""
        out = []
        for i in range(len(like)):
            acc = None
            for g in sorted(by_stage):
                x = by_stage[g][i]
                if x is not None:
                    acc = x if acc is None else acc + x
            out.append(acc)
        return out

    def mean_over_pipe(self, states):
        """The mean of the stages' copies of one layer-state tree: float
        leaves summed in stage order and divided once, the others the
        first copy's."""
        if len(states) == 1:
            return states[0]
        out = {}
        for path, t in tree.leaves(states[0]):
            if t.is_floating_point():
                acc = t
                for st in states[1:]:
                    acc = acc + tree.get(st, path)
                t = acc / len(states)
            tree.put(out, path, t)
        for n in states[0]:
            out.setdefault(n, {})
        return out

    def sum_scalars(self, values):
        """The sum of the stages' scalars (one a stage), in stage order."""
        total = values[0]
        for x in values[1:]:
            total = total + x
        return total

    def share_stage_state(self, rt, state):
        return state  # every stage's state is this process's already


class ProcessGroupPipe:
    """One stage a rank of the mesh's pipe axis; sends and receives are
    point-to-point calls of the process group (`batch_isend_irecv`), a
    receive waited at once, the sends at the end of the step (`flush`),
    so no call is left pending. A hop from a rank to itself (the last
    stage's own microbatches, a pipe of one) goes through a queue."""

    def __init__(self, mesh, axis: str):
        self.S = mesh.axis_size(axis)
        self.index = mesh.axis_index(axis)
        self.local_stages = [self.index]
        self.group = mesh.group(axis)
        self.peers = [mesh.rank_of({axis: g}) for g in range(self.S)]
        self._local = InProcessPipe(self.S)
        self._pending = []
        self.needs_shapes = self.S > 1

    def send(self, t, src, dst, kind):
        import torch.distributed as dist

        if dst == self.index:
            self._local.send(t, src, dst, kind)
            return
        buf = t.detach().contiguous()
        works = dist.batch_isend_irecv(
            [dist.P2POp(dist.isend, buf, self.peers[dst])])
        self._pending.append((buf, works))

    def recv(self, src, dst, kind, like=None):
        import torch.distributed as dist

        if src == self.index:
            return self._local.recv(src, dst, kind)
        buf = torch.empty(like[0], dtype=like[1], device=like[2])
        for w in dist.batch_isend_irecv(
                [dist.P2POp(dist.irecv, buf, self.peers[src])]):
            w.wait()
        return buf

    def flush(self):
        for _, works in self._pending:
            for w in works:
                w.wait()
        self._pending = []
        self._local.flush()

    def sum_over_pipe(self, by_stage, like):
        """This stage's tensors ({stage: [tensor or None]}, None for
        zeros) summed over the pipe group."""
        (mine,) = by_stage.values()
        mine = [torch.zeros_like(t) if x is None else x
                for t, x in zip(like, mine)]
        return _all_reduce_sum(mine, self.group) if self.S > 1 else mine

    def mean_over_pipe(self, states):
        from deeplearning4j_tpu_torch.parallel.overlap import (
            pmean_float_leaves,
        )

        (mine,) = states
        return pmean_float_leaves(mine, self.group, self.S) if self.S > 1 \
            else mine

    def sum_scalars(self, values):
        (mine,) = values
        if self.S == 1:
            return mine
        return _all_reduce_sum([mine.reshape(1)], self.group)[0][0]

    def share_stage_state(self, rt, state):
        """Every stage layer's state (and PRE's, from stage 0) broadcast
        from the rank that ran it to every pipe rank."""
        import torch.distributed as dist

        plan = rt.plan
        if self.S == 1:
            return state
        out = dict(state)
        owner = dict(plan.stage_of)
        owner.update({n: 0 for n in plan.pre_layers})
        for n in sorted(owner):
            leaves = []
            for p, t in tree.leaves(state.get(n, {})):
                t = t.detach().contiguous().clone()
                dist.broadcast(t, src=self.peers[owner[n]], group=self.group)
                leaves.append((p, t))
            if leaves:
                out[n] = tree.from_leaves(leaves)
        return out


def _all_reduce_sum(ts, group):
    """The sum over `group` of each tensor of `ts`: one all-reduce a
    dtype, over the tensors flattened into one buffer."""
    import torch.distributed as dist

    out = list(ts)
    by_dtype = defaultdict(list)
    for i, t in enumerate(ts):
        by_dtype[t.dtype].append(i)
    for idx in by_dtype.values():
        flat = torch.cat([ts[i].reshape(-1) for i in idx])
        dist.all_reduce(flat, group=group)
        off = 0
        for i in idx:
            n = ts[i].numel()
            out[i] = flat[off:off + n].view_as(ts[i])
            off += n
    return out


class _Send(torch.autograd.Function):
    """y of stage `src` handed to stage `dst`; returns a scalar token
    whose backward receives y's cotangent from `dst`."""

    @staticmethod
    def forward(ctx, y, hop):
        tr, src, dst, like = hop
        ctx.hop = hop
        tr.send(y, src, dst, "act")
        return y.new_zeros(())

    @staticmethod
    def backward(ctx, _g):
        tr, src, dst, like = ctx.hop
        return tr.recv(dst, src, "grad", like), None


class _Recv(torch.autograd.Function):
    """The activation stage `src` handed to stage `dst`, as a tensor of
    dst's graph (`anchor` is a grad-requiring scalar that ties it in);
    its backward sends the cotangent back to `src`."""

    @staticmethod
    def forward(ctx, anchor, hop):
        tr, src, dst, like = hop
        ctx.hop = hop
        x = tr.recv(src, dst, "act", like)
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        tr, src, dst, _ = ctx.hop
        tr.send(g, dst, src, "grad")
        return None, None


# ------------------------------------------------------------------ step

@dataclasses.dataclass
class PipeRuntime:
    """What a pipelined net runs with: its plan, transport, microbatch
    count, and its mesh with the "pipe", "data" and "seq" axes (None in
    one process); `owns(layer)` whether this process holds the layer's
    params. `seq_axis`: the conf's sequence-parallel axis when the
    stages run ring attention (`seq_blocks` blocks in this process
    without a mesh)."""

    plan: PipelinePlan
    transport: object
    n_microbatches: int
    mesh: object = None
    pipe_axis: str = None
    data_axis: str = None
    seq_axis: str = None
    seq_blocks: int = 1

    @property
    def S(self):
        return self.plan.S

    @property
    def local_stages(self):
        return self.transport.local_stages

    def _size(self, axis):
        if self.mesh is None or axis is None:
            return 1
        return self.mesh.axis_size(axis)

    @property
    def n_data(self):
        return self._size(self.data_axis)

    @property
    def n_shards(self):
        """The batch shards a microbatch is cut into: its data rows
        times its seq blocks (each a rank)."""
        return self.n_data * self._size(self.seq_axis)

    @property
    def shard_group(self):
        """The process group over the data and seq axes (the ranks of
        one stage that hold the other parts of each microbatch), or
        None on a single shard; made collectively on first use, which
        `configure_mesh` makes on every rank."""
        if self.n_shards == 1:
            return None
        return self.mesh.subgroup(tuple(
            a for a in (self.data_axis, self.seq_axis)
            if a is not None and self.mesh.axis_size(a) > 1))

    def seq_shard(self, generator):
        """(the SeqShard the stages' layers run as, the generator of
        their other dropout) for a step drawing from `generator`; (None,
        generator) without a seq axis. The ring generator is common to
        the seq shards of a microbatch; the other draws fold in this
        shard's seq index (the JAX step's `fold_in`)."""
        from deeplearning4j_tpu_torch.ops.shard_scope import (
            SeqShard,
            shard_generator,
        )
        from deeplearning4j_tpu_torch.parallel.ring_attention import (
            InProcessRing,
            ProcessGroupRing,
        )

        if self.seq_axis is None:
            return None, generator
        if self.mesh is None:
            return SeqShard(self.seq_axis, InProcessRing(self.seq_blocks),
                            0, 1, generator), generator
        n, i = self.mesh.axis_size(self.seq_axis), self.mesh.axis_index(
            self.seq_axis)
        ring = ProcessGroupRing(self.mesh.group(self.seq_axis), n, i)
        ring_gen = shard_generator(generator, (), n)
        return (SeqShard(self.seq_axis, ring, i, n, ring_gen),
                shard_generator(generator, (i,), n))

    def owns(self, layer) -> bool:
        g = self.plan.stage_of.get(layer)
        return g is None or g in self.local_stages


def _first_mask(ms):
    return next((m for m in (ms or []) if m is not None), None)


def microbatch_rows(B: int, M: int, n_data: int, index: int):
    """The rows of a global batch of B that data shard `index` of
    `n_data` holds under a pipelined step of M microbatches: its
    contiguous share of every microbatch (the JAX step's stream
    [M, mb, ...] split over the data axis on its second dim)."""
    import numpy as np

    if B % M:
        raise ValueError(f"batch {B} not divisible into {M} microbatches")
    mb = B // M
    if mb % n_data:
        raise ValueError(
            f"microbatch size {mb} not divisible over the "
            f"{n_data}-way data axis")
    w = mb // n_data
    return np.concatenate([np.arange(j * mb + index * w,
                                     j * mb + (index + 1) * w)
                           for j in range(M)])


def make_pp_train_step(net, rt: PipeRuntime):
    """The GPipe train step over `rt`'s transport (module docstring),
    the container contract: step(params, opt_state, state, generator,
    batch) -> (params, opt_state, state, loss, {}), params and
    opt_state updated in place; batch holds this rank's rows (under a
    data axis, `microbatch_rows` of the global batch)."""
    from deeplearning4j_tpu_torch.nn.layers import (
        l1_l2_penalty,
        pop_aux_losses,
    )
    from deeplearning4j_tpu_torch.nn.updater import apply_updates
    from deeplearning4j_tpu_torch.ops.shard_scope import sharded
    from deeplearning4j_tpu_torch.parallel.overlap import pmean_float_leaves

    plan, tr = rt.plan, rt.transport
    S, M = plan.S, rt.n_microbatches
    tx = net.tx
    # the data rows and seq blocks of each microbatch: the loss weights,
    # the gradients, the loss and the layer state combine over them
    n_data, dgroup = rt.n_shards, rt.shard_group
    pipe_layers = plan.pre_layers + plan.post_layers

    def layer_leaves(layers, params):
        return [((n,) + p, t) for n in layers
                for p, t in tree.leaves(params.get(n, {}))
                if t.is_floating_point()]

    def detached(state):
        return tree.tree_map(lambda t: t.detach(), state)

    def step(params, opt_state, state, generator, batch):
        seq, generator = rt.seq_shard(generator)
        with sharded(seq=seq):
            return run(params, opt_state, state, generator, batch)

    def run(params, opt_state, state, generator, batch):
        toks = batch["features"][0]
        labs = batch["labels"][0]
        fmask = _first_mask(batch.get("features_masks"))
        lmask = _first_mask(batch.get("labels_masks"))
        B = toks.shape[0]
        if B % M:
            raise ValueError(f"batch {B} not divisible into {M} "
                             "microbatches")
        mb = B // M

        def part(a, j):
            return None if a is None else a.narrow(0, j * mb, mb)

        # the loss weights: each microbatch's mean, or its masked mean
        # weighted by its count of valid labels against the count over
        # every pipe device's microbatches and every data and seq shard
        if lmask is None:
            weights = [1.0 / (M * n_data)] * M
        else:
            cnt = [part(lmask, j).float().sum() for j in range(M)]
            per_dev = [sum(cnt[j] for j in range(d, M, S)).clamp_min(1.0)
                       for d in range(S)]
            denom = sum(per_dev[1:], per_dev[0]).reshape(1)
            if dgroup is not None:
                denom = _all_reduce_sum([denom], dgroup)[0]
            weights = [c.clamp_min(1.0) / denom[0] for c in cnt]
        aux_scale = 1.0 / (M * n_data)
        report = {g: [] for g in tr.local_stages}

        # live leaves a stage: its layers, PRE on stage 0, POST on every
        # stage that owns microbatches (each its own, summed over pipe)
        live = {}
        for g in tr.local_stages:
            names = plan.group_layers[g] + plan.post_layers + (
                plan.pre_layers if g == 0 else [])
            live[g] = tree.from_leaves(
                (path, t.detach().requires_grad_())
                for path, t in layer_leaves(names, params))
            for n in names:
                live[g].setdefault(n, {})
        like = None
        if tr.needs_shapes:
            with torch.no_grad():
                probe, _ = plan.pre_apply(params, state, part(toks, 0),
                                          train=False, generator=None,
                                          mask=part(fmask, 0))
            like = (probe.shape, probe.dtype, probe.device)
        anchor = torch.zeros((), requires_grad=True)
        cur = {g: {n: state.get(n, {}) for n in plan.group_layers[g]}
               for g in tr.local_stages}
        pre_state = {n: state.get(n, {}) for n in plan.pre_layers}

        # forward ticks
        sent = {g: {} for g in tr.local_stages}
        for t in range(M + S - 1):
            for g in tr.local_stages:
                j = t - g
                if not 0 <= j < M:
                    continue
                aux = 0.0
                if g == 0:
                    x, new = plan.pre_apply(live[0], pre_state,
                                            part(toks, j), train=True,
                                            generator=generator,
                                            mask=part(fmask, j))
                    a, new = pop_aux_losses(new)
                    pre_state.update(detached(new))
                    aux = aux + a
                else:
                    x = _Recv.apply(anchor, (tr, g - 1, g, like))
                y, new = plan.stage_apply(g, live[g], cur[g], x, train=True,
                                          generator=generator,
                                          mask=part(fmask, j))
                a, new = pop_aux_losses(new)
                cur[g].update(detached(new))
                aux = aux + a
                dst = g + 1 if g < S - 1 else j % S
                sent[g][j] = (_Send.apply(y, (tr, g, dst, like)), aux)

        # POST and the loss of each rank's microbatches, then their
        # backward in reverse
        post_state = {g: {n: state.get(n, {}) for n in plan.post_layers}
                      for g in tr.local_stages}
        objectives = {}
        for r in tr.local_stages:
            for j in range(r, M, S):
                h = _Recv.apply(anchor, (tr, S - 1, r, like))
                loss, new = plan.post_loss(
                    live[r], post_state[r], h, part(labs, j), train=True,
                    generator=generator, mask=part(lmask, j),
                    feat_mask=part(fmask, j))
                a, new = pop_aux_losses(new)
                post_state[r].update(detached(new))
                obj = loss * weights[j]
                report[r].append(obj.detach())
                if not isinstance(a, float) or a:
                    obj = obj + a * aux_scale
                    report[r].append((a * aux_scale).detach())
                objectives[(r, j)] = obj
        for r in tr.local_stages:
            for j in reversed(range(r, M, S)):
                objectives.pop((r, j)).backward()

        # backward ticks, the stages in reverse
        for t in range(M + S - 1):
            for g in reversed(tr.local_stages):
                j = M - 1 - (t - (S - 1 - g))
                if not 0 <= j < M:
                    continue
                token, aux = sent[g].pop(j)
                if isinstance(aux, float) and not aux:
                    token.backward()
                else:
                    torch.autograd.backward(
                        [token, aux * aux_scale],
                        [torch.ones_like(token), None])
                    report[g].append((aux * aux_scale).detach())
        tr.flush()

        # the L1/L2 penalty, once: a stage's on its rank, PRE's and
        # POST's on stage 0, all on data and seq shard 0
        lead = rt.mesh is None or all(
            rt.mesh.axis_index(a) == 0 for a in (rt.data_axis, rt.seq_axis)
            if a is not None)
        if lead:
            for g in tr.local_stages:
                layers = plan.group_layers[g] + (pipe_layers if g == 0
                                                 else [])
                pen = 0.0
                for n in layers:
                    pen = pen + l1_l2_penalty(
                        net.layer_vertices[n].layer, live[g][n])
                if isinstance(pen, torch.Tensor):
                    if pen.requires_grad:
                        pen.backward()
                    report[g].append(pen.detach())

        # gradients: PRE and POST summed over pipe, all over data and
        # seq
        def grad_of(g, path):
            t = tree.get(live[g], path)
            return torch.zeros_like(t) if t.grad is None else t.grad

        shared = [p for p, _ in layer_leaves(pipe_layers, params)]
        pre = set(plan.pre_layers)
        by_stage = {g: [None if p[0] in pre and g != 0 else grad_of(g, p)
                        for p in shared] for g in tr.local_stages}
        summed = tr.sum_over_pipe(by_stage,
                                  [tree.get(params, p) for p in shared])
        grads = list(zip(shared, summed))
        for g in tr.local_stages:
            grads += [(p, grad_of(g, p)) for p, _ in layer_leaves(
                plan.group_layers[g], params)]
        if dgroup is not None:
            reduced = _all_reduce_sum([x for _, x in grads], dgroup)
            grads = [(p, x) for (p, _), x in zip(grads, reduced)]
        gtree = tree.from_leaves(grads)
        for layer in params:
            gtree.setdefault(layer, {})
        updates, opt_state = tx.update(gtree, opt_state, params)
        apply_updates(params, updates)

        # layer state: each stage's to every rank, means over data (and
        # POST's over pipe: each rank ran other microbatches)
        new_state = dict(state)
        for g in tr.local_stages:
            new_state.update(cur[g])
        new_state.update(pre_state)
        post_mean = tr.mean_over_pipe([post_state[g]
                                       for g in tr.local_stages])
        if plan.has_state or _has_float(pre_state):
            new_state = tr.share_stage_state(rt, new_state)
        new_state.update(post_mean)
        if dgroup is not None:
            new_state = pmean_float_leaves(new_state, dgroup, n_data)

        # the loss, summed over every stage's share in stage order
        parts = []
        for g in tr.local_stages:
            # a stage with no microbatch of its own (M < S) reports 0
            part_sum = (report[g][0] if report[g]
                        else torch.zeros((), device=toks.device))
            for x in report[g][1:]:
                part_sum = part_sum + x
            parts.append(part_sum)
        loss = tr.sum_scalars(parts)
        if dgroup is not None:
            loss = _all_reduce_sum([loss.reshape(1)], dgroup)[0][0]
        return params, opt_state, new_state, loss.detach(), {}

    return step


def _has_float(state):
    return any(t.is_floating_point() for _, t in tree.leaves(state))


def stage_ties(plan, params):
    """{leaf path: (its key in the JAX layout — the group-0 layer's name
    and the leaf's path in it —, its stage)} for every stage leaf: the
    leaves of one stacked [S] leaf, whose norm LAMB takes over all S
    stages (nn/updater.py `norm_ties`)."""
    out = {}
    for path, _ in tree.leaves(params):
        g = plan.stage_of.get(path[0])
        if g is not None:
            i = plan.group_layers[g].index(path[0])
            out[path] = ((plan.group_layers[0][i],) + path[1:], g)
    return out


def place_in_process(net, n_stages: int, n_microbatches=None,
                     seq_blocks=None):
    """Pipeline `net` over S = `n_stages` stages run in this process
    (`InProcessPipe`): `fit` and `fit_scanned` then take the GPipe step
    of M = `n_microbatches` (2·S by default) with the params whole.
    `seq_blocks`: the stages' attention runs the ring over that many
    blocks of each microbatch in this process (`InProcessRing`; a conf
    built with seq_parallel_axis). `set_mesh` (None or a mesh) ends it.
    Returns the net."""
    from deeplearning4j_tpu_torch.parallel.placement import configure_mesh

    configure_mesh(net, None)
    if not hasattr(net, "layer_vertices"):
        raise ValueError(
            "the 'pipe' axis requires the ComputationGraph container "
            "(stage partitioning runs on the DAG conf); wrap the "
            "layer stack in a graph via .graph_builder()")
    if net.params is None:
        net.init()
    check_pp_supported(net)
    seq_axis = None
    if seq_blocks:
        seq_axis = next((v.layer.seq_parallel_axis
                         for v in net.layer_vertices.values()
                         if getattr(v.layer, "seq_parallel_axis", "")),
                        None)
        if seq_axis is None:
            raise ValueError(
                "seq_blocks needs a sequence-parallel-ready conf: build "
                "the model with seq_parallel_axis set")
    plan = PipelinePlan(net, n_stages)
    M = 2 * plan.S if n_microbatches is None else int(n_microbatches)
    net._pipe = PipeRuntime(plan, InProcessPipe(plan.S), M,
                            seq_axis=seq_axis, seq_blocks=seq_blocks or 1)
    net.tx.norm_ties = stage_ties(plan, net.params) if plan.S > 1 else {}
    net._train_step = None
    return net
