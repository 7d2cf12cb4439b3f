"""Training step assembly (JAX counterpart deeplearning4j_tpu/nn/training.py).

The reference's inner optimization block (computeGradientAndScore ->
updater -> stepFunction.step) as one eager PyTorch step: loss, autograd
backward, gradient normalization, the optimizer's update, the step
counter. The JAX package jits it into one donated XLA computation; here
the kernels run as PyTorch launches them, and the parameters and
optimizer moments are updated in place (no second copy, which is what
the JAX package's buffer donation buys).

`fused_fit` is the engine behind `fit_scanned`: the JAX package scans
the whole epoch in one dispatch; the port runs the same sequence of
steps as a plain loop and reads no loss back to the host until the end.
Like the JAX package's it refuses what only `fit()` runs (pretraining,
the Solver path, TBPTT, iterations > 1).

Data parallelism (`make_train_step(..., mesh=...)`, one process per
device, parallel/mesh.py): each rank steps on its rows of the global
batch. The monolithic arm runs the forward as an `ops.shard_scope`
data shard, so batch statistics and the masked loss's count are global
(the JAX package's GSPMD step equals one device over the global batch),
and mean-reduces every gradient in one all-reduce after the backward.
The overlap arm (`overlap=BucketPlan`) is the JAX package's per-shard
step: local loss and statistics, the gradients mean-reduced bucket by
bucket from gradient hooks while the backward runs
(parallel/overlap.BucketReducer), the loss and the float layer state
mean-reduced after.

ZeRO-1 (`Zero1`, `set_mesh(..., zero1=True)`; arXiv:2004.13336 as the
JAX package's `zero1_opt_shardings`): an optimizer-state leaf whose
leading dim is at least the data axis's size n and divisible by it is
split over the axis, each rank keeping 1/n of its rows. The monolithic
arm then reduce-scatters those leaves' gradients (one flat collective),
updates its rows of each with its rows of the state, and all-gathers the
new params; the overlap arm takes its rows of the bucket-reduced
gradients. The other leaves are all-reduced and updated whole, as
before. Tensor and expert parallelism need nothing here: the split
layers run their collectives themselves (ops/shard_scope.py), and the
norms of split leaves sum over their groups (nn/updater.py). A
pipelined net takes its own step (parallel/pipeline.make_pp_train_step).

Telemetry (telemetry/costbook.py, telemetry/memstat.py): `fit` counts
the first step of each batch shape into the net's cost book (entry
"fit"), `fused_fit` its first step for the whole dispatch (entry
"fit_scanned", shape [epochs, n_batches]); both are no-ops under a
NullRecorder. `fit` samples memory at batch boundaries at the
`DL4J_TPU_MEM_EVERY` cadence, and `fused_fit` once after the dispatch
when that cadence is on.
"""

from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from deeplearning4j_tpu_torch.nn import tree
from deeplearning4j_tpu_torch.nn.conf.enums import (
    BackpropType,
    OptimizationAlgorithm,
)
from deeplearning4j_tpu_torch.nn.conf.layers import BaseRecurrentLayer
from deeplearning4j_tpu_torch.nn.updater import (
    apply_updates,
    build_optimizer,
    normalize_gradients,
)


def batch_shape(batch) -> list:
    """The shape key of a step's batch dict: every tensor's shape, in
    sorted key order ([] for an absent mask)."""
    out = []
    for _k, v in sorted(batch.items()):
        for t in (v if isinstance(v, (tuple, list)) else (v,)):
            out.append([] if t is None else list(t.shape))
    return out


def fit_telemetry(net):
    """(cost book, memory sampler) of one fit() call: the net's own,
    rebuilt when the process recorder changed (a test installing its
    own)."""
    from deeplearning4j_tpu_torch.telemetry import get_default
    from deeplearning4j_tpu_torch.telemetry.costbook import CostBook
    from deeplearning4j_tpu_torch.telemetry.memstat import sampler_for_net

    rec = get_default()
    book = getattr(net, "_cost_book", None)
    if book is None or book.recorder is not rec:
        book = net._cost_book = CostBook(rec)
    return book, sampler_for_net(net, rec)


def is_tbptt(conf) -> bool:
    return str(conf.backprop_type) in (str(BackpropType.TRUNCATED_BPTT),
                                       "truncated_bptt")


def is_sgd(conf) -> bool:
    return str(conf.conf.optimization_algo) == str(
        OptimizationAlgorithm.STOCHASTIC_GRADIENT_DESCENT)


class LazyScore:
    """`score_value` of a container: the last training score, kept as the
    device scalar a step leaves and converted to a float on first read
    (converting it at once would synchronize with the card every
    step); and the bookkeeping after a `fit` step."""

    @property
    def score_value(self):
        v = self._score_raw
        if not isinstance(v, float):
            v = float(v)
            self._score_raw = v
        return v

    @score_value.setter
    def score_value(self, v):
        self._score_raw = v

    def _after_step(self, loss):
        """A `fit` step's bookkeeping: the score, the iteration count,
        the listeners."""
        self.score_value = loss
        self.iteration_count += 1
        for lst in self.listeners:
            lst.iteration_done(self, self.iteration_count)


def streams(lc, impl) -> bool:
    """Whether a layer is recurrent and can carry its state across calls
    (the bidirectional LSTM and self-attention cannot)."""
    return isinstance(lc, BaseRecurrentLayer) and hasattr(impl,
                                                          "initial_carry")


def refuse_unstreamable(layers):
    """rnn_time_step's check over (name, layer conf, impl) triples."""
    for name, lc, impl in layers:
        if isinstance(lc, BaseRecurrentLayer) and not streams(lc, impl):
            raise ValueError(
                f"rnn_time_step: layer '{name}' ({type(lc).__name__}) "
                "cannot stream causally — it needs the full sequence "
                "(reference throws UnsupportedOperationException)")


def pretrain_layer(net, it, epochs, name, lc, impl, featurize):
    """Greedy pretraining of one layer (AutoEncoder, RBM) of `net`: its
    `pretrain_loss` over `featurize(ds)` (the activations feeding it,
    computed without grad) for each DataSet of `it`, `epochs` times, one
    step a batch with an optimizer of its own; the layer's params are
    updated in place."""
    tx = build_optimizer(net.conf.conf, {name: lc})
    p = {name: net.params[name]}
    opt = tx.init(p)
    step = make_train_step(
        lambda q, s, gen, x: (impl.pretrain_loss(lc, q[name], x, gen),
                              (s, {})), tx, {})
    for _ in range(epochs):
        it.reset()
        for ds in it:
            with torch.no_grad():
                x = featurize(ds)
            p, opt, _, loss, _ = step(p, opt, {}, net._generator, x)
            net.score_value = loss


def remat_apply(fn, generator):
    """`fn(generator)` with the activations inside it recomputed in the
    backward instead of kept (torch.utils.checkpoint, non-reentrant):
    the `remat` option of both containers, per layer or vertex.

    The recompute must draw the same dropout masks and flash step seeds
    as the forward did, or the gradients are silently wrong; the
    checkpoint restores only the global RNG. So `fn` draws from a
    private generator set to `generator`'s state on entry, each time it
    runs, and `generator` then moves on past those draws: the same
    draws, in the same order, as without remat."""
    if generator is None:
        return checkpoint(fn, None, use_reentrant=False,
                          preserve_rng_state=False)
    start = generator.get_state()
    end = []

    def body():
        g = torch.Generator(device=generator.device)
        g.set_state(start)
        out = fn(g)
        end.append(g.get_state())
        return out

    out = checkpoint(body, use_reentrant=False, preserve_rng_state=False)
    generator.set_state(end[0])
    return out


def detach_carries(carries):
    """RNN carries (a tensor or a tuple of them per layer) cut from the
    graph: TBPTT's gradients stop at a segment's boundary."""
    def cut(c):
        return (tuple(t.detach() for t in c) if isinstance(c, tuple)
                else c.detach())
    return {k: cut(c) for k, c in carries.items()}


def loss_and_grads(loss_fn, params, state, generator, batch,
                   reducer=None):
    """(loss, aux, grads) of `loss_fn(params, state, generator, batch) ->
    (loss, aux)` at `params`: the gradient of every floating leaf, zeros
    where the loss does not reach it, in the params' nest. With a
    `reducer` (parallel/overlap.BucketReducer) the gradients come back
    reduced over its group, bucket by bucket as the backward makes
    them."""
    keys = [path for path, t in tree.leaves(params) if t.is_floating_point()]
    live = tree.tree_map(lambda t: t, params)
    for path in keys:
        tree.put(live, path, tree.get(params, path).detach().requires_grad_())
    if reducer is not None:
        reducer.attach(keys, [tree.get(live, k) for k in keys])
    with torch.enable_grad():
        loss, aux = loss_fn(live, state, generator, batch)
        found = torch.autograd.grad(
            loss, [tree.get(live, k) for k in keys], allow_unused=True)
    if reducer is not None:
        found = reducer.finish(found)
    grads = tree.from_leaves(
        (k, torch.zeros_like(tree.get(params, k)) if g is None else g)
        for k, g in zip(keys, found))
    for layer in params:  # a layer without params keeps its {} entry
        grads.setdefault(layer, {})
    return loss, aux, grads


def zero1_opt_shardings(params, mesh, axis: str = "data"):
    """The leaves ZeRO-1 splits over `axis` (the JAX package's rule on
    the optimizer state, whose leaves mirror the params): the paths of
    the floating leaves whose leading dim is at least the axis's size
    and divisible by it; every other leaf stays whole."""
    n = mesh.axis_size(axis)
    return [path for path, t in tree.leaves(params)
            if t.is_floating_point() and t.ndim >= 1
            and t.shape[0] >= n and t.shape[0] % n == 0]


class Zero1:
    """A ZeRO-1 split of a net's optimizer state over the data axis
    `axis` of `mesh` (module docstring): `paths` the split leaves, each
    rank holding rows [index * s0/n, (index + 1) * s0/n) of their
    moments."""

    def __init__(self, params, mesh, axis: str = "data"):
        self.axis = axis
        self.group = mesh.group(axis)
        self.n = mesh.axis_size(axis)
        self.index = mesh.axis_index(axis)
        self.paths = zero1_opt_shardings(params, mesh, axis)
        self._split = set(self.paths)

    def rows(self, t):
        w = t.shape[0] // self.n
        return t[self.index * w:(self.index + 1) * w]

    def groups(self):
        """{leaf path: the data group}: LAMB's and the gradient
        normalizations' norms of a split leaf sum over it."""
        return {path: self.group for path in self.paths}

    def reduce(self, grads):
        """The mean gradients over the data group: this rank's rows of
        each split leaf (one reduce-scatter of them all, laid out rank by
        rank), the other leaves whole (one all-reduce)."""
        from deeplearning4j_tpu_torch.parallel.overlap import (
            reduce_gradients,
            reduce_scatter,
        )

        whole = {p: g for p, g in tree.leaves(grads)
                 if p not in self._split and g.is_floating_point()}
        out = reduce_gradients(tree.from_leaves(whole.items()),
                               [(self.group, self.n)]) if whole else {}
        gs = [tree.get(grads, p) for p in self.paths]
        if gs:
            cols = [g.reshape(self.n, -1).to(torch.float32) for g in gs]
            flat = torch.cat(cols, dim=1).reshape(-1)
            mine = flat.new_empty(flat.numel() // self.n)
            reduce_scatter(mine, flat, self.group)
            mine = mine / self.n
            off = 0
            for p, g, c in zip(self.paths, gs, cols):
                w = c.shape[1]
                rows = (g.shape[0] // self.n,) + tuple(g.shape[1:])
                tree.put(out, p, mine[off:off + w].reshape(rows).to(g.dtype))
                off += w
        for layer in grads:
            out.setdefault(layer, {})
        return out

    def local_grads(self, grads):
        """This rank's rows of already reduced gradients (the overlap
        arm's)."""
        out = tree.tree_map(lambda t: t, grads)
        for p in self.paths:
            tree.put(out, p, self.rows(tree.get(grads, p)))
        return out

    def views(self, params):
        """`params` with each split leaf replaced by the view of this
        rank's rows (an update of the view writes the param)."""
        out = tree.tree_map(lambda t: t, params)
        for p in self.paths:
            tree.put(out, p, self.rows(tree.get(params, p)))
        return out

    @torch.no_grad()
    def gather_params(self, params):
        """All-gather every split leaf's updated rows into the whole
        param, in place (one collective)."""
        from deeplearning4j_tpu_torch.parallel.overlap import all_gather

        if not self.paths:
            return
        ps = [tree.get(params, p) for p in self.paths]
        mine = torch.cat([self.rows(t).reshape(-1) for t in ps])
        every = mine.new_empty(mine.numel() * self.n)
        all_gather(every, mine, self.group)
        every = every.reshape(self.n, -1)
        off = 0
        for t in ps:
            w = t.numel() // self.n
            t.copy_(every[:, off:off + w].reshape(t.shape))
            off += w


def make_train_step(loss_fn, tx, layer_confs_by_name, mesh=None,
                    data_axis="data", overlap=None, zero1=None):
    """loss_fn(params, state, generator, batch) -> (loss, (new_state,
    extras)).

    Returns step(params, opt_state, state, generator, batch) -> (params,
    opt_state, state, loss, extras): params and opt_state are the same
    dicts, updated in place; loss is a detached device scalar (no host
    sync).

    mesh: a parallel/mesh.Mesh with `data_axis` — batch holds this
    rank's rows and the step is the data-parallel one (module
    docstring); overlap: a parallel/overlap.BucketPlan for the bucketed
    arm (which does not thread TBPTT carries: extras is empty); zero1: a
    `Zero1` split of the optimizer state over the data axis."""
    groups = getattr(tx, "split_groups", None)

    def update(params, opt_state, grads):
        grads = normalize_gradients(grads, layer_confs_by_name, groups)
        updates, opt_state = tx.update(grads, opt_state, params)
        apply_updates(params, updates)
        return opt_state

    def update_rows(params, opt_state, grads):
        # ZeRO-1: this rank's rows of the split leaves, then the
        # all-gather of the new params
        opt_state = update(zero1.views(params), opt_state, grads)
        zero1.gather_params(params)
        return opt_state

    def split(aux):
        return aux if isinstance(aux, tuple) else (aux, {})

    if mesh is None or data_axis not in mesh.shape:
        if overlap is not None or zero1 is not None:
            raise ValueError("overlap=BucketPlan and zero1 require a mesh "
                             f"with the data axis {data_axis!r}")

        def step(params, opt_state, state, generator, batch):
            loss, aux, grads = loss_and_grads(loss_fn, params, state,
                                              generator, batch)
            new_state, extras = split(aux)
            opt_state = update(params, opt_state, grads)
            return params, opt_state, new_state, loss.detach(), extras

        return step

    from deeplearning4j_tpu_torch.parallel.overlap import (
        BucketReducer,
        pmean_float_leaves,
        reduce_gradients,
    )
    from deeplearning4j_tpu_torch.ops.shard_scope import (
        DataShard,
        shard_generator,
        sharded,
    )

    group, n = mesh.group(data_axis), mesh.axis_size(data_axis)
    index = mesh.axis_index(data_axis)

    def mean(t):
        return reduce_gradients({"t": t}, [(group, n)])["t"]

    if overlap is None:
        shard = DataShard(group, n, index)

        def step(params, opt_state, state, generator, batch):
            with sharded(data=shard):
                loss, aux, grads = loss_and_grads(loss_fn, params, state,
                                                  generator, batch)
            new_state, extras = split(aux)
            if zero1 is None:
                grads = reduce_gradients(grads, [(group, n)])
                opt_state = update(params, opt_state, grads)
            else:
                opt_state = update_rows(params, opt_state,
                                        zero1.reduce(grads))
            return params, opt_state, new_state, mean(loss.detach()), extras

        return step

    reducer = BucketReducer(overlap, group, n)

    def step(params, opt_state, state, generator, batch):
        # each replica its own dropout stream (the JAX step folds the
        # data-axis index into its key)
        gen = shard_generator(generator, (index,), n)
        loss, aux, grads = loss_and_grads(loss_fn, params, state, gen,
                                          batch, reducer=reducer)
        new_state, _extras = split(aux)
        new_state = pmean_float_leaves(new_state, group, n)
        if zero1 is None:
            opt_state = update(params, opt_state, grads)
        else:
            opt_state = update_rows(params, opt_state,
                                    zero1.local_grads(grads))
        return params, opt_state, new_state, mean(loss.detach()), {}

    return step


def fused_fit(net, batches, epochs):
    """The `fit_scanned` engine of both containers: raises for what only
    `fit()` runs, checks that every batch has one structure and shape,
    runs the steps, and updates the iteration/epoch counters and
    listeners per epoch with that epoch's mean score."""
    conf = net.conf
    g = conf.conf
    if conf.pretrain:
        raise ValueError("fit_scanned does not support layerwise "
                         "pretraining — call pretrain()/fit() first")
    if not conf.backprop:
        raise ValueError("fit_scanned needs backprop=True")
    if not is_sgd(conf):
        raise ValueError(
            f"fit_scanned supports SGD-family training only; "
            f"{g.optimization_algo!r} routes through the Solver path — "
            "use fit()")
    if is_tbptt(conf):
        raise ValueError("fit_scanned does not implement TBPTT — use fit()")
    if getattr(net.conf.conf, "iterations", 1) > 1:
        raise ValueError("fit_scanned runs one optimizer pass per batch; "
                         "iterations>1 needs fit()")
    if not batches:
        return net

    def shapes(v):  # a tensor (MultiLayerNetwork) or a tuple (graph)
        if isinstance(v, torch.Tensor):
            return tuple(v.shape)
        return tuple(None if t is None else tuple(t.shape) for t in v)

    def layout(b):
        return tuple((k, shapes(v)) for k, v in sorted(b.items()))

    if len({layout(b) for b in batches}) > 1:
        raise ValueError(
            "fit_scanned needs uniform batch shapes — drop or pad the "
            "ragged tail batch, or use fit()")
    step = net._get_train_step()
    book, mem = fit_telemetry(net)
    losses = []
    # the first step is counted for the dispatch: every step has its shape
    count = book.count("fit_scanned", [int(epochs), len(batches)],
                       device=net.device, args=(batches[0],),
                       scale=int(epochs) * len(batches))
    with count:
        net.params, net.opt_state, net.state, loss, _ = step(
            net.params, net.opt_state, net.state, net._generator,
            batches[0])
    losses.append(loss)
    for e in range(epochs):
        for batch in batches[1 if e == 0 else 0:]:
            net.params, net.opt_state, net.state, loss, _ = step(
                net.params, net.opt_state, net.state, net._generator, batch)
            losses.append(loss)
    losses = torch.stack(losses).reshape(epochs, len(batches))
    per_epoch = losses.mean(dim=1)
    nb = len(batches)
    if net.listeners:
        for e in range(epochs):
            net.iteration_count += nb
            net.score_value = per_epoch[e]
            for lst in net.listeners:
                lst.iteration_done(net, net.iteration_count)
    else:
        net.iteration_count += epochs * nb
    net.score_value = losses[-1, -1]
    net._epoch_losses = per_epoch
    net._step_losses = losses
    # the whole dispatch is one batch boundary: one memory event when
    # the env cadence is on
    if mem.mem_every > 0:
        mem.sample("fit", iteration=net.iteration_count)
    return net


def fit_steps(net, batch_for_step, total_steps, *, on_step=None):
    """Global-step training loop: progress is one continuous step counter
    (``net.iteration_count``), and ``batch_for_step(step)`` (1-based)
    gives the DataSet of that step, so a run resumed at its counter
    optimizes the same sequence as an uninterrupted one.
    ``on_step(step)`` fires after each completed step (where
    `distributed/elastic.py` hangs its checkpoint cadence and the fault
    harness its kill/hang triggers). Emits one telemetry ``step`` event
    per step (no host sync: the device score is not read here)."""
    from deeplearning4j_tpu_torch.telemetry import get_default

    rec = get_default()
    while net.iteration_count < total_steps:
        step = net.iteration_count + 1
        net.fit(batch_for_step(step))
        if net.iteration_count != step:
            raise ValueError(
                f"batch_for_step({step}) yielded "
                f"{net.iteration_count - step + 1} optimizer passes — "
                "fit_steps needs exactly one DataSet per step (check "
                "`iterations` in the net config)")
        rec.step(step)
        if on_step is not None:
            on_step(step)
    return net


def tree_cast(tree, dtype):
    """Every floating tensor of a {layer: {name: tensor}} (or flat
    {name: tensor}) dict cast to `dtype`."""
    return {k: (tree_cast(v, dtype) if isinstance(v, dict)
                else v.to(dtype) if v.is_floating_point() else v)
            for k, v in tree.items()}
