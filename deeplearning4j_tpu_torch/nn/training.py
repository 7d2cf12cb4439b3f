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
the Solver path, TBPTT, iterations > 1). Meshes, ZeRO-1, bucketed
overlap and pipelining come with the parallel slice.
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


def loss_and_grads(loss_fn, params, state, generator, batch):
    """(loss, aux, grads) of `loss_fn(params, state, generator, batch) ->
    (loss, aux)` at `params`: the gradient of every floating leaf, zeros
    where the loss does not reach it, in the params' nest."""
    keys = [path for path, t in tree.leaves(params) if t.is_floating_point()]
    live = tree.tree_map(lambda t: t, params)
    for path in keys:
        tree.put(live, path, tree.get(params, path).detach().requires_grad_())
    with torch.enable_grad():
        loss, aux = loss_fn(live, state, generator, batch)
        found = torch.autograd.grad(
            loss, [tree.get(live, k) for k in keys], allow_unused=True)
    grads = tree.from_leaves(
        (k, torch.zeros_like(tree.get(params, k)) if g is None else g)
        for k, g in zip(keys, found))
    for layer in params:  # a layer without params keeps its {} entry
        grads.setdefault(layer, {})
    return loss, aux, grads


def make_train_step(loss_fn, tx, layer_confs_by_name):
    """loss_fn(params, state, generator, batch) -> (loss, (new_state,
    extras)).

    Returns step(params, opt_state, state, generator, batch) -> (params,
    opt_state, state, loss, extras): params and opt_state are the same
    dicts, updated in place; loss is a detached device scalar (no host
    sync)."""

    def step(params, opt_state, state, generator, batch):
        loss, aux, grads = loss_and_grads(loss_fn, params, state, generator,
                                          batch)
        new_state, extras = aux if isinstance(aux, tuple) else (aux, {})
        grads = normalize_gradients(grads, layer_confs_by_name)
        updates, opt_state = tx.update(grads, opt_state, params)
        apply_updates(params, updates)
        return params, opt_state, new_state, loss.detach(), extras

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
    losses = []
    for _ in range(epochs):
        for batch in batches:
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
    return net


def fit_steps(net, batch_for_step, total_steps, *, on_step=None):
    """Global-step training loop: progress is one continuous step counter
    (``net.iteration_count``), and ``batch_for_step(step)`` (1-based)
    gives the DataSet of that step, so a run resumed at its counter
    optimizes the same sequence as an uninterrupted one.
    ``on_step(step)`` fires after each completed step."""
    while net.iteration_count < total_steps:
        step = net.iteration_count + 1
        net.fit(batch_for_step(step))
        if net.iteration_count != step:
            raise ValueError(
                f"batch_for_step({step}) yielded "
                f"{net.iteration_count - step + 1} optimizer passes — "
                "fit_steps needs exactly one DataSet per step (check "
                "`iterations` in the net config)")
        if on_step is not None:
            on_step(step)
    return net


def tree_cast(tree, dtype):
    """Every floating tensor of a {layer: {name: tensor}} (or flat
    {name: tensor}) dict cast to `dtype`."""
    return {k: (tree_cast(v, dtype) if isinstance(v, dict)
                else v.to(dtype) if v.is_floating_point() else v)
            for k, v in tree.items()}
