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
Meshes, ZeRO-1, bucketed overlap and pipelining come with the parallel
slice.
"""

from __future__ import annotations

import torch

from deeplearning4j_tpu_torch.nn.conf.enums import (
    BackpropType,
    OptimizationAlgorithm,
)
from deeplearning4j_tpu_torch.nn.updater import (
    apply_updates,
    normalize_gradients,
)


class LazyScore:
    """`score_value` of a container: the last training score, kept as the
    device scalar a step leaves and converted to a float on first read
    (converting it at once would synchronize with the card every
    step)."""

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


def check_trainable(conf):
    """Raise NotImplementedError for what the port does not train yet,
    given a container's configuration (a MultiLayerConfiguration or a
    ComputationGraphConfiguration): layerwise pretraining, the Solver
    path, truncated BPTT and remat (ROADMAP Queue A item A6)."""
    g = conf.conf
    if conf.pretrain:
        raise NotImplementedError(
            "layerwise pretraining is not ported yet (ROADMAP Queue A item "
            "A6, with the pretrain layers)")
    if str(g.optimization_algo) != str(
            OptimizationAlgorithm.STOCHASTIC_GRADIENT_DESCENT):
        raise NotImplementedError(
            f"optimization algorithm {g.optimization_algo!r} (the Solver "
            "path, optimize/solvers.py) is not ported yet (ROADMAP Queue A "
            "item A6); use stochastic gradient descent")
    if str(conf.backprop_type) in (str(BackpropType.TRUNCATED_BPTT),
                                   "truncated_bptt"):
        raise NotImplementedError(
            "truncated BPTT is not ported yet (ROADMAP Queue A item A6, with "
            "the recurrent layers)")
    if g.remat:
        raise NotImplementedError(
            "remat (recomputing activations in the backward) is not ported "
            "yet (ROADMAP Queue A item A6)")


def make_train_step(loss_fn, tx, layer_confs_by_name):
    """loss_fn(params, state, generator, batch) -> (loss, (new_state,
    extras)).

    Returns step(params, opt_state, state, generator, batch) -> (params,
    opt_state, state, loss, extras): params and opt_state are the same
    dicts, updated in place; loss is a detached device scalar (no host
    sync)."""

    def step(params, opt_state, state, generator, batch):
        keys = [(layer, n) for layer in params for n, t in params[layer].items()
                if t.is_floating_point()]
        leaves = {layer: dict(p) for layer, p in params.items()}
        for layer, n in keys:
            leaves[layer][n] = params[layer][n].detach().requires_grad_()
        with torch.enable_grad():
            loss, aux = loss_fn(leaves, state, generator, batch)
            found = torch.autograd.grad(
                loss, [leaves[layer][n] for layer, n in keys],
                allow_unused=True)
        new_state, extras = aux if isinstance(aux, tuple) else (aux, {})
        grads = {layer: {} for layer in params}
        for (layer, n), g in zip(keys, found):
            grads[layer][n] = (torch.zeros_like(params[layer][n])
                               if g is None else g)
        grads = normalize_gradients(grads, layer_confs_by_name)
        updates, opt_state = tx.update(grads, opt_state, params)
        apply_updates(params, updates)
        return params, opt_state, new_state, loss.detach(), extras

    return step


def fused_fit(net, batches, epochs):
    """The `fit_scanned` engine of both containers: raises for what the
    port does not train (`check_trainable`) and for what only `fit()`
    runs, checks that every batch has one structure and shape, runs the
    steps, and updates the iteration/epoch counters and listeners per
    epoch with that epoch's mean score."""
    check_trainable(net.conf)
    if not net.conf.backprop:
        raise ValueError("fit_scanned needs backprop=True")
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
