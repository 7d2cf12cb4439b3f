"""Updaters — SGD-family update rules as functional updates over tensors
(JAX counterpart deeplearning4j_tpu/nn/updater.py; reference
nn/updater/*: SgdUpdater, NesterovsUpdater, AdamUpdater,
AdaGradUpdater, RmsPropUpdater, AdaDeltaUpdater, NoOpUpdater; learning
rate policies and gradient normalization in BaseUpdater).

The JAX package builds each rule as an optax GradientTransformation;
each `_Rule` here reproduces optax's formula for it step for step,
including where eps sits and how the accumulators start (optax
`adagrad` starts its sum of squares at 0.1 and puts eps inside the
root; its `rmsprop` keeps eps inside the root, unlike
`torch.optim.RMSprop`). No `torch.optim` class is used.

An optimizer has optax's shape: `init(params) -> state`, then
`update(grads, state, params) -> (updates, state)` and
`apply_updates(params, updates)`. Params and grads are nested dicts
keyed by layer name (nn/tree.py), a leaf per tensor. The port updates
in place: the moment tensors of `state` and, in `apply_updates`, the
param tensors, so one step allocates no second copy of either.

Per-layer overrides (a layer's own updater or learning rate) give the
layer its own rule and state, as optax.multi_transform does keyed on
the layer name (reference MultiLayerUpdater). Left out: the JAX
package's flat-view transform (`FlatViewTransform`, one fused update
over the concatenated f32 params), which exists to cut the TPU's per-leaf
fusion count; its state layout is read all the same, with optax's leaf
order of every rule (`OPTAX_LEAVES`), when a JAX zip's updater is mapped
into the port's (weights_io.py `opt_state_from_jax`). `set_optimizer`
gives a net a custom rule (reference Updater.CUSTOM). LION and LAMB take
optax's defaults (`optax.lion`: b1 0.9, b2 0.99, weight decay 1e-3;
`optax.lamb`: b1 0.9, b2 0.999, eps 1e-6, weight decay 0, the trust
ratio per leaf and 1 where either norm is 0).
"""

from __future__ import annotations

import math
from collections import defaultdict

import numpy as np
import torch

from deeplearning4j_tpu_torch.nn import tree
from deeplearning4j_tpu_torch.nn.conf.enums import (
    GradientNormalization,
    LearningRatePolicy,
    Updater,
)


def _cosine(base, steps, step):
    """optax.cosine_decay_schedule(base, steps) at `step` (alpha 0)."""
    t = min(step, steps)
    return base * 0.5 * (1.0 + math.cos(math.pi * t / steps))


def make_schedule(conf, layer_lr=None):
    """Learning-rate schedule per the reference's LearningRatePolicy:
    step (int, 0-based) -> lr."""
    base = layer_lr if layer_lr is not None else conf.learning_rate
    policy = conf.lr_policy
    rate, power = conf.lr_policy_decay_rate, conf.lr_policy_power
    if conf.lr_schedule:
        # explicit {iteration: lr} map (reference learningRateSchedule)
        pairs = sorted((int(k), float(v)) for k, v in conf.lr_schedule.items())

        def sched(step):
            lr = base
            for it, v in pairs:
                if step >= it:
                    lr = v
            return lr

        return sched
    if policy in (LearningRatePolicy.NONE, "none", None):
        return lambda step: base
    if policy == LearningRatePolicy.EXPONENTIAL:
        return lambda step: base * rate ** step
    if policy == LearningRatePolicy.INVERSE:
        return lambda step: base / (1.0 + rate * step) ** power
    if policy == LearningRatePolicy.POLY:
        steps = max(conf.decay_steps, 1)
        return lambda step: base * max(0.0, 1.0 - step / steps) ** power
    if policy == LearningRatePolicy.SIGMOID:
        return lambda step: base / (
            1.0 + math.exp(-rate * (step - conf.lr_policy_steps)))
    if policy == LearningRatePolicy.STEP:
        return lambda step: base * rate ** math.floor(
            step / conf.lr_policy_steps)
    if policy == LearningRatePolicy.TORCH_STEP:
        return lambda step: base * rate ** math.floor(
            step / max(conf.lr_policy_steps, 1.0))
    if policy == LearningRatePolicy.COSINE:
        steps = max(conf.decay_steps, 1)
        return lambda step: _cosine(base, steps, step)
    if policy == LearningRatePolicy.WARMUP_COSINE:
        # optax.warmup_cosine_decay_schedule(0.0, base, warmup, steps):
        # linear 0 -> base over the warmup, then cosine to 0 over the rest
        steps = max(conf.decay_steps, 1)
        warmup = max(conf.warmup_steps, 1)

        def sched(step):
            if step < warmup:
                return base * step / warmup
            return _cosine(base, steps - warmup, step - warmup)

        return sched
    raise ValueError(f"Unknown lr policy {policy}")


def _bias_correction(decay, count):
    """1 - decay**count in float32, as optax computes it: at decay 0.999
    the float32 rounding of decay moves 1 - decay by 1.3e-5 relative,
    which Adam's second moment sees."""
    return float(np.float32(1.0) - np.power(np.float32(decay),
                                            np.float32(count)))


def _sq_sum(items):
    """The sum of squares over [(tensor, group)]: a tensor split over a
    process group (a tensor- or expert-parallel shard, a ZeRO-1 slice)
    adds its shards' squares summed over the group, one all-reduce a
    group; a whole tensor (group None) adds its own once."""
    import torch.distributed as dist

    total = None
    by_group = {}
    for t, group in items:
        sq = (t.float() ** 2).sum()
        if group is None:
            total = sq if total is None else total + sq
        else:
            key = id(group)
            prev = by_group.get(key, (group, None))[1]
            by_group[key] = (group, sq if prev is None else prev + sq)
    for group, sq in by_group.values():
        sq = sq.clone()
        dist.all_reduce(sq, group=group)
        total = sq if total is None else total + sq
    return torch.zeros(()) if total is None else total


def _tied_norms(params, us, ties):
    """{index: (|p|, |u|)} of the tensors that `ties` (one entry a
    tensor: None, or (key, stage)) ties to others of the same key: the
    norms over all of them, their squares summed in stage order (the
    stage leaves of one stacked leaf of the JAX layout, run in one
    process by the in-process pipeline)."""
    if not ties or not any(ties):
        return {}
    members = defaultdict(list)
    for i, tie in enumerate(ties):
        if tie is not None:
            members[tie[0]].append((tie[1], i))
    out = {}
    for group in members.values():
        group.sort()
        pn = un = None
        for _, i in group:
            ps = (params[i].float() ** 2).sum()
            uq = (us[i].float() ** 2).sum()
            pn = ps if pn is None else pn + ps
            un = uq if un is None else un + uq
        for _, i in group:
            out[i] = (torch.sqrt(pn), torch.sqrt(un))
    return out


class _Rule:
    """One update rule over a list of f32 tensors: optax's transform for
    it followed by its scale by the (scheduled) negative learning
    rate. `groups` (one per tensor, None for a whole one) are the process
    groups a tensor is split over, which LAMB's norms sum over; `ties`
    (one per tensor, None or (key, stage)) the tensors of one process
    whose norms LAMB takes together."""

    def __init__(self, kind, conf, schedule):
        self.kind = kind
        self.conf = conf
        self.schedule = schedule

    def init(self, params):
        zeros = lambda: [torch.zeros_like(p) for p in params]  # noqa: E731
        state = {"count": 0}
        if self.kind == Updater.NESTEROVS:
            state["trace"] = zeros()
        elif self.kind in (Updater.ADAM, Updater.ADAMW, Updater.LAMB):
            state["mu"], state["nu"] = zeros(), zeros()
        elif self.kind == Updater.LION:
            state["mu"] = zeros()
        elif self.kind == Updater.ADAGRAD:
            state["sum_of_squares"] = [torch.full_like(p, 0.1)
                                       for p in params]
        elif self.kind == Updater.RMSPROP:
            state["nu"] = zeros()
        elif self.kind == Updater.ADADELTA:
            state["e_g"], state["e_x"] = zeros(), zeros()
        return state

    def update(self, grads, state, params, groups=None, ties=None):
        c = self.conf
        groups = groups or [None] * len(grads)
        count = state["count"]
        lr = self.schedule(count)
        k = self.kind
        if k in (Updater.SGD, Updater.NONE):
            ups = [g * -lr for g in grads]
        elif k == Updater.NESTEROVS:
            m = c.momentum
            ups = []
            for g, t in zip(grads, state["trace"]):
                t.mul_(m).add_(g)                  # trace = g + m * trace
                ups.append((g + m * t) * -lr)
        elif k in (Updater.ADAM, Updater.ADAMW):
            b1, b2 = c.adam_mean_decay, c.adam_var_decay
            bc1 = _bias_correction(b1, count + 1)
            bc2 = _bias_correction(b2, count + 1)
            ups = []
            for g, mu, nu, p in zip(grads, state["mu"], state["nu"], params):
                mu.mul_(b1).add_(g, alpha=1.0 - b1)
                nu.mul_(b2).addcmul_(g, g, value=1.0 - b2)
                u = (mu / bc1) / ((nu / bc2).sqrt() + c.epsilon)
                if k == Updater.ADAMW:
                    u = u + (c.weight_decay or 1e-4) * p
                ups.append(u * -lr)
        elif k == Updater.LION:
            # optax.lion: sign of the b1-blend, then the b2 moment, then
            # weight decay 1e-3 on the params, all scaled by -lr
            b1, b2, wd = 0.9, 0.99, 1e-3
            ups = []
            for g, mu, p in zip(grads, state["mu"], params):
                u = torch.sign((1.0 - b1) * g + b1 * mu)
                mu.mul_(b2).add_(g, alpha=1.0 - b2)
                ups.append((u + wd * p) * -lr)
        elif k == Updater.LAMB:
            # optax.lamb: Adam's scaled moments (eps 1e-6, weight decay
            # 0), then each leaf's trust ratio |p| / |u| (1 where either
            # norm is 0), scaled by -lr
            b1, b2, eps = 0.9, 0.999, 1e-6
            bc1 = _bias_correction(b1, count + 1)
            bc2 = _bias_correction(b2, count + 1)
            us = []
            for g, mu, nu in zip(grads, state["mu"], state["nu"]):
                mu.mul_(b1).add_(g, alpha=1.0 - b1)
                nu.mul_(b2).addcmul_(g, g, value=1.0 - b2)
                us.append((mu / bc1) / ((nu / bc2).sqrt() + eps))
            tied = _tied_norms(params, us, ties)
            ups = []
            for i, (u, p, grp) in enumerate(zip(us, params, groups)):
                if i in tied:
                    pn, un = tied[i]
                elif grp is None:
                    pn = torch.linalg.vector_norm(p.float())
                    un = torch.linalg.vector_norm(u.float())
                else:
                    pn = torch.sqrt(_sq_sum([(p, grp)]))
                    un = torch.sqrt(_sq_sum([(u, grp)]))
                ratio = torch.where((pn == 0) | (un == 0),
                                    torch.ones_like(pn), pn / un)
                ups.append(u * ratio.to(u.dtype) * -lr)
        elif k == Updater.ADAGRAD:
            ups = []
            for g, s in zip(grads, state["sum_of_squares"]):
                s.addcmul_(g, g)
                inv = torch.where(s > 0, torch.rsqrt(s + c.epsilon),
                                  torch.zeros((), dtype=s.dtype,
                                              device=s.device))
                ups.append(inv * g * -lr)
        elif k == Updater.RMSPROP:
            d = c.rms_decay
            ups = []
            for g, nu in zip(grads, state["nu"]):
                nu.mul_(d).addcmul_(g, g, value=1.0 - d)
                ups.append(torch.rsqrt(nu + c.epsilon) * g * -lr)
        elif k == Updater.ADADELTA:
            rho, eps = c.rho, c.epsilon
            ups = []
            for g, e_g, e_x in zip(grads, state["e_g"], state["e_x"]):
                e_g.mul_(rho).addcmul_(g, g, value=1.0 - rho)
                u = torch.sqrt(e_x + eps) / torch.sqrt(e_g + eps) * g
                e_x.mul_(rho).addcmul_(u, u, value=1.0 - rho)
                ups.append(-u)                     # optax's fixed lr 1.0
        else:
            raise ValueError(f"no rule {k}")
        state["count"] = count + 1
        return ups


def _single_transform(conf, updater, lr_sched):
    u = updater or Updater.SGD
    u = u.value if hasattr(u, "value") else u
    try:
        kind = Updater(u)
    except ValueError:
        kind = None
    if kind is None or kind == Updater.CUSTOM:
        raise ValueError(f"Unknown updater '{u}'")
    return _Rule(kind, conf, lr_sched)


class Optimizer:
    """A rule per label, a label per layer (optax.multi_transform keyed
    on the layer name). state: {label: {"keys": [leaf path], "count",
    rule state: a tensor a key}}. `split_groups` {leaf path: process
    group} names the leaves a placement split (parallel/), whose norms
    sum over their group; `norm_ties` {leaf path: (key, stage)} the
    leaves of one process whose norms LAMB takes together (the stages
    of an in-process pipeline, parallel/pipeline.place_in_process)."""

    def __init__(self, rules, labels):
        self.rules = rules          # {label: _Rule}
        self.labels = labels        # {layer: label}
        self.split_groups = {}
        self.norm_ties = {}

    def _label(self, layer):
        return self.labels.get(layer, "__default__")

    def _groups(self, params):
        """[(label, [leaf path])] over a params-shaped dict, in a fixed
        order; a leaf's label is its layer's (the path's first key)."""
        groups = {}
        for path, _ in tree.leaves(params):
            groups.setdefault(self._label(path[0]), []).append(path)
        return sorted(groups.items())

    def init(self, params):
        state = {}
        for label, keys in self._groups(params):
            state[label] = self.rules[label].init(
                [tree.get(params, k) for k in keys])
            state[label]["keys"] = keys
        return state

    def update(self, grads, state, params):
        pairs = []
        for label, rule_state in state.items():
            keys = rule_state["keys"]
            ups = self.rules[label].update(
                [tree.get(grads, k) for k in keys], rule_state,
                [tree.get(params, k) for k in keys],
                [self.split_groups.get(tuple(k)) for k in keys],
                [self.norm_ties.get(tuple(k)) for k in keys])
            pairs.extend(zip(keys, ups))
        return tree.from_leaves(pairs), state


@torch.no_grad()
def apply_updates(params, updates):
    """params += updates, in place."""
    for path, u in tree.leaves(updates):
        p = tree.get(params, path)
        p.add_(u.to(p.dtype))
    return params


def named_layer_confs(net):
    """{layer_name: layer_conf} of a network container, either kind."""
    if hasattr(net, "layer_vertices"):
        return {n: v.layer for n, v in net.layer_vertices.items()}
    return dict(zip(net.layer_names, net.layer_confs))


def build_optimizer(conf, layer_confs):
    """The network optimizer. layer_confs: {layer_name: layer_conf}. A
    layer that overrides the updater or the learning rate gets its own
    rule (reference MultiLayerUpdater); the rest share the default."""
    rules = {"__default__": _single_transform(conf, conf.updater,
                                              make_schedule(conf))}
    labels = {}
    for name, lc in layer_confs.items():
        upd = getattr(lc, "updater", None)
        lr = getattr(lc, "learning_rate", None)
        if upd not in (None, conf.updater) or lr is not None:
            rules[name] = _single_transform(conf, upd or conf.updater,
                                            make_schedule(conf, layer_lr=lr))
            labels[name] = name
    return Optimizer(rules, labels)


# ------------------------------------------ the JAX package's updater state
# What a JAX zip's `updater.npz` holds: optax's state leaves as arr_0 ..
# arr_n, with no tree structure. optax flattens each rule's state in a
# fixed order (`optax.adam` is chain(scale_by_adam, scale_by_schedule):
# ScaleByAdamState(count, mu, nu), then the schedule's count), so the
# configuration alone gives the order. A name below is a leaf: "count" a
# scalar step counter, any other name a param-shaped tree (keys sorted,
# a leaf per param) that fills the port's state entry of that name.
OPTAX_LEAVES = {
    Updater.SGD: ("count",),
    Updater.NONE: ("count",),
    Updater.NESTEROVS: ("trace", "count"),
    Updater.ADAM: ("count", "mu", "nu", "count"),
    Updater.ADAMW: ("count", "mu", "nu", "count"),
    Updater.LAMB: ("count", "mu", "nu", "count"),
    Updater.LION: ("count", "mu", "count"),
    Updater.RMSPROP: ("nu", "count"),
    Updater.ADAGRAD: ("sum_of_squares", "count"),
    Updater.ADADELTA: ("e_g", "e_x"),     # optax's fixed lr: no counter
}

# The JAX package's flat view (`FlatViewTransform`): for an elementwise
# rule with no per-layer override, each param-shaped tree of the state is
# ONE f32 vector of total-param length, the leaves concatenated in sorted
# order. Layout 2 stores a lane-hostile leaf (2-D and up, last dim under
# 128) axis-rotated, last dim first; layout 1 (`flat_layout` 1 zips)
# stores every leaf row-major.
FLAT_OK = frozenset({Updater.SGD, Updater.NESTEROVS, Updater.ADAM,
                     Updater.ADAMW, Updater.ADADELTA, Updater.ADAGRAD,
                     Updater.RMSPROP, Updater.LION, Updater.NONE})


def lane_hostile(shape) -> bool:
    """Whether the flat view stores a leaf of `shape` axis-rotated."""
    return len(shape) >= 2 and shape[-1] < 128


def upgrade_flat_layout(vec: np.ndarray, shapes) -> np.ndarray:
    """A layout-1 flat vector (every leaf row-major) in layout 2, given
    the param shapes in flatten order."""
    outs, off = [], 0
    for shape in shapes:
        n = int(np.prod(shape, dtype=np.int64))
        seg = vec[off:off + n]
        if lane_hostile(shape):
            seg = np.moveaxis(seg.reshape(shape), -1, 0).ravel()
        outs.append(seg)
        off += n
    return np.concatenate(outs) if outs else vec[:0]


def unflatten_flat(vec: np.ndarray, shapes) -> list:
    """A layout-2 flat vector cut into one array a leaf (the JAX
    package's `_unflatten_into`)."""
    outs, off = [], 0
    for shape in shapes:
        shape = tuple(shape)
        n = int(np.prod(shape, dtype=np.int64))
        seg = vec[off:off + n]
        if lane_hostile(shape):
            rot = (shape[-1],) + shape[:-1]
            outs.append(np.moveaxis(seg.reshape(rot), 0, -1))
        else:
            outs.append(seg.reshape(shape))
        off += n
    return outs


class OptimizerPlacementError(ValueError):
    """A custom optimizer where a mesh placement holds the optimizer
    state in its own layout: the placement rebuilds only the port's
    `Optimizer` (its labels, split groups and norm ties)."""


def set_optimizer(net, tx) -> None:
    """The body of both containers' `set_optimizer` (reference
    Updater.CUSTOM; the JAX package takes an optax transform): `tx` is
    any object with the port's optimizer protocol, `init(params) ->
    state` and `update(grads, state, params) -> (updates, state)` (an
    `Optimizer`, or a rule set built like one). The net's optimizer
    state starts fresh from `tx.init`, and the cached training step is
    dropped so the next step runs `tx`. A net placed on a mesh that
    splits its state ("model", "expert", ZeRO-1, "pipe") raises
    OptimizerPlacementError, as does a mesh with a `tx` that is not an
    `Optimizer`: call `set_mesh(None)` first, or set the optimizer
    before `set_mesh`."""
    from deeplearning4j_tpu_torch.parallel.placement import _placed

    if getattr(net, "_mesh", None) is not None and (
            _placed(net) or not isinstance(tx, Optimizer)):
        raise OptimizerPlacementError(
            "set_optimizer on a net placed on a mesh: the placement keeps "
            "the optimizer state in its own layout and rebuilds only the "
            "port's Optimizer; call set_mesh(None) first, or set the "
            "optimizer before set_mesh")
    if net.params is None:
        net.init()
    net.tx = tx
    net.opt_state = tx.init(net.params)
    net._train_step = None


def _norm(items):
    """The gradient norm of [(tensor, group)] (`_sq_sum`), floored as
    the JAX package's."""
    return torch.sqrt(_sq_sum(items) + 1e-20)


def normalize_gradients(grads, layer_confs, split_groups=None):
    """Apply per-layer gradient normalization (reference BaseUpdater
    preApply / GradientNormalization.java). grads: {layer_name: nested
    dict of g}; returns a new dict (the input tensors are not modified).
    `split_groups` {leaf path: process group}: the leaves a placement
    split, whose norms are those of the whole leaves."""
    split_groups = split_groups or {}
    out = {}
    for name, g in grads.items():
        lc = layer_confs.get(name)
        gn = getattr(lc, "gradient_normalization", None) if lc else None
        thr = getattr(lc, "gradient_normalization_threshold", 1.0) if lc else 1.0
        every = [(x, split_groups.get((name,) + p))
                 for p, x in tree.leaves(g)]

        def per_leaf(fn):
            return tree.from_leaves(
                (p, fn(x, split_groups.get((name,) + p)))
                for p, x in tree.leaves(g)) if every else g

        if gn in (None, GradientNormalization.NONE, "none"):
            out[name] = g
        elif gn == GradientNormalization.RENORMALIZE_L2_PER_LAYER:
            n = _norm(every)
            out[name] = tree.tree_map(lambda x: x / n, g)
        elif gn == GradientNormalization.RENORMALIZE_L2_PER_PARAM_TYPE:
            out[name] = per_leaf(lambda x, grp: x / _norm([(x, grp)]))
        elif gn == GradientNormalization.CLIP_ELEMENTWISE_ABSOLUTE_VALUE:
            out[name] = tree.tree_map(lambda x: x.clamp(-thr, thr), g)
        elif gn == GradientNormalization.CLIP_L2_PER_LAYER:
            scale = (thr / _norm(every)).clamp_max(1.0)
            out[name] = tree.tree_map(lambda x: x * scale, g)
        elif gn == GradientNormalization.CLIP_L2_PER_PARAM_TYPE:
            out[name] = per_leaf(
                lambda x, grp: x * (thr / _norm([(x, grp)])).clamp_max(1.0))
        else:
            raise ValueError(f"Unknown gradient normalization {gn}")
    return out
