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
fusion count. LION and LAMB take optax's defaults (`optax.lion`: b1 0.9,
b2 0.99, weight decay 1e-3; `optax.lamb`: b1 0.9, b2 0.999, eps 1e-6,
weight decay 0, the trust ratio per leaf and 1 where either norm is 0).
"""

from __future__ import annotations

import math

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


class _Rule:
    """One update rule over a list of f32 tensors: optax's transform for
    it followed by its scale by the (scheduled) negative learning
    rate."""

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

    def update(self, grads, state, params):
        c = self.conf
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
            ups = []
            for g, mu, nu, p in zip(grads, state["mu"], state["nu"], params):
                mu.mul_(b1).add_(g, alpha=1.0 - b1)
                nu.mul_(b2).addcmul_(g, g, value=1.0 - b2)
                u = (mu / bc1) / ((nu / bc2).sqrt() + eps)
                pn = torch.linalg.vector_norm(p.float())
                un = torch.linalg.vector_norm(u.float())
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
    on the layer name). state: {label: {"layers": [...], rule state}}."""

    def __init__(self, rules, labels):
        self.rules = rules          # {label: _Rule}
        self.labels = labels        # {layer: label}

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
                [tree.get(params, k) for k in keys])
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
    """{layer_name: layer_conf} of a network container."""
    return {n: v.layer for n, v in net.layer_vertices.items()}


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


def _norm(tensors):
    return torch.sqrt(sum((t.float() ** 2).sum() for t in tensors) + 1e-20)


def normalize_gradients(grads, layer_confs):
    """Apply per-layer gradient normalization (reference BaseUpdater
    preApply / GradientNormalization.java). grads: {layer_name: nested
    dict of g}; returns a new dict (the input tensors are not
    modified)."""
    out = {}
    for name, g in grads.items():
        lc = layer_confs.get(name)
        gn = getattr(lc, "gradient_normalization", None) if lc else None
        thr = getattr(lc, "gradient_normalization_threshold", 1.0) if lc else 1.0
        every = [x for _, x in tree.leaves(g)]
        if gn in (None, GradientNormalization.NONE, "none"):
            out[name] = g
        elif gn == GradientNormalization.RENORMALIZE_L2_PER_LAYER:
            n = _norm(every)
            out[name] = tree.tree_map(lambda x: x / n, g)
        elif gn == GradientNormalization.RENORMALIZE_L2_PER_PARAM_TYPE:
            out[name] = tree.tree_map(lambda x: x / _norm([x]), g)
        elif gn == GradientNormalization.CLIP_ELEMENTWISE_ABSOLUTE_VALUE:
            out[name] = tree.tree_map(lambda x: x.clamp(-thr, thr), g)
        elif gn == GradientNormalization.CLIP_L2_PER_LAYER:
            scale = (thr / _norm(every)).clamp_max(1.0)
            out[name] = tree.tree_map(lambda x: x * scale, g)
        elif gn == GradientNormalization.CLIP_L2_PER_PARAM_TYPE:
            out[name] = tree.tree_map(
                lambda x: x * (thr / _norm([x])).clamp_max(1.0), g)
        else:
            raise ValueError(f"Unknown gradient normalization {gn}")
    return out
