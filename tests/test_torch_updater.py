"""The port's updaters (deeplearning4j_tpu_torch/nn/updater.py) against
the JAX package's optax transforms on the CPU: every ported update rule
under every learning-rate policy, fed the same gradient sequence for 5
steps from the same params; gradient normalization; per-layer
overrides.

Tolerance: float32 on both sides, the same formulas evaluated in
another order (the port computes the learning rate in Python floats,
optax in float32): params agree to 1e-6 relative (1e-7 absolute for
entries near 0).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from deeplearning4j_tpu.nn.conf.layers import DenseLayer as JDense
from deeplearning4j_tpu.nn.conf.neural_net_configuration import (
    NeuralNetConfiguration as JConf,
)
from deeplearning4j_tpu.nn.updater import (
    build_optimizer as jax_build,
    make_schedule as jax_schedule,
    normalize_gradients as jax_normalize,
)
from deeplearning4j_tpu_torch.nn.conf.layers import DenseLayer as TDense
from deeplearning4j_tpu_torch.nn.conf.neural_net_configuration import (
    NeuralNetConfiguration as TConf,
)
from deeplearning4j_tpu_torch.nn.updater import (
    apply_updates,
    build_optimizer as torch_build,
    make_schedule as torch_schedule,
    normalize_gradients as torch_normalize,
)

pytestmark = pytest.mark.port

RTOL, ATOL = 1e-6, 1e-7
STEPS = 5

UPDATERS = ["sgd", "nesterovs", "adam", "adamw", "adagrad", "rmsprop",
            "adadelta", "none"]
POLICIES = {
    "none": dict(lr_policy="none"),
    "exponential": dict(lr_policy="exponential", lr_policy_decay_rate=0.9),
    "inverse": dict(lr_policy="inverse", lr_policy_decay_rate=0.1,
                    lr_policy_power=0.5),
    "poly": dict(lr_policy="poly", decay_steps=10, lr_policy_power=2.0),
    "sigmoid": dict(lr_policy="sigmoid", lr_policy_decay_rate=0.5,
                    lr_policy_steps=2.0),
    "step": dict(lr_policy="step", lr_policy_decay_rate=0.5,
                 lr_policy_steps=2.0),
    "torch_step": dict(lr_policy="torch_step", lr_policy_decay_rate=0.5,
                       lr_policy_steps=2.0),
    "cosine": dict(lr_policy="cosine", decay_steps=4),
    "warmup_cosine": dict(lr_policy="warmup_cosine", warmup_steps=2,
                          decay_steps=6),
    "schedule": dict(lr_schedule={0: 0.1, 2: 0.05, 4: 0.01}),
}
BASE = dict(learning_rate=0.1, momentum=0.9, rho=0.95, rms_decay=0.9,
            epsilon=1e-6, weight_decay=0.01)


def _problem(seed):
    """Two layers' params and a 5-step gradient sequence (numpy)."""
    rng = np.random.default_rng(seed)
    shapes = {"l0": {"W": (4, 3), "b": (3,)}, "l1": {"W": (3, 2),
                                                      "b": (2,)}}
    params = {lay: {n: rng.standard_normal(s).astype(np.float32)
                    for n, s in p.items()} for lay, p in shapes.items()}
    grads = [{lay: {n: rng.standard_normal(s).astype(np.float32)
                    for n, s in p.items()} for lay, p in shapes.items()}
             for _ in range(STEPS)]
    return params, grads


def _run_jax(conf, layer_confs, params, grads):
    tx = jax_build(conf, layer_confs, flat=False)
    p = jax.tree.map(jnp.asarray, params)
    state = tx.init(p)
    for g in grads:
        g = jax_normalize(jax.tree.map(jnp.asarray, g), layer_confs)
        updates, state = tx.update(g, state, p)
        p = optax.apply_updates(p, updates)
    return jax.tree.map(np.asarray, p)


def _run_torch(conf, layer_confs, params, grads):
    tx = torch_build(conf, layer_confs)
    p = {lay: {n: torch.from_numpy(a.copy()) for n, a in q.items()}
         for lay, q in params.items()}
    state = tx.init(p)
    for g in grads:
        g = torch_normalize({lay: {n: torch.from_numpy(a) for n, a in q.items()}
                             for lay, q in g.items()}, layer_confs)
        updates, state = tx.update(g, state, p)
        apply_updates(p, updates)
    return {lay: {n: t.numpy() for n, t in q.items()} for lay, q in p.items()}


def _assert_same(got, want):
    for lay in want:
        for n in want[lay]:
            np.testing.assert_allclose(got[lay][n], want[lay][n], rtol=RTOL,
                                       atol=ATOL, err_msg=f"{lay}.{n}")


@pytest.mark.parametrize("updater", UPDATERS)
@pytest.mark.parametrize("policy", sorted(POLICIES))
def test_updater_and_policy_match_jax(updater, policy):
    kw = dict(BASE, updater=updater, **POLICIES[policy])
    params, grads = _problem(100 * UPDATERS.index(updater)
                             + sorted(POLICIES).index(policy))
    want = _run_jax(JConf(**kw), {}, params, grads)
    got = _run_torch(TConf(**kw), {}, params, grads)
    _assert_same(got, want)


@pytest.mark.parametrize("policy", sorted(POLICIES))
def test_schedule_values_match_jax(policy):
    kw = dict(BASE, **POLICIES[policy])
    js, ts = jax_schedule(JConf(**kw)), torch_schedule(TConf(**kw))
    for step in range(12):
        np.testing.assert_allclose(ts(step), float(js(jnp.int32(step))),
                                   rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("norm", [
    "renormalize_l2_per_layer", "renormalize_l2_per_param_type",
    "clip_elementwise_absolute_value", "clip_l2_per_layer",
    "clip_l2_per_param_type"])
def test_gradient_normalization_matches_jax(norm):
    """Each GradientNormalization mode on layer l1 (l0 left alone),
    under Adam."""
    kw = dict(BASE, updater="adam")
    params, grads = _problem(7)
    jl = {"l0": JDense(n_in=4, n_out=3),
          "l1": JDense(n_in=3, n_out=2, gradient_normalization=norm,
                       gradient_normalization_threshold=0.5)}
    tl = {"l0": TDense(n_in=4, n_out=3),
          "l1": TDense(n_in=3, n_out=2, gradient_normalization=norm,
                       gradient_normalization_threshold=0.5)}
    _assert_same(_run_torch(TConf(**kw), tl, params, grads),
                 _run_jax(JConf(**kw), jl, params, grads))


def test_per_layer_override_matches_jax():
    """A layer with its own updater and learning rate gets its own rule
    and state (the JAX package's optax.multi_transform)."""
    kw = dict(BASE, updater="adam")
    params, grads = _problem(9)
    jl = {"l0": JDense(n_in=4, n_out=3),
          "l1": JDense(n_in=3, n_out=2, updater="nesterovs",
                       learning_rate=0.05)}
    tl = {"l0": TDense(n_in=4, n_out=3),
          "l1": TDense(n_in=3, n_out=2, updater="nesterovs",
                       learning_rate=0.05)}
    _assert_same(_run_torch(TConf(**kw), tl, params, grads),
                 _run_jax(JConf(**kw), jl, params, grads))


@pytest.mark.parametrize("updater", ["lion", "lamb"])
def test_unported_updaters_raise(updater):
    """LION and LAMB, once refused, now take optax's defaults and match
    `optax.lion` / `optax.lamb` over 5 steps under the "none" and
    "cosine" policies (LION: b1 0.9, b2 0.99, weight decay
    1e-3; LAMB: b1 0.9, b2 0.999, eps 1e-6, the trust ratio per leaf).
    LION takes the sign of a blend of gradient and moment: an entry
    whose blend is within rounding of 0 could differ by 2 * lr a step;
    these gradients keep every blend away from 0, so the tolerance is
    the file's."""
    for policy in ("none", "cosine"):
        kw = dict(BASE, updater=updater, **POLICIES[policy])
        params, grads = _problem(500 + len(updater) + len(policy))
        _assert_same(_run_torch(TConf(**kw), {}, params, grads),
                     _run_jax(JConf(**kw), {}, params, grads))


@pytest.mark.parametrize("updater", ["lamb", "lion", "adam"])
def test_nested_params_update_per_leaf_as_jax(updater):
    """A bidirectional LSTM's {"fwd": {...}, "bwd": {...}} params: every
    leaf gets its own moments and (LAMB) its own trust ratio, as optax
    over the same pytree."""
    rng = np.random.default_rng(11)
    shapes = {"W": (3, 8), "RW": (2, 8), "b": (8,)}
    nest = lambda: {"bi": {d: {n: rng.standard_normal(sh).astype(  # noqa: E731
        np.float32) for n, sh in shapes.items()} for d in ("fwd", "bwd")}}
    params, grads = nest(), [nest() for _ in range(STEPS)]
    kw = dict(BASE, updater=updater)
    want = _run_jax(JConf(**kw), {}, params, grads)
    tx = torch_build(TConf(**kw), {})
    p = jax.tree.map(lambda a: torch.from_numpy(a.copy()), params)
    state = tx.init(p)
    for g in grads:
        updates, state = tx.update(jax.tree.map(torch.from_numpy, g),
                                   state, p)
        apply_updates(p, updates)
    for d in ("fwd", "bwd"):
        for n in shapes:
            np.testing.assert_allclose(p["bi"][d][n].numpy(),
                                       want["bi"][d][n], rtol=RTOL,
                                       atol=ATOL, err_msg=f"{d}.{n}")
