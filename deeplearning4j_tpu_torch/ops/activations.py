"""Named activation registry (JAX counterpart
deeplearning4j_tpu/ops/activations.py).

Each name maps to a function on tensors with the JAX package's
semantics. Note `gelu`: `jax.nn.gelu` defaults to the tanh
approximation, so the port uses `F.gelu(x, approximate="tanh")`.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def _softmax(x):
    # Row-wise softmax over the feature (last) axis, numerically stable.
    return torch.softmax(x, dim=-1)


def _leakyrelu(x):
    return F.leaky_relu(x, negative_slope=0.01)


def _hardtanh(x):
    return torch.clamp(x, -1.0, 1.0)


def _hardsigmoid(x):
    return torch.clamp(0.2 * x + 0.5, 0.0, 1.0)


def _cube(x):
    return x * x * x


def _rectifiedtanh(x):
    return torch.clamp(torch.tanh(x), min=0.0)


def _gelu(x):
    return F.gelu(x, approximate="tanh")


def _softsign(x):
    return x / (1 + torch.abs(x))


def _identity(x):
    return x


def _step(x):
    return (x > 0).to(x.dtype)


_REGISTRY = {
    "sigmoid": torch.sigmoid,
    "tanh": torch.tanh,
    "relu": torch.relu,
    "leakyrelu": _leakyrelu,
    "softmax": _softmax,
    "identity": _identity,
    "linear": _identity,
    "softplus": F.softplus,
    "softsign": _softsign,
    "elu": F.elu,
    "selu": F.selu,
    "gelu": _gelu,
    "silu": F.silu,
    "swish": F.silu,
    "exp": torch.exp,
    "cube": _cube,
    "hardtanh": _hardtanh,
    "hardsigmoid": _hardsigmoid,
    "rectifiedtanh": _rectifiedtanh,
    "abs": torch.abs,
    "sqrt": torch.sqrt,
    "sin": torch.sin,
    "cos": torch.cos,
    "sign": torch.sign,
    "negative": torch.neg,
    "log": torch.log,
    "floor": torch.floor,
    "round": torch.round,
    "step": _step,
}


class Activations:
    """Enum-style constants for the activation names."""

    SIGMOID = "sigmoid"
    TANH = "tanh"
    RELU = "relu"
    LEAKYRELU = "leakyrelu"
    SOFTMAX = "softmax"
    IDENTITY = "identity"
    SOFTPLUS = "softplus"
    SOFTSIGN = "softsign"
    ELU = "elu"
    GELU = "gelu"
    HARDTANH = "hardtanh"
    CUBE = "cube"


def get_activation(name):
    """Resolve an activation by name. Accepts a callable as passthrough."""
    if callable(name):
        return name
    try:
        return _REGISTRY[name.lower()]
    except KeyError:
        raise ValueError(
            f"Unknown activation '{name}'. Known: {sorted(_REGISTRY)}"
        ) from None


def register_activation(name, fn):
    """Register a custom activation (reference allows custom transforms)."""
    _REGISTRY[name.lower()] = fn
