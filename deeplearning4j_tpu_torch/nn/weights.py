"""Weight initialization schemes (JAX counterpart
deeplearning4j_tpu/nn/weights.py; reference nn/weights/WeightInit.java).

Samples are drawn on the CPU from an explicit `torch.Generator` and
moved by the caller, so a seed gives the same weights on every device.
The JAX package draws from `jax.random`, so the two packages agree in
distribution only; tests copy params across (weights_io.py).
"""

from __future__ import annotations

import math

import torch

from deeplearning4j_tpu_torch.nn.conf.enums import WeightInit


def init_weights(gen: torch.Generator, shape, scheme, dist=None,
                 dtype=torch.float32, fan_in=None, fan_out=None):
    """Sample a weight tensor per the named scheme.

    fan_in/fan_out default to shape[0]/shape[-1] (dense convention).
    """
    shape = tuple(shape)
    if fan_in is None:
        fan_in = shape[0]
    if fan_out is None:
        fan_out = shape[-1]
    s = (scheme if isinstance(scheme, str) else scheme.value).lower()

    def normal(std):
        return std * torch.randn(shape, generator=gen, dtype=dtype)

    def uniform(lo, hi):
        return lo + (hi - lo) * torch.rand(shape, generator=gen, dtype=dtype)

    if s == WeightInit.ZERO:
        return torch.zeros(shape, dtype=dtype)
    if s == WeightInit.DISTRIBUTION:
        if dist is None:
            raise ValueError("WeightInit.DISTRIBUTION requires a Distribution")
        return dist.sample(gen, shape, dtype)
    if s == WeightInit.XAVIER:
        # Glorot normal: N(0, 2/(fan_in+fan_out)) — reference WeightInitUtil
        return normal(math.sqrt(2.0 / (fan_in + fan_out)))
    if s == WeightInit.RELU:
        return normal(math.sqrt(2.0 / fan_in))  # He normal
    if s == WeightInit.LECUN:
        return normal(math.sqrt(1.0 / fan_in))
    if s == WeightInit.UNIFORM:
        a = 1.0 / math.sqrt(float(fan_in))
        return uniform(-a, a)
    if s in (WeightInit.VI, WeightInit.SIZE):
        r = math.sqrt(6.0 / (fan_in + fan_out))
        return uniform(-r, r)
    if s == WeightInit.NORMALIZED:
        return (torch.rand(shape, generator=gen, dtype=dtype) - 0.5) / float(fan_in)
    raise ValueError(f"Unknown weight init '{scheme}'")
