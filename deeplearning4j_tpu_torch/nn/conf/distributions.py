"""Weight distributions (reference conf/distribution/*: Normal, Uniform,
Binomial, Gaussian), sampled with an explicit `torch.Generator`."""

from __future__ import annotations

import dataclasses

import torch

from deeplearning4j_tpu_torch.nn.conf.serde import register_config


@register_config
@dataclasses.dataclass
class Distribution:
    def sample(self, gen: torch.Generator, shape, dtype):
        raise NotImplementedError


@register_config
@dataclasses.dataclass
class NormalDistribution(Distribution):
    """Gaussian with given mean/std (reference NormalDistribution)."""

    mean: float = 0.0
    std: float = 1.0

    def sample(self, gen, shape, dtype):
        return self.mean + self.std * torch.randn(shape, generator=gen,
                                                  dtype=dtype)


# The reference has both GaussianDistribution and NormalDistribution (aliases).
GaussianDistribution = register_config(name="GaussianDistribution")(
    dataclasses.make_dataclass(
        "GaussianDistribution", [("mean", float, 0.0), ("std", float, 1.0)],
        bases=(NormalDistribution,),
    )
)


@register_config
@dataclasses.dataclass
class UniformDistribution(Distribution):
    lower: float = -1.0
    upper: float = 1.0

    def sample(self, gen, shape, dtype):
        u = torch.rand(shape, generator=gen, dtype=dtype)
        return self.lower + (self.upper - self.lower) * u


@register_config
@dataclasses.dataclass
class BinomialDistribution(Distribution):
    number_of_trials: int = 1
    probability_of_success: float = 0.5

    def sample(self, gen, shape, dtype):
        p = torch.full(shape, float(self.probability_of_success))
        draws = torch.zeros(shape)
        for _ in range(int(self.number_of_trials)):
            draws += torch.bernoulli(p, generator=gen)
        return draws.to(dtype)
