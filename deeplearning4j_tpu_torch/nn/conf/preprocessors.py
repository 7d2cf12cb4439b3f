"""Input preprocessors — shape adapters between layer kinds (reference
conf/preprocessor/*).

Every adapter of the JAX package: the ones shape inference inserts
(`_adapter` in neural_net_configuration.py) — FeedForwardToRnn,
RnnToFeedForward, CnnToFeedForward, FeedForwardToCnn — and CnnToRnn,
RnnToCnn, Reshape, Composable and BinomialSampling. Layouts match the
JAX package: CNN activations are NHWC, RNN activations [batch, time,
features]; each adapter is a reshape that autograd differentiates.

`pre_process(x)` is the inference forward. The containers call
`pre_process_train(x, generator)` while training, which is the same
function except for BinomialSampling: it draws Bernoulli(clip(x, 0, 1))
from the net's generator there (the reference's binomial sample), where
the JAX package's only clips. Its expectation is the JAX package's
value, and inputs of 0 and 1 give it exactly.
"""

from __future__ import annotations

import dataclasses

import torch

from deeplearning4j_tpu_torch.nn.conf.inputs import InputType
from deeplearning4j_tpu_torch.nn.conf.serde import register_config


@register_config
@dataclasses.dataclass
class InputPreProcessor:
    def pre_process(self, x):
        return x

    def pre_process_train(self, x, generator=None):
        """The training forward: `pre_process` unless a preprocessor
        draws."""
        return self.pre_process(x)

    def get_output_type(self, input_type: InputType) -> InputType:
        return input_type


@register_config
@dataclasses.dataclass
class CnnToFeedForwardPreProcessor(InputPreProcessor):
    """NHWC [B, H, W, C] -> [B, H*W*C], flattened in NHWC order (so the
    rows of the next dense W are the JAX package's)."""

    height: int = 0
    width: int = 0
    channels: int = 0

    def pre_process(self, x):
        return x.reshape(x.shape[0], -1)

    def get_output_type(self, input_type: InputType) -> InputType:
        return InputType.feed_forward(input_type.flat_size())


@register_config
@dataclasses.dataclass
class FeedForwardToCnnPreProcessor(InputPreProcessor):
    """[B, H*W*C] -> NHWC [B, H, W, C]; a 4-D input passes through."""

    height: int = 0
    width: int = 0
    channels: int = 1

    def pre_process(self, x):
        if x.ndim == 4:
            return x
        return x.reshape(x.shape[0], self.height, self.width, self.channels)

    def get_output_type(self, input_type: InputType) -> InputType:
        return InputType.convolutional(self.height, self.width,
                                       self.channels)


@register_config
@dataclasses.dataclass
class FeedForwardToRnnPreProcessor(InputPreProcessor):
    """Broadcasts a 2-D input to a single-timestep sequence; 3-D inputs
    pass through (the network keeps RNN activations 3-D)."""

    def pre_process(self, x):
        if x.ndim == 3:
            return x
        return x[:, None, :]

    def get_output_type(self, input_type: InputType) -> InputType:
        return InputType.recurrent(input_type.flat_size())


@register_config
@dataclasses.dataclass
class RnnToFeedForwardPreProcessor(InputPreProcessor):
    """Identity marker: dense layers act on the last axis, so [batch,
    time, f] needs no reshape (kept for reference parity)."""

    def pre_process(self, x):
        return x

    def get_output_type(self, input_type: InputType) -> InputType:
        return InputType.recurrent(input_type.flat_size())


@register_config
@dataclasses.dataclass
class CnnToRnnPreProcessor(InputPreProcessor):
    """NHWC [B, H, W, C] -> [B, 1, H*W*C]: a CNN frame becomes one
    timestep."""

    def pre_process(self, x):
        return x.reshape(x.shape[0], 1, -1)

    def get_output_type(self, input_type: InputType) -> InputType:
        return InputType.recurrent(input_type.flat_size())


@register_config
@dataclasses.dataclass
class RnnToCnnPreProcessor(InputPreProcessor):
    """[B, T, f] -> [B*T, H, W, C]: time folds into the batch."""

    height: int = 0
    width: int = 0
    channels: int = 1

    def pre_process(self, x):
        b, t, _ = x.shape
        return x.reshape(b * t, self.height, self.width, self.channels)

    def get_output_type(self, input_type: InputType) -> InputType:
        return InputType.convolutional(self.height, self.width,
                                       self.channels)


@register_config
@dataclasses.dataclass
class ReshapePreProcessor(InputPreProcessor):
    """Reshape to (batch,) + `shape`."""

    shape: tuple = ()

    def pre_process(self, x):
        return x.reshape((x.shape[0],) + tuple(self.shape))


@register_config
@dataclasses.dataclass
class ComposableInputPreProcessor(InputPreProcessor):
    """A chain of preprocessors (reference ComposableInputPreProcessor)."""

    processors: list = dataclasses.field(default_factory=list)

    def pre_process(self, x):
        for p in self.processors:
            x = p.pre_process(x)
        return x

    def pre_process_train(self, x, generator=None):
        for p in self.processors:
            x = p.pre_process_train(x, generator)
        return x

    def get_output_type(self, input_type: InputType) -> InputType:
        for p in self.processors:
            input_type = p.get_output_type(input_type)
        return input_type


@register_config
@dataclasses.dataclass
class BinomialSamplingPreProcessor(InputPreProcessor):
    """clip(x, 0, 1) for inference; while training with a generator, a
    Bernoulli draw of that probability (module docstring)."""

    def pre_process(self, x):
        return x.clamp(0.0, 1.0)

    def pre_process_train(self, x, generator=None):
        p = self.pre_process(x)
        if generator is None:
            return p
        return torch.bernoulli(p.float(), generator=generator).to(p.dtype)
