"""Input preprocessors — shape adapters between layer kinds (reference
conf/preprocessor/*).

The port carries the adapters that shape inference inserts (`_adapter`
in neural_net_configuration.py) around the sequence and image models:
FeedForwardToRnn, RnnToFeedForward, CnnToFeedForward and
FeedForwardToCnn (CnnToRnn comes with the recurrent layers). Layouts
match the JAX package: CNN activations are NHWC, RNN activations
[batch, time, features]; each adapter is a reshape that autograd
differentiates.
"""

from __future__ import annotations

import dataclasses

from deeplearning4j_tpu_torch.nn.conf.inputs import InputType
from deeplearning4j_tpu_torch.nn.conf.serde import register_config


@register_config
@dataclasses.dataclass
class InputPreProcessor:
    def pre_process(self, x):
        return x

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
