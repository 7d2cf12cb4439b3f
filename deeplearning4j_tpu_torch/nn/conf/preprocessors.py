"""Input preprocessors — shape adapters between layer kinds (reference
conf/preprocessor/*).

The slice carries the adapters that shape inference inserts around a
sequence model: the base class, FeedForwardToRnn and RnnToFeedForward.
The CNN adapters come with the LeNet slice. Layouts match the JAX
package: RNN activations are [batch, time, features].
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
