"""InputType — shape inference metadata (reference conf/inputs/InputType.java).

Drives automatic n_in inference and automatic preprocessor insertion
(reference conf/layers/setup/ConvolutionLayerSetup.java).

TPU-first layout decisions (differ deliberately from the reference):
- convolutional activations are NHWC (TPU/XLA-preferred), not NCHW
- recurrent activations are [batch, time, features], not [batch, features, time]
"""

from __future__ import annotations

import dataclasses

from deeplearning4j_tpu_torch.nn.conf.serde import register_config


@register_config
@dataclasses.dataclass
class InputType:
    kind: str = "feedforward"  # feedforward | recurrent | convolutional | convolutional_flat
    size: int = 0  # feedforward/recurrent feature size
    height: int = 0
    width: int = 0
    channels: int = 0
    timeseries_length: int = -1  # -1 = variable

    @staticmethod
    def feed_forward(size: int) -> "InputType":
        return InputType(kind="feedforward", size=size)

    @staticmethod
    def recurrent(size: int, timeseries_length: int = -1) -> "InputType":
        return InputType(kind="recurrent", size=size, timeseries_length=timeseries_length)

    @staticmethod
    def convolutional(height: int, width: int, channels: int) -> "InputType":
        return InputType(kind="convolutional", height=height, width=width, channels=channels)

    @staticmethod
    def convolutional_flat(height: int, width: int, channels: int) -> "InputType":
        return InputType(
            kind="convolutional_flat", height=height, width=width, channels=channels,
            size=height * width * channels,
        )

    def flat_size(self) -> int:
        if self.kind in ("feedforward", "recurrent"):
            return self.size
        return self.height * self.width * self.channels
