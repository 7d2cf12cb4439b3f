"""Layer configuration dataclasses (reference conf/layers/*; JAX
counterpart deeplearning4j_tpu/nn/conf/layers.py): the feed-forward,
output, convolution, normalization, attention, recurrent and pretrain
layers.

Each config is a declarative, JSON-serializable description with the
same fields and `@type` names as the JAX package's, so a config written
by either package loads in the other. The matching implementation lives
in deeplearning4j_tpu_torch/nn/layers/. Fields left as None inherit the
global defaults from the enclosing NeuralNetConfiguration.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

from deeplearning4j_tpu_torch.nn.conf.distributions import Distribution
from deeplearning4j_tpu_torch.nn.conf.enums import (
    ConvolutionMode,
    HiddenUnit,
    PoolingType,
    VisibleUnit,
)
from deeplearning4j_tpu_torch.nn.conf.inputs import InputType
from deeplearning4j_tpu_torch.nn.conf.serde import register_config


@register_config
@dataclasses.dataclass
class Layer:
    """Base layer config (reference conf/layers/Layer.java)."""

    name: Optional[str] = None
    activation: Optional[str] = None
    weight_init: Optional[str] = None
    dist: Optional[Distribution] = None
    bias_init: Optional[float] = None
    dropout: Optional[float] = None
    drop_connect: Optional[bool] = None
    l1: Optional[float] = None
    l2: Optional[float] = None
    learning_rate: Optional[float] = None
    updater: Optional[str] = None
    gradient_normalization: Optional[str] = None
    gradient_normalization_threshold: Optional[float] = None

    def set_n_in(self, input_type: InputType) -> None:  # noqa: B027
        """Infer and set n_in from the incoming InputType (no-op by default)."""

    def get_output_type(self, input_type: InputType) -> InputType:
        return input_type

    def is_pretrain_layer(self) -> bool:
        return False


@register_config
@dataclasses.dataclass
class FeedForwardLayer(Layer):
    """Base for layers with dense n_in→n_out params."""

    n_in: int = 0
    n_out: int = 0

    def set_n_in(self, input_type: InputType) -> None:
        if self.n_in == 0:
            self.n_in = input_type.flat_size()

    def get_output_type(self, input_type: InputType) -> InputType:
        if input_type.kind == "recurrent":
            return InputType.recurrent(self.n_out, input_type.timeseries_length)
        return InputType.feed_forward(self.n_out)


@register_config
@dataclasses.dataclass
class DenseLayer(FeedForwardLayer):
    """Fully-connected layer (reference layers/feedforward/dense/DenseLayer.java)."""


@register_config
@dataclasses.dataclass
class BaseOutputLayer(FeedForwardLayer):
    loss_function: str = "mcxent"

    def has_loss(self) -> bool:
        return True


@register_config
@dataclasses.dataclass
class OutputLayer(BaseOutputLayer):
    """Output layer with loss (reference conf/layers/OutputLayer.java)."""


@register_config
@dataclasses.dataclass
class RnnOutputLayer(BaseOutputLayer):
    """Per-timestep output layer (reference layers/recurrent/RnnOutputLayer.java).
    Input [batch, time, n_in] → output [batch, time, n_out]."""

    def get_output_type(self, input_type: InputType) -> InputType:
        return InputType.recurrent(self.n_out, input_type.timeseries_length)


@register_config
@dataclasses.dataclass
class ActivationLayer(Layer):
    """Pure activation layer (reference conf/layers/ActivationLayer.java)."""


@register_config
@dataclasses.dataclass
class DropoutLayer(Layer):
    """Standalone dropout layer."""


@register_config
@dataclasses.dataclass
class BasePretrainNetwork(FeedForwardLayer):
    loss_function: str = "reconstruction_crossentropy"
    visible_bias_init: float = 0.0

    def is_pretrain_layer(self) -> bool:
        return True


@register_config
@dataclasses.dataclass
class AutoEncoder(BasePretrainNetwork):
    """Denoising autoencoder (reference
    layers/feedforward/autoencoder/AutoEncoder.java). corruption_level =
    input corruption probability; sparsity = KL target."""

    corruption_level: float = 0.3
    sparsity: float = 0.0


@register_config
@dataclasses.dataclass
class RBM(BasePretrainNetwork):
    """Restricted Boltzmann machine trained by CD-k (reference
    layers/feedforward/rbm/RBM.java: contrastiveDivergence:101, Gibbs
    sampling gibbhVh:149-151, unit types :197-205)."""

    hidden_unit: str = HiddenUnit.BINARY
    visible_unit: str = VisibleUnit.BINARY
    k: int = 1
    sparsity: float = 0.0


@register_config
@dataclasses.dataclass
class EmbeddingLayer(FeedForwardLayer):
    """Index → vector lookup (reference layers/feedforward/embedding/EmbeddingLayer.java).
    Input is int indices [batch] or [batch, 1]."""

    has_bias: bool = True


@register_config
@dataclasses.dataclass
class ConvolutionLayer(FeedForwardLayer):
    """2-D convolution over NHWC activations with HWIO weights
    (reference layers/convolution/ConvolutionLayer.java). n_in = input
    channels, n_out = output channels."""

    kernel_size: tuple = (5, 5)
    stride: tuple = (1, 1)
    padding: tuple = (0, 0)
    convolution_mode: str = ConvolutionMode.STRICT
    dilation: tuple = (1, 1)

    def set_n_in(self, input_type: InputType) -> None:
        if self.n_in == 0 and input_type.kind in ("convolutional",
                                                  "convolutional_flat"):
            self.n_in = input_type.channels

    def get_output_type(self, input_type: InputType) -> InputType:
        h, w = _conv_out_hw(
            input_type.height, input_type.width, self.kernel_size,
            self.stride, self.padding, self.convolution_mode, self.dilation)
        return InputType.convolutional(h, w, self.n_out)


@register_config
@dataclasses.dataclass
class SubsamplingLayer(Layer):
    """Pooling layer (reference
    layers/convolution/subsampling/SubsamplingLayer.java)."""

    pooling_type: str = PoolingType.MAX
    kernel_size: tuple = (2, 2)
    stride: tuple = (2, 2)
    padding: tuple = (0, 0)
    convolution_mode: str = ConvolutionMode.STRICT
    pnorm: int = 2

    def get_output_type(self, input_type: InputType) -> InputType:
        h, w = _conv_out_hw(
            input_type.height, input_type.width, self.kernel_size,
            self.stride, self.padding, self.convolution_mode, (1, 1))
        return InputType.convolutional(h, w, input_type.channels)


@register_config
@dataclasses.dataclass
class BatchNormalization(FeedForwardLayer):
    """Batch normalization (reference
    layers/normalization/BatchNormalization.java). The running mean and
    variance live in the network's `state`, not in its params."""

    decay: float = 0.9
    eps: float = 1e-5
    gamma: float = 1.0
    beta: float = 0.0
    lock_gamma_beta: bool = False

    def set_n_in(self, input_type: InputType) -> None:
        if self.n_in == 0:
            if input_type.kind == "convolutional":
                self.n_in = input_type.channels
            else:
                self.n_in = input_type.flat_size()
        if self.n_out == 0:
            self.n_out = self.n_in

    def get_output_type(self, input_type: InputType) -> InputType:
        return input_type


@register_config
@dataclasses.dataclass
class LocalResponseNormalization(Layer):
    """LRN across channels (reference
    layers/normalization/LocalResponseNormalization.java)."""

    k: float = 2.0
    n: float = 5.0
    alpha: float = 1e-4
    beta: float = 0.75


@register_config
@dataclasses.dataclass
class BaseRecurrentLayer(FeedForwardLayer):
    """Base for sequence layers; activations are [batch, time, features]."""

    def get_output_type(self, input_type: InputType) -> InputType:
        return InputType.recurrent(self.n_out, input_type.timeseries_length)


@register_config
@dataclasses.dataclass
class GravesLSTM(BaseRecurrentLayer):
    """LSTM with peephole connections, per Graves (2013) (reference
    layers/recurrent/GravesLSTM.java + LSTMHelpers.java)."""

    forget_gate_bias_init: float = 1.0


@register_config
@dataclasses.dataclass
class LSTM(BaseRecurrentLayer):
    """Standard LSTM without peepholes."""

    forget_gate_bias_init: float = 1.0


@register_config
@dataclasses.dataclass
class GravesBidirectionalLSTM(BaseRecurrentLayer):
    """Bidirectional Graves LSTM (reference
    layers/recurrent/GravesBidirectionalLSTM.java): the forward and
    backward passes' outputs summed."""

    forget_gate_bias_init: float = 1.0


@register_config
@dataclasses.dataclass
class GRU(BaseRecurrentLayer):
    """Gated recurrent unit (reference layers/recurrent/GRU.java)."""


@register_config
@dataclasses.dataclass
class LayerNormalization(FeedForwardLayer):
    """Layer norm over the feature axis."""

    eps: float = 1e-5

    def set_n_in(self, input_type: InputType) -> None:
        if self.n_in == 0:
            self.n_in = input_type.flat_size()
        if self.n_out == 0:
            self.n_out = self.n_in

    def get_output_type(self, input_type: InputType) -> InputType:
        return input_type


@register_config
@dataclasses.dataclass
class PositionalEncodingLayer(Layer):
    """Adds positional information to [batch, time, features] — sinusoidal
    (param-free) or learned. `seq_parallel_axis`: the mesh axis time is
    sharded over in a sequence-parallel step, where x is a shard's block
    and the encoding offsets by its global position."""

    learned: bool = False
    max_length: int = 2048
    n_features: int = 0
    seq_parallel_axis: str = ""

    def set_n_in(self, input_type: InputType) -> None:
        if self.n_features == 0:
            self.n_features = input_type.flat_size()

    def get_output_type(self, input_type: InputType) -> InputType:
        return input_type


@register_config
@dataclasses.dataclass
class SelfAttentionLayer(BaseRecurrentLayer):
    """Multi-head self-attention over [batch, time, features] with causal
    masking. `use_flash` selects the hand-written attention kernel when
    the case is inside its envelope; `seq_parallel_axis`: the mesh axis
    time is sharded over in a sequence-parallel step, where attention
    runs the ring (parallel/ring_attention.py)."""

    n_heads: int = 8
    causal: bool = True
    attention_dropout: float = 0.0
    use_flash: bool = True
    seq_parallel_axis: str = ""

    def set_n_in(self, input_type: InputType) -> None:
        if self.n_in == 0:
            self.n_in = input_type.flat_size()
        if self.n_out == 0:
            self.n_out = self.n_in


def _conv_out_hw(h, w, kernel, stride, padding, mode, dilation):
    """Output height and width of a convolution or pooling window: SAME
    gives ceil(h / stride); VALID the windows that fit; STRICT (explicit
    `padding` on both sides) the windows that fit the padded input."""
    kh = (kernel[0] - 1) * dilation[0] + 1
    kw = (kernel[1] - 1) * dilation[1] + 1
    if mode == ConvolutionMode.SAME or mode == "same":
        return -(-h // stride[0]), -(-w // stride[1])
    if mode == ConvolutionMode.VALID or mode == "valid":
        return (h - kh) // stride[0] + 1, (w - kw) // stride[1] + 1
    return (
        (h + 2 * padding[0] - kh) // stride[0] + 1,
        (w + 2 * padding[1] - kw) // stride[1] + 1,
    )


def validate_layer_names(layer_conf) -> None:
    """Eagerly resolve a layer conf's string-named activation / loss so a
    typo'd name fails at init() with a named ValueError."""
    from deeplearning4j_tpu_torch.ops.activations import get_activation
    from deeplearning4j_tpu_torch.ops.losses import validate_loss

    act = getattr(layer_conf, "activation", None)
    if act is not None:
        get_activation(act)
    loss = getattr(layer_conf, "loss_function", None)
    if loss is not None:
        validate_loss(loss)
