"""Layer configuration dataclasses — the subset the Transformer LM uses,
with their bases (reference conf/layers/*; JAX counterpart
deeplearning4j_tpu/nn/conf/layers.py).

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
class RnnOutputLayer(BaseOutputLayer):
    """Per-timestep output layer (reference layers/recurrent/RnnOutputLayer.java).
    Input [batch, time, n_in] → output [batch, time, n_out]."""

    def get_output_type(self, input_type: InputType) -> InputType:
        return InputType.recurrent(self.n_out, input_type.timeseries_length)


@register_config
@dataclasses.dataclass
class EmbeddingLayer(FeedForwardLayer):
    """Index → vector lookup (reference layers/feedforward/embedding/EmbeddingLayer.java).
    Input is int indices [batch] or [batch, 1]."""

    has_bias: bool = True


@register_config
@dataclasses.dataclass
class BaseRecurrentLayer(FeedForwardLayer):
    """Base for sequence layers; activations are [batch, time, features]."""

    def get_output_type(self, input_type: InputType) -> InputType:
        return InputType.recurrent(self.n_out, input_type.timeseries_length)


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
    (param-free) or learned. `seq_parallel_axis` is kept for config
    round-trips; the sequence-parallel path is not part of this port."""

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
    the case is inside its envelope; `seq_parallel_axis` is kept for
    config round-trips only."""

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
