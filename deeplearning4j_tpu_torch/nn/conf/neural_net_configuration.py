"""NeuralNetConfiguration — the builder-style declarative config API
(JAX counterpart deeplearning4j_tpu/nn/conf/neural_net_configuration.py).

Global hyperparameters set on the Builder are inherited by every layer
that does not override them (`resolve_layer`). The dataclass keeps every
field of the JAX package's so configs round-trip through JSON between
the two packages; the training fields are inert until the training
slice.

Dtype policy: `param_dtype` is what parameters are stored in,
`dtype` what the forward computes in — each layer's params are cast to
the compute dtype as it runs (nn/graph.py `_forward`).

The slice ports `graph_builder()`. `.list()` and MultiLayerConfiguration
come with the MultiLayerNetwork slice.
"""

from __future__ import annotations

import copy
import dataclasses
from typing import Optional

from deeplearning4j_tpu_torch.nn.conf import serde
from deeplearning4j_tpu_torch.nn.conf.distributions import Distribution
from deeplearning4j_tpu_torch.nn.conf.enums import (
    BackpropType,
    GradientNormalization,
    LearningRatePolicy,
    OptimizationAlgorithm,
    Updater,
    WeightInit,
)
from deeplearning4j_tpu_torch.nn.conf.inputs import InputType
from deeplearning4j_tpu_torch.nn.conf.layers import (
    BaseRecurrentLayer,
    Layer,
    PositionalEncodingLayer,
    RnnOutputLayer,
    SelfAttentionLayer,
)
from deeplearning4j_tpu_torch.nn.conf.preprocessors import (
    FeedForwardToRnnPreProcessor,
    RnnToFeedForwardPreProcessor,
)

__all__ = ["BackpropType", "Builder", "NeuralNetConfiguration"]


@serde.register_config
@dataclasses.dataclass
class NeuralNetConfiguration:
    """Global (defaults) section of a network config."""

    seed: int = 12345
    optimization_algo: str = OptimizationAlgorithm.STOCHASTIC_GRADIENT_DESCENT
    iterations: int = 1
    learning_rate: float = 1e-1
    bias_learning_rate: Optional[float] = None
    lr_policy: str = LearningRatePolicy.NONE
    lr_policy_decay_rate: float = 0.0
    lr_policy_steps: float = 0.0
    lr_policy_power: float = 0.0
    lr_schedule: Optional[dict] = None
    warmup_steps: int = 0
    decay_steps: int = 0
    momentum: float = 0.5
    momentum_schedule: Optional[dict] = None
    rho: float = 0.95
    rms_decay: float = 0.95
    adam_mean_decay: float = 0.9
    adam_var_decay: float = 0.999
    epsilon: float = 1e-8
    updater: str = Updater.SGD
    weight_decay: float = 0.0
    l1: float = 0.0
    l2: float = 0.0
    dropout: float = 0.0
    use_drop_connect: bool = False
    weight_init: str = WeightInit.XAVIER
    dist: Optional[Distribution] = None
    bias_init: float = 0.0
    activation: str = "sigmoid"
    gradient_normalization: str = GradientNormalization.NONE
    gradient_normalization_threshold: float = 1.0
    minimize: bool = True
    max_num_line_search_iterations: int = 5
    step_function: Optional[str] = None
    mini_batch: bool = True
    dtype: str = "float32"  # compute dtype
    param_dtype: str = "float32"
    remat: bool = False

    @staticmethod
    def builder() -> "Builder":
        return Builder()

    _INHERITED = (
        "activation", "weight_init", "dist", "bias_init", "dropout", "l1",
        "l2", "learning_rate", "updater", "gradient_normalization",
        "gradient_normalization_threshold",
    )

    def resolve_layer(self, layer: Layer) -> Layer:
        layer = copy.deepcopy(layer)
        for f in self._INHERITED:
            if getattr(layer, f, None) is None:
                if f == "learning_rate":
                    layer.learning_rate = None  # None = use global schedule
                else:
                    setattr(layer, f, getattr(self, f, None))
        if getattr(layer, "drop_connect", None) is None:
            layer.drop_connect = self.use_drop_connect
        return layer

    def to_json(self) -> str:
        return serde.to_json(self)

    @staticmethod
    def from_json(s: str) -> "NeuralNetConfiguration":
        return serde.from_json(s)


class Builder:
    """Fluent builder matching NeuralNetConfiguration.Builder's method
    surface: one snake_case setter per config field, each returning self;
    `.graph_builder()` moves to DAG wiring."""

    def __init__(self):
        self._c = NeuralNetConfiguration()

    def __getattr__(self, name):
        if name.startswith("_"):
            raise AttributeError(name)
        if name in NeuralNetConfiguration.__dataclass_fields__:
            def setter(value):
                setattr(self._c, name, _coerce_enum(value))
                return self
            return setter
        raise AttributeError(
            f"No such config field '{name}'. Fields: "
            f"{sorted(NeuralNetConfiguration.__dataclass_fields__)}"
        )

    def build(self) -> NeuralNetConfiguration:
        return copy.deepcopy(self._c)

    def graph_builder(self):
        from deeplearning4j_tpu_torch.nn.conf.graph_conf import GraphBuilder

        return GraphBuilder(self.build())


def _expected_kind(layer: Layer) -> str:
    if isinstance(layer, (BaseRecurrentLayer, RnnOutputLayer,
                          SelfAttentionLayer)):
        return "recurrent"
    if isinstance(layer, PositionalEncodingLayer):
        return "any"  # shape-preserving: accept any input kind
    return "feedforward"


def _adapter(from_type: InputType, to_kind: str):
    """Auto-insert shape adapters (reference ConvolutionLayerSetup
    behavior) for the sequence/feed-forward kinds this slice carries."""
    if to_kind == "any" or from_type.kind == to_kind:
        return None
    if from_type.kind == "feedforward" and to_kind == "recurrent":
        return FeedForwardToRnnPreProcessor()
    if from_type.kind == "recurrent" and to_kind == "feedforward":
        return RnnToFeedForwardPreProcessor()
    raise ValueError(f"No adapter {from_type.kind} → {to_kind} in this port "
                     "(convolutional layouts come with the LeNet slice)")


def _coerce_enum(v):
    import enum as _enum

    if isinstance(v, _enum.Enum):
        return v.value
    return v
