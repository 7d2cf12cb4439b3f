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

`.graph_builder()` wires a DAG (graph_conf.py); `.list()` a sequential
stack, built into a MultiLayerConfiguration by ListBuilder. With an
input type set, both infer every layer's n_in and insert the shape
adapters (preprocessors.py) where layer kinds change (`_infer_shapes`,
`_adapter`): a convolution's NHWC output becomes a dense layer's flat
input through CnnToFeedForwardPreProcessor, as in the JAX package.
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
    ActivationLayer,
    BaseRecurrentLayer,
    BatchNormalization,
    ConvolutionLayer,
    DropoutLayer,
    Layer,
    LocalResponseNormalization,
    PositionalEncodingLayer,
    RnnOutputLayer,
    SelfAttentionLayer,
    SubsamplingLayer,
)
from deeplearning4j_tpu_torch.nn.conf.preprocessors import (
    CnnToFeedForwardPreProcessor,
    FeedForwardToCnnPreProcessor,
    FeedForwardToRnnPreProcessor,
    InputPreProcessor,
    RnnToFeedForwardPreProcessor,
)

__all__ = ["BackpropType", "Builder", "ListBuilder",
           "MultiLayerConfiguration", "NeuralNetConfiguration"]


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


@serde.register_config
@dataclasses.dataclass
class MultiLayerConfiguration:
    """Sequential-stack config (reference
    nn/conf/MultiLayerConfiguration.java)."""

    conf: NeuralNetConfiguration = dataclasses.field(
        default_factory=NeuralNetConfiguration)
    layers: list = dataclasses.field(default_factory=list)
    input_pre_processors: dict = dataclasses.field(
        default_factory=dict)  # {str(idx): proc}
    backprop: bool = True
    pretrain: bool = False
    backprop_type: str = BackpropType.STANDARD
    tbptt_fwd_length: int = 20
    tbptt_back_length: int = 20
    input_type: Optional[InputType] = None

    def to_json(self) -> str:
        return serde.to_json(self)

    @staticmethod
    def from_json(s: str) -> "MultiLayerConfiguration":
        return serde.from_json(s)

    def get_preprocessor(self, idx: int):
        return self.input_pre_processors.get(str(idx))


class Builder:
    """Fluent builder matching NeuralNetConfiguration.Builder's method
    surface: one snake_case setter per config field, each returning self;
    `.list()` moves to layer wiring (ListBuilder), `.graph_builder()` to
    DAG wiring."""

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

    def optimization_algo(self, v) -> "Builder":
        """The reference's optimization-algorithm setter: a name that is
        not an `OptimizationAlgorithm` value raises ValueError here, at
        build time, naming the valid values."""
        v = _coerce_enum(v)
        try:
            v = OptimizationAlgorithm(v)
        except ValueError:
            raise ValueError(
                f"Unknown optimization algorithm {v!r}; one of "
                f"{[a.value for a in OptimizationAlgorithm]}") from None
        self._c.optimization_algo = str(v)
        return self

    def regularization(self, flag: bool) -> "Builder":
        """The reference's use-regularization toggle: off zeroes l1/l2."""
        if not flag:
            self._c.l1 = 0.0
            self._c.l2 = 0.0
        return self

    def build(self) -> NeuralNetConfiguration:
        return copy.deepcopy(self._c)

    def list(self) -> "ListBuilder":
        return ListBuilder(self.build())

    def graph_builder(self):
        from deeplearning4j_tpu_torch.nn.conf.graph_conf import GraphBuilder

        return GraphBuilder(self.build())


class ListBuilder:
    """Layer-stack wiring (reference NeuralNetConfiguration.ListBuilder)."""

    def __init__(self, conf: NeuralNetConfiguration):
        self._conf = conf
        self._layers: list = []
        self._preprocessors: dict[int, InputPreProcessor] = {}
        self._backprop = True
        self._pretrain = False
        self._backprop_type = BackpropType.STANDARD
        self._tbptt_fwd = 20
        self._tbptt_back = 20
        self._input_type: Optional[InputType] = None

    def layer(self, idx_or_layer, layer: Optional[Layer] = None
              ) -> "ListBuilder":
        """`layer(conf)` appends; `layer(idx, conf)` sets index idx."""
        if layer is None:
            self._layers.append(idx_or_layer)
        else:
            idx = idx_or_layer
            while len(self._layers) <= idx:
                self._layers.append(None)
            self._layers[idx] = layer
        return self

    def input_pre_processor(self, idx: int, proc: InputPreProcessor
                            ) -> "ListBuilder":
        self._preprocessors[idx] = proc
        return self

    def backprop(self, flag: bool) -> "ListBuilder":
        self._backprop = flag
        return self

    def pretrain(self, flag: bool) -> "ListBuilder":
        self._pretrain = flag
        return self

    def backprop_type(self, t) -> "ListBuilder":
        self._backprop_type = _coerce_enum(t)
        return self

    def t_bptt_forward_length(self, n: int) -> "ListBuilder":
        self._tbptt_fwd = n
        return self

    def t_bptt_backward_length(self, n: int) -> "ListBuilder":
        self._tbptt_back = n
        return self

    def set_input_type(self, t: InputType) -> "ListBuilder":
        self._input_type = t
        return self

    input_type = set_input_type

    def build(self) -> MultiLayerConfiguration:
        if any(lc is None for lc in self._layers):
            raise ValueError("Layer list has gaps — set every index")
        layers = [self._conf.resolve_layer(lc) for lc in self._layers]
        _validate_names(layers)
        pre = {int(k): v for k, v in self._preprocessors.items()}
        if self._input_type is not None:
            _infer_shapes(layers, pre, self._input_type)
        return MultiLayerConfiguration(
            conf=self._conf,
            layers=layers,
            input_pre_processors={str(k): v for k, v in pre.items()},
            backprop=self._backprop,
            pretrain=self._pretrain,
            backprop_type=self._backprop_type,
            tbptt_fwd_length=self._tbptt_fwd,
            tbptt_back_length=self._tbptt_back,
            input_type=self._input_type,
        )


def _validate_names(layers) -> None:
    """Fail at build() on a typo'd activation or loss name, naming the
    layer."""
    from deeplearning4j_tpu_torch.nn.conf.layers import validate_layer_names

    for i, layer in enumerate(layers):
        try:
            validate_layer_names(layer)
        except ValueError as e:
            raise ValueError(f"layer {i} ({type(layer).__name__}): {e}") \
                from None


def _expected_kind(layer: Layer) -> str:
    if isinstance(layer, (ConvolutionLayer, SubsamplingLayer,
                          LocalResponseNormalization)):
        return "convolutional"
    if isinstance(layer, (BaseRecurrentLayer, RnnOutputLayer,
                          SelfAttentionLayer)):
        return "recurrent"
    if isinstance(layer, (BatchNormalization, ActivationLayer, DropoutLayer,
                          PositionalEncodingLayer)):
        return "any"  # shape-preserving: accept any input kind
    return "feedforward"


def _adapter(from_type: InputType, to_kind: str):
    """Auto-insert shape adapters (reference ConvolutionLayerSetup
    behavior)."""
    if to_kind == "any" or from_type.kind == to_kind:
        return None
    if from_type.kind == "convolutional_flat" and to_kind == "convolutional":
        return FeedForwardToCnnPreProcessor(
            height=from_type.height, width=from_type.width,
            channels=from_type.channels)
    if from_type.kind == "convolutional_flat" and to_kind == "feedforward":
        return None  # already flat
    if from_type.kind == "convolutional" and to_kind == "feedforward":
        return CnnToFeedForwardPreProcessor(
            height=from_type.height, width=from_type.width,
            channels=from_type.channels)
    if from_type.kind == "feedforward" and to_kind == "convolutional":
        raise ValueError(
            "Cannot infer CNN shape from a flat feed-forward input; set an "
            "explicit FeedForwardToCnnPreProcessor")
    if from_type.kind == "feedforward" and to_kind == "recurrent":
        return FeedForwardToRnnPreProcessor()
    if from_type.kind == "recurrent" and to_kind == "feedforward":
        return RnnToFeedForwardPreProcessor()
    raise ValueError(f"No adapter {from_type.kind} → {to_kind}")


def _infer_shapes(layers, preprocessors, input_type: InputType):
    """Propagate InputType through the stack: set n_in everywhere, and
    insert preprocessors where layer kinds change
    (ConvolutionLayerSetup.java analogue)."""
    cur = input_type
    for i, layer in enumerate(layers):
        proc = preprocessors.get(i)
        if proc is None:
            proc = _adapter(cur, _expected_kind(layer))
            if proc is not None:
                preprocessors[i] = proc
        if proc is not None:
            cur = proc.get_output_type(cur)
        layer.set_n_in(cur)
        cur = layer.get_output_type(cur)


def _coerce_enum(v):
    import enum as _enum

    if isinstance(v, _enum.Enum):
        return v.value
    return v
