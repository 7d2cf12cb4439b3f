"""Declarative network configuration (JAX counterpart
deeplearning4j_tpu/nn/conf) — the classes the port carries."""

from deeplearning4j_tpu_torch.nn.conf.enums import (  # noqa: F401
    BackpropType,
    ConvolutionMode,
    GradientNormalization,
    LearningRatePolicy,
    OptimizationAlgorithm,
    PoolingType,
    Updater,
    WeightInit,
)
from deeplearning4j_tpu_torch.nn.conf.distributions import (  # noqa: F401
    BinomialDistribution,
    Distribution,
    GaussianDistribution,
    NormalDistribution,
    UniformDistribution,
)
from deeplearning4j_tpu_torch.nn.conf.inputs import InputType  # noqa: F401
from deeplearning4j_tpu_torch.nn.conf.layers import (  # noqa: F401
    ActivationLayer,
    BaseOutputLayer,
    BaseRecurrentLayer,
    BatchNormalization,
    ConvolutionLayer,
    DenseLayer,
    DropoutLayer,
    EmbeddingLayer,
    FeedForwardLayer,
    Layer,
    LayerNormalization,
    LocalResponseNormalization,
    OutputLayer,
    PositionalEncodingLayer,
    RnnOutputLayer,
    SelfAttentionLayer,
    SubsamplingLayer,
)
from deeplearning4j_tpu_torch.nn.conf.neural_net_configuration import (  # noqa: F401
    Builder,
    ListBuilder,
    MultiLayerConfiguration,
    NeuralNetConfiguration,
)
from deeplearning4j_tpu_torch.nn.conf.graph_conf import (  # noqa: F401
    ComputationGraphConfiguration,
    ElementWiseVertexConf,
    GraphBuilder,
    GraphVertexConf,
    LayerVertexConf,
)
from deeplearning4j_tpu_torch.nn.conf.preprocessors import (  # noqa: F401
    CnnToFeedForwardPreProcessor,
    FeedForwardToCnnPreProcessor,
    FeedForwardToRnnPreProcessor,
    InputPreProcessor,
    RnnToFeedForwardPreProcessor,
)
from deeplearning4j_tpu_torch.nn.conf.serde import (  # noqa: F401
    from_dict,
    from_json,
    register_config,
    to_dict,
    to_json,
)
