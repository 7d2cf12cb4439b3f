"""Declarative network configuration (JAX counterpart
deeplearning4j_tpu/nn/conf) — the classes the slice carries."""

from deeplearning4j_tpu_torch.nn.conf.enums import (  # noqa: F401
    BackpropType,
    GradientNormalization,
    LearningRatePolicy,
    OptimizationAlgorithm,
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
    BaseOutputLayer,
    BaseRecurrentLayer,
    DenseLayer,
    EmbeddingLayer,
    FeedForwardLayer,
    Layer,
    LayerNormalization,
    PositionalEncodingLayer,
    RnnOutputLayer,
    SelfAttentionLayer,
)
from deeplearning4j_tpu_torch.nn.conf.neural_net_configuration import (  # noqa: F401
    Builder,
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
