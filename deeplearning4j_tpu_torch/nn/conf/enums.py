"""Config enums mirroring the reference's nn/conf enums.

Reference: Updater.java (SGD, ADAM, ADADELTA, NESTEROVS, ADAGRAD, RMSPROP,
NONE, CUSTOM), OptimizationAlgorithm.java, GradientNormalization.java,
LearningRatePolicy.java, BackpropType.java, WeightInit.java,
conf/layers/SubsamplingLayer.java:29-30 (PoolingType).
Values are plain strings so configs JSON-serialize trivially.
"""

from __future__ import annotations

import enum


class StrEnum(str, enum.Enum):
    def __str__(self):  # serialize as bare string
        return self.value


class Updater(StrEnum):
    SGD = "sgd"
    ADAM = "adam"
    ADAMW = "adamw"
    ADADELTA = "adadelta"
    NESTEROVS = "nesterovs"
    ADAGRAD = "adagrad"
    RMSPROP = "rmsprop"
    LION = "lion"
    LAMB = "lamb"
    NONE = "none"
    CUSTOM = "custom"


class OptimizationAlgorithm(StrEnum):
    LINE_GRADIENT_DESCENT = "line_gradient_descent"
    CONJUGATE_GRADIENT = "conjugate_gradient"
    HESSIAN_FREE = "hessian_free"
    LBFGS = "lbfgs"
    STOCHASTIC_GRADIENT_DESCENT = "stochastic_gradient_descent"


class WeightInit(StrEnum):
    """Reference nn/weights/WeightInit.java: DISTRIBUTION, NORMALIZED, SIZE,
    UNIFORM, VI, ZERO, XAVIER, RELU."""

    DISTRIBUTION = "distribution"
    NORMALIZED = "normalized"
    SIZE = "size"
    UNIFORM = "uniform"
    VI = "vi"
    ZERO = "zero"
    XAVIER = "xavier"
    RELU = "relu"
    LECUN = "lecun"


class GradientNormalization(StrEnum):
    NONE = "none"
    RENORMALIZE_L2_PER_LAYER = "renormalize_l2_per_layer"
    RENORMALIZE_L2_PER_PARAM_TYPE = "renormalize_l2_per_param_type"
    CLIP_ELEMENTWISE_ABSOLUTE_VALUE = "clip_elementwise_absolute_value"
    CLIP_L2_PER_LAYER = "clip_l2_per_layer"
    CLIP_L2_PER_PARAM_TYPE = "clip_l2_per_param_type"


class LearningRatePolicy(StrEnum):
    NONE = "none"
    EXPONENTIAL = "exponential"
    INVERSE = "inverse"
    POLY = "poly"
    SIGMOID = "sigmoid"
    STEP = "step"
    TORCH_STEP = "torch_step"
    SCHEDULE = "schedule"
    COSINE = "cosine"  # TPU-era addition (not in reference)
    WARMUP_COSINE = "warmup_cosine"  # TPU-era addition


class BackpropType(StrEnum):
    STANDARD = "standard"
    TRUNCATED_BPTT = "truncated_bptt"


class PoolingType(StrEnum):
    MAX = "max"
    AVG = "avg"
    SUM = "sum"
    NONE = "none"
    PNORM = "pnorm"


class ConvolutionMode(StrEnum):
    """Padding semantics; reference pads explicitly — SAME/VALID are the XLA idiom."""

    STRICT = "strict"  # explicit padding, error on non-exact fit
    SAME = "same"
    VALID = "valid"


class HiddenUnit(StrEnum):
    """RBM hidden unit types (reference layers/feedforward/rbm/RBM.java:197-205)."""

    BINARY = "binary"
    GAUSSIAN = "gaussian"
    RECTIFIED = "rectified"
    SOFTMAX = "softmax"


class VisibleUnit(StrEnum):
    BINARY = "binary"
    GAUSSIAN = "gaussian"
    LINEAR = "linear"
    SOFTMAX = "softmax"
