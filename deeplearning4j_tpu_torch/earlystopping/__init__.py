"""Early stopping (JAX counterpart deeplearning4j_tpu/earlystopping)."""

from deeplearning4j_tpu_torch.earlystopping.core import (  # noqa: F401
    BestScoreEpochTerminationCondition,
    DataSetLossCalculator,
    EarlyStoppingConfiguration,
    EarlyStoppingGraphTrainer,
    EarlyStoppingResult,
    EarlyStoppingTrainer,
    InMemoryModelSaver,
    InvalidScoreIterationTerminationCondition,
    LocalFileModelSaver,
    MaxEpochsTerminationCondition,
    MaxScoreIterationTerminationCondition,
    MaxTimeIterationTerminationCondition,
    ScoreImprovementEpochTerminationCondition,
)
