"""Evaluation metrics (JAX counterpart deeplearning4j_tpu/eval; reference
eval/). Host-side numpy over the network's outputs, the same code as the
JAX package's."""

from deeplearning4j_tpu_torch.eval.confusion import ConfusionMatrix  # noqa: F401
from deeplearning4j_tpu_torch.eval.evaluation import Evaluation  # noqa: F401
from deeplearning4j_tpu_torch.eval.regression import RegressionEvaluation  # noqa: F401
