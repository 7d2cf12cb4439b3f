"""Gradient checks (JAX counterpart deeplearning4j_tpu/gradientcheck)."""

from deeplearning4j_tpu_torch.gradientcheck.gradient_check_util import (  # noqa: F401
    GradientCheckUtil,
    check_gradients,
    check_gradients_graph,
)
