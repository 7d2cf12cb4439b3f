"""Utilities of the port (JAX counterpart deeplearning4j_tpu/util):
`checkpoint.py`, the port's own checkpoint format (a directory a step),
`model_serializer.py`, the JAX package's `ModelSerializer` zip format,
read and written by both packages, and `profiler.py`, `torch.profiler`
windows of a region or of `fit()` (Chrome traces).
"""

from deeplearning4j_tpu_torch.util.model_serializer import (  # noqa: F401
    ModelSerializer,
)
