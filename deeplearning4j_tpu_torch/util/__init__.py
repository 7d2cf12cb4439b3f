"""Utilities of the port (JAX counterpart deeplearning4j_tpu/util):
`checkpoint.py`, the port's own checkpoint format (a directory a step),
`model_serializer.py`, the JAX package's `ModelSerializer` zip format,
read and written by both packages, `profiler.py`, `torch.profiler`
windows of a region or of `fit()` (Chrome traces), and the host-side
helpers: `image_loader.py` (image files as NHWC float32 arrays; Pillow
when it imports, else its own PPM/PGM codec), `disk_queue.py` (a FIFO
spilled to disk), `moving_window.py`, `sloppy_math.py`,
`string_grid.py`, `time_series.py` and `viterbi.py`.
"""

from deeplearning4j_tpu_torch.util.model_serializer import (  # noqa: F401
    ModelSerializer,
)
