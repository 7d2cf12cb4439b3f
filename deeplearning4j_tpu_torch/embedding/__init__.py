"""The embedding engine and vector search (JAX counterpart
deeplearning4j_tpu/embedding):

* `engine.py`  — SGNS + hierarchical-softmax train steps over
  device-resident tables (ep = dp = 1), scored by the K13 kernel; the
  lookup-table view.
* `ann.py`     — the fixed-shape partition-then-refine ANN index
  (coarse centroid routing + exact top-k inside the probed partitions).
* `walks.py`   — ragged DeepWalk walks bucketed into fixed shapes +
  device-side pair extraction.
* `corpus.py`  — skip-gram pair batches fed through the async prefetch
  channel.
* `serving.py` — the `/embed` + `/search` serving engine over the
  serving server and fleet plumbing.
"""

from deeplearning4j_tpu_torch.embedding.engine import (  # noqa: F401
    EngineLookupView,
    ShardedEmbeddingEngine,
)
from deeplearning4j_tpu_torch.embedding.ann import DeviceANNIndex  # noqa: F401
from deeplearning4j_tpu_torch.embedding.serving import (  # noqa: F401
    EmbeddingServingEngine,
)
