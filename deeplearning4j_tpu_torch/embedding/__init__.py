"""The embedding engine (JAX counterpart deeplearning4j_tpu/embedding):

* `engine.py` — SGNS + hierarchical-softmax train steps over
  device-resident tables (ep = dp = 1), scored by the K13 kernel; the
  lookup-table view.
* `walks.py`  — ragged DeepWalk walks bucketed into fixed shapes +
  device-side pair extraction.
* `corpus.py` — skip-gram pair batches fed through the async prefetch
  channel.

The ANN index and the /embed + /search serving engine come with later
slices (ROADMAP Queue A item 8).
"""

from deeplearning4j_tpu_torch.embedding.engine import (  # noqa: F401
    EngineLookupView,
    ShardedEmbeddingEngine,
)
