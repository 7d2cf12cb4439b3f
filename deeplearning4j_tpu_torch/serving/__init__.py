"""Generation serving (JAX counterpart deeplearning4j_tpu/serving):

* `buckets.py`  — the padding-bucket lattice every prompt chunk is padded
  into;
* `kvcache.py`  — page-block KV-cache accounting (`CachePlan`,
  `PagePool`);
* `batcher.py`  — the generation request and decode-slot state machine;
* `engine.py`   — `GenerationEngine`: chunked prefill interleaved with
  continuous-batching greedy decode over the paged cache (f32 or int8),
  optionally speculative, over one or more replicas on the card;
* `speculative.py` — the n-gram draft proposer and greedy acceptance;
* `fleet.py`    — the published-weights store the workers read;
* `server.py`   — `ServingServer`, the HTTP front door (streaming
  /generate, /metrics, /healthz, /stats, /drain);
* `replay.py`   — the generation and speculative traffic replays and
  their scoreboard from the telemetry log.
"""

from deeplearning4j_tpu_torch.serving.buckets import BucketLattice  # noqa: F401
from deeplearning4j_tpu_torch.serving.engine import (  # noqa: F401
    GenerationEngine,
    QueueFullError,
)
