"""Serving (JAX counterpart deeplearning4j_tpu/serving):

* `buckets.py`  — the padding-bucket lattice every predict batch and
  prompt chunk is padded into;
* `batcher.py`  — dynamic batching (`Batcher`, `plan_batch`, `assemble`:
  requests coalesce into bucket batches under a max-wait deadline) and
  the generation request and decode-slot state machine;
* `kvcache.py`  — page-block KV-cache accounting (`CachePlan`,
  `PagePool`);
* `engine.py`   — `InferenceEngine` (one forward per request, round-robin
  replicas over the batcher) and `GenerationEngine` (chunked prefill
  interleaved with continuous-batching greedy decode over the paged
  cache, f32 or int8, optionally speculative);
* `speculative.py` — the n-gram draft proposer and greedy acceptance;
* `fleet.py`    — zero-downtime operations: the published-weights store,
  live hot-swap from a checkpoint, replica fault injection, the
  supervisor's reap/respawn and autoscaling;
* `server.py`   — `ServingServer`, the HTTP front door (/predict,
  streaming /generate, /metrics, /healthz, /stats, /drain);
* `replay.py`   — the predict, fleet, generation and speculative traffic
  replays and their scoreboards from the telemetry log.
"""

from deeplearning4j_tpu_torch.serving.batcher import (  # noqa: F401
    Batcher,
    DecodeSlots,
    GenRequest,
    PendingRequest,
    plan_batch,
)
from deeplearning4j_tpu_torch.serving.buckets import (  # noqa: F401
    Bucket,
    BucketLattice,
)
from deeplearning4j_tpu_torch.serving.engine import (  # noqa: F401
    GenerationEngine,
    InferenceEngine,
    QueueFullError,
)
from deeplearning4j_tpu_torch.serving.fleet import (  # noqa: F401
    AutoscalePolicy,
    CheckpointWatcher,
    FleetSupervisor,
    ReplicaFaultInjector,
    WeightStore,
    WeightSwapError,
    hot_swap,
)
from deeplearning4j_tpu_torch.serving.kvcache import (  # noqa: F401
    CachePlan,
    PagePool,
)
from deeplearning4j_tpu_torch.serving.server import ServingServer  # noqa: F401

__all__ = [
    "AutoscalePolicy",
    "Batcher",
    "Bucket",
    "BucketLattice",
    "CachePlan",
    "CheckpointWatcher",
    "DecodeSlots",
    "FleetSupervisor",
    "GenRequest",
    "GenerationEngine",
    "InferenceEngine",
    "PagePool",
    "PendingRequest",
    "QueueFullError",
    "ReplicaFaultInjector",
    "ServingServer",
    "WeightStore",
    "WeightSwapError",
    "hot_swap",
    "plan_batch",
]
