"""Host-side data plumbing (JAX counterpart deeplearning4j_tpu/data):
`prefetcher.py`, the event-driven background prefetch channel. The
sharded input pipeline and its shard assignment come with the parallel
slice (ROADMAP Queue A item 7)."""

from deeplearning4j_tpu_torch.data.prefetcher import (  # noqa: F401
    EOS,
    Channel,
    Prefetcher,
)
