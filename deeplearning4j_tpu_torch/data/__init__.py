"""Host-side data plumbing (JAX counterpart deeplearning4j_tpu/data):

- `prefetcher.py`: the event-driven background prefetch channel;
- `sharding.py`: the deterministic example -> process assignment keyed
  off ``(process_index, process_count, epoch, seed)``;
- `pipeline.py`: the pipelined loader the fit loops ride
  (`iter_prefetched`, the ``input_wait`` span) and
  `ShardedDataSetIterator`;
- `bench_worker.py`: the `input_pipeline` bench's MLP worker.
"""

from deeplearning4j_tpu_torch.data.prefetcher import (  # noqa: F401
    EOS,
    Channel,
    Prefetcher,
)
from deeplearning4j_tpu_torch.data.sharding import (  # noqa: F401
    ShardAssignment,
    epoch_permutation,
    local_rows,
    process_slice,
)
from deeplearning4j_tpu_torch.data.pipeline import (  # noqa: F401
    ShardedDataSetIterator,
    iter_prefetched,
    prefetch_depth,
    set_prefetch_depth,
)

__all__ = [
    "EOS", "Channel", "Prefetcher",
    "ShardAssignment", "epoch_permutation", "local_rows", "process_slice",
    "ShardedDataSetIterator", "iter_prefetched", "prefetch_depth",
    "set_prefetch_depth",
]
