"""Distributed training (JAX counterpart deeplearning4j_tpu/parallel):
data, sequence, tensor, expert and pipeline parallelism and ZeRO-1,
one process per device under `torch.distributed` (NCCL on CUDA, gloo
on the CPU).

- `mesh`: named axes over the ranks (`make_mesh`, `shard_batch`,
  `replicate`, `spans_processes`);
- `placement`: `set_mesh`'s body for the roles "data", "seq", "model",
  "expert" and "pipe", for ZeRO-1 and for a `reshard.Placement`;
- `pipeline`: the stage partition (`PipelinePlan`) and the GPipe step
  over a process-group or an in-process transport (`place_in_process`);
- `tensor_parallel`: the placement rules and `SplitPlan`, which cuts a
  net's params to this rank's shards and gathers them whole;
- `expert_parallel`: the MoE layer with its experts split;
- `overlap`: the bucketed gradient all-reduce that overlaps the
  backward;
- `data_parallel`: `DataParallelTrainer` (monolithic and overlap arms)
  and `ParameterAveragingTrainer`;
- `ring_attention`: the ring over the flash kernels, by process group
  or in one process;
- `sequence_parallel`: `make_sp_train_step`, `SequenceParallelTrainer`.

The shard a mesh step's forward runs as, and the split of each placed
layer, are `ops/shard_scope.py`, which the layers read; the split
layers' collectives are `ops/shard_comm.py`; moving a placed net to
another placement is `reshard/`.
"""

from deeplearning4j_tpu_torch.parallel.data_parallel import (
    DataParallelTrainer,
    ParameterAveragingTrainer,
)
from deeplearning4j_tpu_torch.parallel.mesh import (
    make_mesh,
    replicate,
    shard_batch,
    spans_processes,
)
from deeplearning4j_tpu_torch.parallel.ring_attention import (
    ring_attention,
    ring_self_attention,
)
from deeplearning4j_tpu_torch.parallel.sequence_parallel import (
    SequenceParallelTrainer,
    make_sp_train_step,
)
from deeplearning4j_tpu_torch.parallel.tensor_parallel import (
    TRANSFORMER_TP_RULES,
    shard_params,
    sharding_for,
)

__all__ = [
    "DataParallelTrainer", "ParameterAveragingTrainer",
    "SequenceParallelTrainer", "TRANSFORMER_TP_RULES", "make_mesh",
    "make_sp_train_step", "replicate", "ring_attention",
    "ring_self_attention", "shard_batch", "shard_params", "sharding_for",
    "spans_processes",
]
