"""The port's resharding engine: train on one placement, restore and
serve on any other (JAX counterpart deeplearning4j_tpu/reshard/).

1. `reshard.planner` — the pure planner: (source placement, target
   placement, leaf layouts) -> a deterministic per-leaf plan (keep /
   slice_exchange / allgather_shard / host_fallback) with its bytes and
   their lower bound. Standard library only; the JAX package's plans.
2. `reshard.executor` — the port's moves: `set_mesh` re-placement over
   the process group's point-to-point calls (`reshard_net_live`) and
   the restore of a canonical checkpoint into a placed net
   (`checkpoint_template`, `restore_placed`).
3. `reshard.search` — the automatic placement search: every
   `Placement` a fleet admits, pruned and ranked by a per-step cost
   model; `search_placement(...).winner` feeds `set_mesh` unmodified.
   `reshard.bench_arm` times a searched placement's steps in a process
   of its own.
"""

from deeplearning4j_tpu_torch.reshard.planner import (  # noqa: F401
    ACTIONS,
    ALLGATHER_SHARD,
    HOST_FALLBACK,
    KEEP,
    SLICE_EXCHANGE,
    LeafLayout,
    LeafPlan,
    Placement,
    PlacementError,
    ReshardPlan,
    plan_leaf,
    plan_reshard,
)
from deeplearning4j_tpu_torch.reshard.search import (  # noqa: F401
    BUILTIN_PROFILES,
    FleetShape,
    ModelProfile,
    Objective,
    ParamLeaf,
    ScoredCandidate,
    SearchError,
    SearchResult,
    enumerate_placements,
    profile_net,
    score_placement,
    search_placement,
)
