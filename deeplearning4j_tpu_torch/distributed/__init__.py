"""Multi-process runtime (JAX counterpart deeplearning4j_tpu/distributed):
one process per device under `torch.distributed`.

- `bootstrap`: the env-var contract and a hardened
  `init_process_group` (retry/backoff, NCCL on CUDA and gloo on the
  CPU, per-process telemetry).
- `launcher`: N local OS processes, one device each, with log
  streaming, wall-clock deadlines and straggler reaping.
- `global_mesh`: the mesh over every rank and this rank's part of a
  global batch.
- `faults`: deterministic fault injection (kill@step / hang@step /
  delay-connect / drop-heartbeat for fleet processes, kill / hang
  @batch / @decode for serving replicas) through the same env contract,
  and the exit classes the launcher reports.
- `elastic`: the recovery supervisor — checkpoint cadence, exit
  classification, generational re-form at N' processes, resume with a
  continuous step counter.

Only `bootstrap` (pure stdlib at import) loads eagerly; the rest
resolve lazily.
"""

from deeplearning4j_tpu_torch.distributed.bootstrap import (  # noqa: F401
    ENV_COORDINATOR,
    ENV_DEVICE,
    ENV_LOCAL_DEVICE_COUNT,
    ENV_NUM_PROCESSES,
    ENV_PROCESS_ID,
    Backoff,
    contract_from_env,
    env_contract_present,
    initialize,
    is_initialized,
    rendezvous_env,
    shutdown,
)

_LAZY = {
    "ProcessResult": "deeplearning4j_tpu_torch.distributed.launcher",
    "classify_exit": "deeplearning4j_tpu_torch.distributed.launcher",
    "free_port": "deeplearning4j_tpu_torch.distributed.launcher",
    "launch_local": "deeplearning4j_tpu_torch.distributed.launcher",
    "launch_plan": "deeplearning4j_tpu_torch.distributed.launcher",
    "Fault": "deeplearning4j_tpu_torch.distributed.faults",
    "FaultSchedule": "deeplearning4j_tpu_torch.distributed.faults",
    "active_faults": "deeplearning4j_tpu_torch.distributed.faults",
    "ElasticSupervisor": "deeplearning4j_tpu_torch.distributed.elastic",
    "run_elastic_steps": "deeplearning4j_tpu_torch.distributed.elastic",
    "globalize_batch": "deeplearning4j_tpu_torch.distributed.global_mesh",
    "globalize_full": "deeplearning4j_tpu_torch.distributed.global_mesh",
    "local_shard": "deeplearning4j_tpu_torch.distributed.global_mesh",
    "make_global_mesh": "deeplearning4j_tpu_torch.distributed.global_mesh",
    "spans_processes": "deeplearning4j_tpu_torch.distributed.global_mesh",
}


def __getattr__(name):
    mod = _LAZY.get(name)
    if mod is None:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    import importlib

    return getattr(importlib.import_module(mod), name)


def __dir__():
    return sorted(set(globals()) | set(_LAZY))
