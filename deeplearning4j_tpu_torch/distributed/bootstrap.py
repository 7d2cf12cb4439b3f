"""Multi-process rendezvous bootstrap (JAX counterpart
deeplearning4j_tpu/distributed/bootstrap.py).

The JAX package brings up `jax.distributed`; the port brings up
`torch.distributed`, one process per device:

- **env-var contract** (`ENV_*` below): process id / process count /
  coordinator address, written by `distributed/launcher.py` for local
  fleets; the JAX package's spellings, so one launch line serves both.
  `ENV_DEVICE` is the port's own: the device the process owns
  (``cuda:<i>`` or ``cpu``), where the JAX package's
  `ENV_LOCAL_DEVICE_COUNT` counts virtual CPU devices.
- **initialize()**: `torch.distributed.init_process_group` over a TCP
  rendezvous with the JAX package's retry / full-jitter backoff /
  timeout, and telemetry `meta` / `span` events per process. The
  backend follows the device: NCCL for CUDA, gloo for the CPU, and
  never the one in place of the other.

Pure stdlib at import; torch is imported inside the functions.
"""

from __future__ import annotations

import contextlib
import os
import random
import socket
import time
from datetime import timedelta
from typing import Callable, Optional

# ------------------------------------------------------------ env contract
ENV_COORDINATOR = "DL4J_TPU_COORDINATOR"
ENV_PROCESS_ID = "DL4J_TPU_PROCESS_ID"
ENV_NUM_PROCESSES = "DL4J_TPU_NUM_PROCESSES"
ENV_LOCAL_DEVICE_COUNT = "DL4J_TPU_LOCAL_DEVICE_COUNT"
# the rendezvous half of the contract, as the JAX package names it
RENDEZVOUS_ENV_VARS = (ENV_COORDINATOR, ENV_PROCESS_ID, ENV_NUM_PROCESSES,
                       ENV_LOCAL_DEVICE_COUNT)
ENV_FAULTS = "DL4J_TPU_FAULTS"
ENV_DEVICE = "DL4J_TPU_DEVICE"
# how long shutdown's barrier waits for the slowest rank on gloo
SHUTDOWN_BARRIER_S = 30.0
# the process group's timeout for one collective when the caller names
# none: a peer that died or hangs surfaces in the survivors as an
# exception within this bound (torch's own default is 30 minutes), which
# is what lets an elastic fleet's survivors take their rescue path
PROCESS_GROUP_TIMEOUT_S = 300.0

# the device `initialize` bound this process to (None before it runs)
_device = None


# ----------------------------------------------------------------- backoff

class Backoff:
    """Full-jitter exponential backoff under a max-elapsed-time cap.

    ``next_delay()`` returns how long to sleep before the next retry —
    drawn uniformly from [0, min(cap, base*2^attempt)] (the "full
    jitter" scheme: a rejoin storm of N workers decorrelates instead of
    hitting the coordinator in lockstep waves) — or ``None`` once the
    total elapsed time since the first call would exceed
    ``max_elapsed``. The last delay is clipped so sleeping it never
    overshoots the cap. ``pause()`` sleeps the next delay and returns
    True, or returns False when the budget is spent.

    clock/sleep/rng are injectable for tests; the default rng seeds from
    the pid, giving each fleet member its own jitter stream."""

    def __init__(self, base: float = 0.25, cap: float = 5.0,
                 max_elapsed: float = 60.0,
                 rng: Optional[random.Random] = None,
                 clock: Callable[[], float] = time.monotonic,
                 sleep: Callable[[float], None] = time.sleep):
        self.base = base
        self.cap = cap
        self.max_elapsed = max_elapsed
        self._rng = rng if rng is not None else random.Random(os.getpid())
        self._clock = clock
        self._sleep = sleep
        self._attempt = 0
        self._start: Optional[float] = None

    @property
    def attempts(self) -> int:
        return self._attempt

    def next_delay(self) -> Optional[float]:
        now = self._clock()
        if self._start is None:
            self._start = now
        remaining = (self._start + self.max_elapsed) - now
        if remaining <= 0:
            return None
        upper = min(self.cap, self.base * (2.0 ** self._attempt))
        self._attempt += 1
        return min(self._rng.uniform(0.0, upper), remaining)

    def pause(self) -> bool:
        """Sleep the next jittered delay; False when max_elapsed is spent."""
        delay = self.next_delay()
        if delay is None:
            return False
        self._sleep(delay)
        return True


def rendezvous_env(coordinator_address: str, process_id: int,
                   num_processes: int,
                   local_device_count: Optional[int] = None) -> dict:
    """The env-var block one process of a fleet needs (a plain dict)."""
    env = {
        ENV_COORDINATOR: str(coordinator_address),
        ENV_PROCESS_ID: str(int(process_id)),
        ENV_NUM_PROCESSES: str(int(num_processes)),
    }
    if local_device_count:
        env[ENV_LOCAL_DEVICE_COUNT] = str(int(local_device_count))
    return env


def env_contract_present(environ=None) -> bool:
    """True when the spawning layer wired this process for rendezvous."""
    e = os.environ if environ is None else environ
    return (ENV_COORDINATOR in e and ENV_PROCESS_ID in e
            and ENV_NUM_PROCESSES in e)


def contract_from_env(environ=None) -> dict:
    """Parse the rendezvous contract: {coordinator_address, process_id,
    num_processes, local_device_count} with absent fields as None."""
    e = os.environ if environ is None else environ

    def _int(var):
        return int(e[var]) if var in e else None

    return {
        "coordinator_address": e.get(ENV_COORDINATOR),
        "process_id": _int(ENV_PROCESS_ID),
        "num_processes": _int(ENV_NUM_PROCESSES),
        "local_device_count": _int(ENV_LOCAL_DEVICE_COUNT),
    }


def free_port(host: str = "127.0.0.1") -> int:
    """An OS-assigned free TCP port (bind-0 probe). Racy by nature —
    good enough for same-host fleets spawned immediately after."""
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        s.bind((host, 0))
        return s.getsockname()[1]


# --------------------------------------------------------------- lifecycle

def is_initialized() -> bool:
    """Whether torch.distributed's default process group is up."""
    import torch.distributed as dist

    return dist.is_available() and dist.is_initialized()


def shutdown() -> None:
    """Leave the fleet: a barrier of every rank, as the JAX package's
    shutdown waits for every process, so that no rank tears down (rank 0
    takes the rendezvous store with it) while another still works; then
    destroy the default process group. On gloo a peer that never reaches
    the barrier (it failed) is given up after SHUTDOWN_BARRIER_S. No-op
    when never initialized."""
    global _device
    if not is_initialized():
        return
    import torch.distributed as dist

    if dist.get_world_size() > 1:
        if dist.get_backend() == "gloo":
            try:
                dist.monitored_barrier(
                    timeout=timedelta(seconds=SHUTDOWN_BARRIER_S))
            except RuntimeError:
                pass  # a peer left first: tear down all the same
        else:
            dist.barrier()
    dist.destroy_process_group()
    _device = None


@contextlib.contextmanager
def simulated_group(rank: int, world: int, device=None):
    """Run the enclosed code as process `rank` of a fleet of `world`, in
    this process alone: the env contract's process id and count, torch's
    fake process group as the default group (collectives are issued and
    nothing moves: a received buffer keeps what it held) and `device` as
    this process's device. The group is destroyed and the environment
    restored on exit. Refuses to run while a process group is up: its
    collectives would reach real peers. `device` is CUDA unless the
    caller names another. What graftlint's trace stages run an entry
    under (analysis/collective_audit.py)."""
    global _device
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    from deeplearning4j_tpu_torch import resolve_device

    dev = resolve_device(device)
    if is_initialized():
        raise RuntimeError("a simulated process group runs only where no "
                           "process group is up: a live group's "
                           "collectives would reach its real peers")
    saved = {var: os.environ.get(var)
             for var in (ENV_PROCESS_ID, ENV_NUM_PROCESSES)}
    os.environ[ENV_PROCESS_ID] = str(int(rank))
    os.environ[ENV_NUM_PROCESSES] = str(int(world))
    bound = _device
    try:
        dist.init_process_group("fake", store=FakeStore(), rank=int(rank),
                                world_size=int(world))
        _device = dev
        yield
    finally:
        _device = bound
        if is_initialized():
            dist.destroy_process_group()
        for var, val in saved.items():
            if val is None:
                os.environ.pop(var, None)
            else:
                os.environ[var] = val


def process_device():
    """The device `initialize` bound this process to; for a process group
    brought up by other code, the one its backend implies (NCCL: the
    current CUDA device; gloo: the CPU)."""
    import torch
    import torch.distributed as dist

    if _device is not None:
        return _device
    if not is_initialized():
        raise RuntimeError("distributed.initialize() has not run in this "
                           "process")
    if dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def _resolve_process_device(device, process_id: int):
    """The process's one device: the caller's, else `ENV_DEVICE`, else
    CUDA. A bare ``cuda`` becomes ``cuda:<process_id>`` on a multi-card
    host (one process per card, the local launcher's numbering)."""
    import torch

    from deeplearning4j_tpu_torch import resolve_device

    dev = resolve_device(device if device is not None
                         else os.environ.get(ENV_DEVICE))
    if dev.type == "cuda" and dev.index is None:
        n = torch.cuda.device_count()
        dev = torch.device("cuda", process_id % n if n else 0)
    return dev


def _info(coordinator, attempts):
    import torch.distributed as dist

    return {"process_id": dist.get_rank(),
            "num_processes": dist.get_world_size(),
            "local_devices": 1,
            "global_devices": dist.get_world_size(),
            "backend": str(dist.get_backend()),
            "device": str(_device),
            "coordinator": coordinator, "attempts": attempts}


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None, *,
               device=None,
               connect_timeout: float = 90.0,
               max_backoff: float = 5.0,
               init_timeout: Optional[float] = None) -> dict:
    """Bring up torch.distributed with rendezvous hardening.

    Arguments default from the env contract (``rendezvous_env``); with
    no contract at all this process forms a fleet of one on a free local
    port (what a single-card run of the trainers needs). The process
    owns one device (`device`, else `ENV_DEVICE`, else ``cuda``): NCCL
    when it is a CUDA device, set as the current one; gloo on the CPU.
    Returns {process_id, num_processes, local_devices, global_devices,
    backend, device, coordinator, attempts} and emits one telemetry
    ``meta`` event plus a ``distributed_init`` span. Idempotent.

    connect_timeout / max_backoff: the retry loop around connect-time
    failures, full-jitter backoff capped at max_backoff seconds a wait
    under a connect_timeout total (`Backoff`). init_timeout: the
    process group's own timeout for one attempt and for its
    collectives (PROCESS_GROUP_TIMEOUT_S when None). An injected
    `delay-connect` fault (distributed/faults.py) sleeps before the
    rendezvous is dialed."""
    global _device
    import torch
    import torch.distributed as dist

    from deeplearning4j_tpu_torch.distributed.faults import active_faults
    from deeplearning4j_tpu_torch.telemetry.recorder import get_default

    # a late worker racing the rendezvous, before anything is dialed
    active_faults().delay_connect()

    contract = contract_from_env()
    if coordinator_address is None:
        coordinator_address = contract["coordinator_address"]
    if num_processes is None:
        num_processes = contract["num_processes"]
    if process_id is None:
        process_id = contract["process_id"]
    if coordinator_address is None:
        coordinator_address = f"127.0.0.1:{free_port()}"
        num_processes = 1 if num_processes is None else num_processes
        process_id = 0 if process_id is None else process_id

    rec = get_default()
    if is_initialized():
        info = _info(coordinator_address, 0)
        rec.event("span", name="distributed_init", ok=True, seconds=0.0,
                  already_initialized=True,
                  process_id=info["process_id"],
                  num_processes=info["num_processes"])
        return info

    dev = _resolve_process_device(device, int(process_id))
    backend = "nccl" if dev.type == "cuda" else "gloo"
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"this process's device is {dev} but CUDA is not available; "
                "pass device='cpu' for a gloo fleet on the CPU")
        torch.cuda.set_device(dev)
    kwargs = {"backend": backend,
              "init_method": f"tcp://{coordinator_address}",
              "world_size": int(num_processes), "rank": int(process_id)}
    kwargs["timeout"] = timedelta(
        seconds=PROCESS_GROUP_TIMEOUT_S if init_timeout is None
        else init_timeout)

    backoff = Backoff(base=0.25, cap=max_backoff,
                      max_elapsed=connect_timeout)
    with rec.span("distributed_init", process_id=process_id,
                  num_processes=num_processes,
                  coordinator=coordinator_address) as span:
        while True:
            try:
                dist.init_process_group(**kwargs)
                break
            except Exception as exc:
                if dist.is_initialized():
                    dist.destroy_process_group()
                if not backoff.pause():
                    rec.error("distributed_init", exc=exc,
                              attempt=backoff.attempts + 1,
                              process_id=process_id,
                              coordinator=coordinator_address)
                    raise
        _device = dev
        info = _info(coordinator_address, backoff.attempts + 1)
        span["attempts"] = backoff.attempts + 1
    rec.meta(distributed=info)
    return info
