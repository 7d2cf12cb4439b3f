"""Deterministic fault injection for the multi-process fleet and for
serving chaos (JAX counterpart deeplearning4j_tpu/distributed/faults.py:
the port's own copy of its grammar, `Fault` fields, `spec()` strings and
hooks).

A fleet that has never been killed mid-step has an untested recovery
path; this module makes worker death, hangs, slow joins, and silent
heartbeat loss reproducible so `distributed/elastic.py`'s recovery
supervisor (and the tests) exercise them on demand.

**Spec syntax** — one fault per spec, `;`-joined into a schedule:

    p1:kill@step3        SIGKILL process 1 right after its step 3 completes
    p2:hang@step4        process 2 stops making progress after step 4
    p0:delay-connect:1.5 process 0 sleeps 1.5 s before dialing the rendezvous
    p1:drop-heartbeat    process 1 silently stops heartbeating its
                         ClusterClient (coordinator reaps it; its slot
                         becomes claimable)

Serving chaos uses the same grammar with an `r` scope prefix — the
victim is a REPLICA (a serving worker thread inside one engine,
serving/engine.py) rather than a fleet process, and the trigger counts
that replica's own work units instead of training steps:

    r0:kill@batch3       replica 0 dies MID-BATCH while running its 3rd
                         assembled batch (a thread cannot be killed: the
                         engine fails that batch's requests loudly and
                         lets the thread end — serving/fleet.py)
    r1:hang@batch2       replica 1 wedges mid-batch (reaped by the fleet
                         supervisor's heartbeat staleness bound)
    r0:kill@decode5      a generation replica dies mid-decode at its 5th
                         decode step (active slots fail, pages release)

Replica faults take only kill/hang with a batch/decode trigger; process
faults keep the step trigger — mixing the two is a parse error.

The schedule travels to fleet members through the env contract
(`bootstrap.ENV_FAULTS`, set by `launcher.launch_local(faults=...)`);
each process filters the schedule by its own `ENV_PROCESS_ID`, so one
string describes the whole fleet. Every fired fault emits a typed
telemetry `fault` event BEFORE acting (the recorder flushes per line, so
even a SIGKILL leaves its evidence in the JSONL).

Pure stdlib.
"""

from __future__ import annotations

import os
import random
import signal
import time
from dataclasses import dataclass
from typing import Callable, List, Optional, Sequence

from deeplearning4j_tpu_torch.distributed import bootstrap

KINDS = ("kill", "hang", "delay-connect", "drop-heartbeat")

# Exit classes the launcher reports per fleet member (see
# `launcher.classify_exit`). One spelling, shared with telemetry events
# and the elastic supervisor's death accounting.
EXIT_CLEAN = "clean"
EXIT_SIGABRT = "sigabrt"
EXIT_DEADLINE = "deadline-reaped"
EXIT_INJECTED_KILL = "injected-kill"
EXIT_RESUMABLE = "resumable"
EXIT_ERROR = "error"

# Exit code a worker uses to say "I survived a peer's death, checkpointed
# the last completed step, and want to rejoin the next generation"
# (sysexits EX_TEMPFAIL — a transient, retryable condition).
RESUMABLE_EXIT_CODE = 75


# trigger units per scope: process faults fire on training steps,
# replica faults on a serving worker's own batch / decode-step counters
SCOPES = ("process", "replica")
REPLICA_UNITS = ("batch", "decode")


@dataclass(frozen=True)
class Fault:
    """One scheduled fault: what, to whom, and when. ``process_id`` names
    the victim within its scope — a fleet process for scope "process", a
    serving replica index for scope "replica"."""

    process_id: int
    kind: str  # one of KINDS
    step: Optional[int] = None      # kill/hang trigger count
    seconds: Optional[float] = None  # delay-connect sleep
    scope: str = "process"          # one of SCOPES
    unit: str = "step"              # "step" | "batch" | "decode"

    def spec(self) -> str:
        prefix = "p" if self.scope == "process" else "r"
        s = f"{prefix}{self.process_id}:{self.kind}"
        if self.step is not None:
            s += f"@{self.unit}{self.step}"
        if self.seconds is not None:
            s += f":{self.seconds:g}"
        return s


def parse_fault(spec: str) -> Fault:
    """Parse one `pN:kind[@stepK][:seconds]` / `rN:kind@batchK|decodeK`
    spec (see module docstring)."""
    spec = spec.strip()
    head, _, rest = spec.partition(":")
    if not head[:1] in ("p", "r") or not head[1:].isdigit():
        raise ValueError(f"fault spec {spec!r}: expected 'p<N>:<kind>...' "
                         "or 'r<N>:<kind>...'")
    scope = "process" if head[0] == "p" else "replica"
    process_id = int(head[1:])
    kind, step, seconds, unit = rest, None, None, "step"
    if "@" in rest:
        kind, _, when = rest.partition("@")
        for u in ("step",) + REPLICA_UNITS:
            if when.startswith(u):
                unit, when = u, when[len(u):]
                break
        if not when.isdigit():
            raise ValueError(f"fault spec {spec!r}: bad trigger {when!r}")
        step = int(when)
    elif ":" in rest:
        kind, _, secs = rest.partition(":")
        seconds = float(secs)
    if kind not in KINDS:
        raise ValueError(f"fault spec {spec!r}: unknown kind {kind!r} "
                         f"(one of {', '.join(KINDS)})")
    if scope == "replica":
        if kind not in ("kill", "hang"):
            raise ValueError(f"fault spec {spec!r}: replica faults take "
                             "only kill/hang")
        if step is None or unit not in REPLICA_UNITS:
            raise ValueError(f"fault spec {spec!r}: replica faults need "
                             "'@batch<N>' or '@decode<N>'")
    else:
        if unit != "step":
            raise ValueError(f"fault spec {spec!r}: process faults "
                             "trigger on '@step<N>', not {unit!r}")
        if kind in ("kill", "hang") and step is None:
            raise ValueError(f"fault spec {spec!r}: {kind} needs "
                             "'@step<N>'")
        if kind == "delay-connect" and seconds is None:
            raise ValueError(f"fault spec {spec!r}: delay-connect needs "
                             "':<seconds>'")
    return Fault(process_id, kind, step=step, seconds=seconds,
                 scope=scope, unit=unit)


class FaultSchedule:
    """An ordered set of Faults for one fleet launch."""

    def __init__(self, faults: Sequence[Fault] = ()):
        self.faults: List[Fault] = list(faults)

    @classmethod
    def parse(cls, specs) -> "FaultSchedule":
        """From a `;`-joined string or an iterable of spec strings."""
        if isinstance(specs, str):
            specs = [s for s in specs.split(";") if s.strip()]
        return cls([parse_fault(s) for s in specs])

    @classmethod
    def seeded(cls, seed: int, n_processes: int, max_step: int,
               kinds: Sequence[str] = ("kill", "hang")) -> "FaultSchedule":
        """A deterministic one-fault schedule: the same seed always names
        the same victim, kind, and step (stdlib Random — reproducible
        across platforms and interpreter runs, unlike hash())."""
        rng = random.Random(seed)
        kind = kinds[rng.randrange(len(kinds))]
        victim = rng.randrange(n_processes)
        fault = Fault(victim, kind, step=rng.randint(1, max_step))
        return cls([fault])

    def to_env(self) -> str:
        return ";".join(f.spec() for f in self.faults)

    def for_process(self, process_id: int) -> List[Fault]:
        return [f for f in self.faults if f.process_id == process_id
                and f.scope == "process"]

    def for_replica(self, replica_index: int) -> List[Fault]:
        """Replica-scoped faults targeting one serving worker (the
        serving engine's chaos hooks — serving/fleet.py)."""
        return [f for f in self.faults if f.process_id == replica_index
                and f.scope == "replica"]

    def kill_scheduled(self, process_id: int) -> bool:
        return any(f.kind == "kill" for f in self.for_process(process_id))

    def __iter__(self):
        return iter(self.faults)

    def __len__(self):
        return len(self.faults)


class FaultRuntime:
    """The in-process half: the hooks a fleet member consults.

    Constructed by `active_faults()` from the env contract; a process
    outside any schedule gets an empty runtime whose hooks cost one
    attribute read. `_sleep`/`_kill` are injectable for unit tests.
    """

    def __init__(self, faults: Sequence[Fault] = (),
                 process_id: Optional[int] = None,
                 sleep: Callable[[float], None] = time.sleep,
                 kill: Callable[[int, int], None] = os.kill):
        self.faults = list(faults)
        self.process_id = process_id
        self._sleep = sleep
        self._kill = kill

    def _emit(self, fault: Fault, **fields) -> None:
        from deeplearning4j_tpu_torch.telemetry.recorder import get_default

        get_default().fault(fault.kind, process_id=self.process_id,
                            step=fault.step, spec=fault.spec(), fired=True,
                            **fields)

    @property
    def drop_heartbeat(self) -> bool:
        """True when this process must silently stop heartbeating its
        ClusterClient (consulted once per heartbeat thread)."""
        return any(f.kind == "drop-heartbeat" for f in self.faults)

    def delay_connect(self) -> float:
        """Sleep any scheduled pre-rendezvous delay (called by
        `bootstrap.initialize` before dialing); returns seconds slept."""
        total = 0.0
        for f in self.faults:
            if f.kind == "delay-connect" and f.seconds:
                self._emit(f, seconds=f.seconds)
                self._sleep(f.seconds)
                total += f.seconds
        return total

    def check_step(self, step: int) -> None:
        """Fire any kill/hang scheduled at `step` (called by the elastic
        step loop after the step completes — so the injected death
        happens between a completed collective and the next one, the
        same place a real preemption lands)."""
        for f in self.faults:
            if f.step != step:
                continue
            if f.kind == "kill":
                self._emit(f)
                self._kill(os.getpid(), signal.SIGKILL)
            elif f.kind == "hang":
                self._emit(f)
                while True:  # reaped by the launcher's wall-clock deadline
                    self._sleep(3600.0)


_EMPTY = FaultRuntime()


def active_faults(environ=None) -> FaultRuntime:
    """This process's FaultRuntime from the env contract: the schedule in
    `ENV_FAULTS` filtered by `ENV_PROCESS_ID`. Re-parses per call (cheap,
    and monkeypatched environments in tests take effect immediately);
    returns a shared empty runtime when no schedule targets us."""
    e = os.environ if environ is None else environ
    raw = e.get(bootstrap.ENV_FAULTS)
    pid_s = e.get(bootstrap.ENV_PROCESS_ID)
    if not raw or pid_s is None:
        return _EMPTY
    process_id = int(pid_s)
    mine = FaultSchedule.parse(raw).for_process(process_id)
    if not mine:
        return _EMPTY
    return FaultRuntime(mine, process_id=process_id)
