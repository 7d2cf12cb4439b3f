"""Replica-scoped fault specs for serving chaos (JAX counterpart
deeplearning4j_tpu/distributed/faults.py, its `r` scope): the port's own
copy of the grammar, with the same `Fault` fields and `spec()` strings.

    r0:kill@batch3       replica 0 dies MID-BATCH while running its 3rd
                         assembled batch (a thread cannot be killed: the
                         engine fails that batch's requests loudly and
                         lets the thread end — serving/fleet.py)
    r1:hang@batch2       replica 1 wedges mid-batch (reaped by the fleet
                         supervisor's heartbeat staleness bound)
    r0:kill@decode5      a generation replica dies mid-decode at its 5th
                         decode step (active slots fail, pages release)

Specs join with `;` into a schedule. Replica faults take only kill/hang
with a batch/decode trigger. The process-scoped specs (`p1:kill@step3`,
`p0:delay-connect:1.5`, ...) drive the elastic multi-process training
fleet and wait for the rest of ROADMAP Queue A item A7: parsing one
raises ValueError. The exit classes the local launcher reports
(`EXIT_*`, `RESUMABLE_EXIT_CODE`) are here already, with the JAX
package's spellings.

Pure stdlib.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Sequence

KINDS = ("kill", "hang")

# Exit classes the launcher reports per fleet member
# (`launcher.classify_exit`), one spelling shared with telemetry events.
EXIT_CLEAN = "clean"
EXIT_SIGABRT = "sigabrt"
EXIT_DEADLINE = "deadline-reaped"
EXIT_INJECTED_KILL = "injected-kill"
EXIT_RESUMABLE = "resumable"
EXIT_ERROR = "error"

# Exit code a worker uses to say "I survived a peer's death and want to
# rejoin" (sysexits EX_TEMPFAIL).
RESUMABLE_EXIT_CODE = 75
REPLICA_UNITS = ("batch", "decode")


@dataclass(frozen=True)
class Fault:
    """One scheduled replica fault: what, to which replica
    (`process_id`, the JAX field name), and at which count of its own
    work unit."""

    process_id: int
    kind: str  # one of KINDS
    step: Optional[int] = None
    seconds: Optional[float] = None
    scope: str = "replica"
    unit: str = "batch"  # one of REPLICA_UNITS

    def spec(self) -> str:
        return f"r{self.process_id}:{self.kind}@{self.unit}{self.step}"


def parse_fault(spec: str) -> Fault:
    """Parse one `rN:kill|hang@batchK|decodeK` spec."""
    spec = spec.strip()
    head, _, rest = spec.partition(":")
    if head[:1] == "p" and head[1:].isdigit():
        raise ValueError(
            f"fault spec {spec!r}: process-scoped faults drive the "
            "multi-process fleet, which is not ported yet (ROADMAP Queue A "
            "item A7); serving takes 'r<N>:kill|hang@batch<K>|decode<K>'")
    if head[:1] != "r" or not head[1:].isdigit():
        raise ValueError(f"fault spec {spec!r}: expected 'r<N>:<kind>...'")
    kind, _, when = rest.partition("@")
    if kind not in KINDS:
        raise ValueError(f"fault spec {spec!r}: replica faults take only "
                         "kill/hang")
    for unit in REPLICA_UNITS:
        if when.startswith(unit):
            count = when[len(unit):]
            break
    else:
        raise ValueError(f"fault spec {spec!r}: replica faults need "
                         "'@batch<N>' or '@decode<N>'")
    if not count.isdigit():
        raise ValueError(f"fault spec {spec!r}: bad trigger {when!r}")
    return Fault(int(head[1:]), kind, step=int(count), unit=unit)


class FaultSchedule:
    """An ordered set of replica Faults."""

    def __init__(self, faults: Sequence[Fault] = ()):
        self.faults: List[Fault] = list(faults)

    @classmethod
    def parse(cls, specs) -> "FaultSchedule":
        """From a `;`-joined string or an iterable of spec strings."""
        if isinstance(specs, str):
            specs = [s for s in specs.split(";") if s.strip()]
        return cls([parse_fault(s) for s in specs])

    def to_env(self) -> str:
        return ";".join(f.spec() for f in self.faults)

    def for_replica(self, replica_index: int) -> List[Fault]:
        """The faults that target one serving worker."""
        return [f for f in self.faults if f.process_id == replica_index]

    def __iter__(self):
        return iter(self.faults)
