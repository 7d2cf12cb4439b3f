"""Elastic fault-tolerant training: checkpoint-resume recovery for the
multi-process fleet (JAX counterpart deeplearning4j_tpu/distributed/
elastic.py).

The failure model: one worker dies mid-fit — SIGKILLed by a preemption
or the fault harness (`distributed/faults.py`), or wedged until the
launcher reaps it — and the survivors cannot simply continue: the
process group is broken and every further collective fails. Recovery is
therefore *generational*, the SparkNet coarse-sync shape
(arXiv:1511.06051), and all of it stays off the hot collective path
(arXiv:1810.11112):

1. **While healthy**, every process builds the post-step canonical
   trees in lockstep and rank 0 writes them (`util/checkpoint.py`, one
   writer under a multi-rank mesh): a process-count-portable checkpoint
   (restores onto N' processes, or 1).
2. **On a peer's death**, a surviving worker sees the failure as a
   Python exception — the process group's bounded timeout
   (`bootstrap.PROCESS_GROUP_TIMEOUT_S`) or a closed gloo connection —
   tries to checkpoint the last COMPLETED step (its params are untouched
   by the failed step) and exits `RESUMABLE_EXIT_CODE`; the cadence
   checkpoint covers a rescue save the broken world refuses.
3. **The supervisor** (`ElasticSupervisor`, launcher-side) classifies
   every exit, tears down the dead rendezvous (stragglers are reaped by
   the launch deadline; each generation gets a fresh rendezvous port),
   journals the re-form durably in its `ClusterCoordinator` config
   registry, and relaunches at N' = max(survivors, min_processes) —
   topping up with *replacement* workers when the floor requires it.
   Each member registers with that coordinator (`join_control_plane`):
   a survivor under its own worker id keeps its rank, a replacement
   adopts the lowest dead rank (`ClusterClient(replace_dead=True)`).
   The re-form re-*plans* the placement for the new fleet shape
   (`_replan` -> `reshard/search.py`, journaled as
   `elastic/placement/<gen>` and named in the `reform` fault event).
4. **Rejoining workers** search the same placement rank-independently
   (`searched_global_mesh`), restore the latest checkpoint and train on
   with the continuous step counter of `nn/training.fit_steps`, so the
   resumed run optimizes the batch sequence an uninterrupted run would.

The port runs one device per process, so a fleet of N processes is
`FleetShape(N, 1)`, where the JAX package's CPU fleets run K virtual
devices a process. Pure stdlib at import; torch inside the functions.
"""

from __future__ import annotations

import os
import sys
import time
from dataclasses import dataclass, field
from typing import Callable, List, Optional, Sequence

from deeplearning4j_tpu_torch.distributed import faults as faults_mod
from deeplearning4j_tpu_torch.distributed.faults import RESUMABLE_EXIT_CODE

# exit classes that mean "this worker is gone" (vs rejoining next gen)
_DEAD_CLASSES = frozenset({
    faults_mod.EXIT_SIGABRT, faults_mod.EXIT_DEADLINE,
    faults_mod.EXIT_INJECTED_KILL, faults_mod.EXIT_ERROR,
})

GEN_KEY = "elastic/gen"  # coordinator config key: last attempted generation
# supervisor -> worker: the step budget every generation trains toward
ENV_TOTAL_STEPS = "DL4J_TPU_ELASTIC_TOTAL_STEPS"
# supervisor -> worker: its control-plane coordinator, the worker ids of
# this generation's members in process-id order, and the ids among them
# that are replacements (they adopt a dead member's rank)
ENV_CONTROL = "DL4J_TPU_ELASTIC_CONTROL"
ENV_MEMBERS = "DL4J_TPU_ELASTIC_MEMBERS"
ENV_REPLACEMENTS = "DL4J_TPU_ELASTIC_REPLACEMENTS"
# the supervisor's coordinator declares a member dead after this long
# without a heartbeat: longer than a member's start-up between
# generations, while the supervisor holds the survivors in its alive set
CONTROL_HEARTBEAT_TIMEOUT_S = 60.0


# ------------------------------------------------------------ worker side

def searched_global_mesh(net=None, *, objective=None):
    """The elastic re-*plan*: a (re-)formed generation searches the best
    placement for its OWN fleet shape — `reshard/search.search_placement`
    over (process count, 1 device a process) — and builds the global
    mesh the winner names. The search is rank- and clock-independent, so
    every member computes the identical winner without coordination, and
    each emits the typed `placement_search` telemetry event before any
    mesh exists.

    Returns ``(mesh, axes, result)``: the mesh over every rank, the
    role->axis dict for ``net.resume_from(..., target_mesh=mesh,
    target_axes=axes)`` or ``set_mesh(mesh, axes=axes)``, and the full
    ranked `SearchResult` (``result.winner`` is the Placement). Call
    after `bootstrap.initialize`."""
    import torch.distributed as dist

    from deeplearning4j_tpu_torch.distributed.global_mesh import (
        make_global_mesh,
    )
    from deeplearning4j_tpu_torch.reshard import search as search_mod

    fleet = search_mod.FleetShape(dist.get_world_size(), 1)
    profile = (search_mod.profile_net(net) if net is not None
               else search_mod.GENERIC_PROFILE)
    t0 = time.perf_counter()
    result = _search_with_batch_fallback(profile, fleet, objective)
    search_mod.emit_search_event(
        result, path="elastic",
        search_ms=(time.perf_counter() - t0) * 1e3,
        process_id=dist.get_rank(),
        num_processes=dist.get_world_size())
    winner = result.winner
    mesh = make_global_mesh(dict(winner.mesh_axes))
    axes = {role: ax for role, ax in winner.roles}
    return mesh, axes, result


def _search_with_batch_fallback(profile, fleet, objective):
    """A re-plan must never kill the fleet over a MODELING mismatch:
    when every candidate dies on batch divisibility (the objective's
    proxy batch, not the worker's real one), re-model with the nearest
    batch that tiles the fleet and search again. Genuine infeasibility
    (e.g. nothing fits the memory budget) still raises."""
    import dataclasses

    from deeplearning4j_tpu_torch.reshard import search as search_mod

    objective = objective or search_mod.Objective()
    try:
        return search_mod.search_placement(profile, fleet,
                                           objective=objective)
    except search_mod.SearchError:
        b = objective.global_batch
        rounded = -(-b // fleet.n_devices) * fleet.n_devices
        if rounded == b:
            raise
        return search_mod.search_placement(
            profile, fleet,
            objective=dataclasses.replace(objective,
                                          global_batch=rounded))


def join_control_plane():
    """This member's `ClusterClient` on the supervisor's coordinator,
    from the env the supervisor gives every generation (None outside an
    `ElasticSupervisor` launch): worker id ``members[process id]``,
    registered with ``replace_dead`` when it is a replacement, so it
    adopts the lowest dead member's rank (`client.rank`,
    `client.reassigned_from`)."""
    from deeplearning4j_tpu_torch.distributed import bootstrap
    from deeplearning4j_tpu_torch.parallel.cluster import ClusterClient

    e = os.environ
    address = e.get(ENV_CONTROL)
    if not address:
        return None
    members = e.get(ENV_MEMBERS, "").split(",")
    worker = members[int(e[bootstrap.ENV_PROCESS_ID])]
    replacement = worker in e.get(ENV_REPLACEMENTS, "").split(",")
    return ClusterClient(address, worker, replace_dead=replacement)


def run_elastic_steps(net, batch_for_step, total_steps: int, *,
                      checkpoint_dir: str, checkpoint_every: int = 1):
    """The worker-side elastic fit loop (call after
    `bootstrap.initialize` and `net.resume_from(checkpoint_dir,
    target_mesh=mesh, target_axes=axes)` with the generation's searched
    placement (`searched_global_mesh`): the restore through the
    resharding engine, which leaves the net placed on the global mesh).

    Runs `nn/training.fit_steps` from the net's restored step to
    ``total_steps``; after each completed step the canonical trees are
    checkpointed every ``checkpoint_every`` steps (plus always at the
    final step), and any kill/hang fault scheduled for that step fires.
    Under an `ElasticSupervisor` the member first registers with its
    control plane (`join_control_plane`; the `elastic_resume` span
    names its worker id and rank). A peer's death surfacing as a Python
    exception triggers the rescue path: checkpoint the last completed
    step, emit the telemetry trail, and exit ``RESUMABLE_EXIT_CODE`` so
    the supervisor counts this worker as a survivor for the next
    generation.
    """
    import torch.distributed as dist

    from deeplearning4j_tpu_torch.nn.training import fit_steps
    from deeplearning4j_tpu_torch.telemetry.recorder import get_default
    from deeplearning4j_tpu_torch.util.checkpoint import Checkpointer

    rec = get_default()
    ckptr = Checkpointer(checkpoint_dir)
    faults = faults_mod.active_faults()
    start = net.iteration_count
    client = join_control_plane()

    def on_step(step):
        if step % checkpoint_every == 0 or step == total_steps:
            ckptr.save(net, step)
        faults.check_step(step)

    # a typed "I am resuming from `start`" mark in this process's JSONL
    rec.event("span", name="elastic_resume", ok=True, seconds=0.0,
              start_step=start, total_steps=total_steps,
              process_id=dist.get_rank(),
              num_processes=dist.get_world_size(),
              worker=client.worker_id if client else None,
              coordinator_rank=client.rank if client else None,
              reassigned_from=client.reassigned_from if client else None)
    try:
        fit_steps(net, batch_for_step, total_steps, on_step=on_step)
    except Exception as exc:
        # a dead peer lands here as the failed collective's error; the
        # params still hold the last COMPLETED step
        rec.error("elastic_step", exc=exc, step=net.iteration_count)
        try:
            ckptr.save(net, net.iteration_count)
            saved = True
        except Exception as save_exc:  # broken world: cadence ckpt covers
            rec.error("elastic_rescue_save", exc=save_exc,
                      step=net.iteration_count)
            saved = False
        rec.fault("peer-loss-exit", step=net.iteration_count,
                  rescue_checkpoint=saved, resumable=True)
        raise SystemExit(RESUMABLE_EXIT_CODE)
    finally:
        if client is not None:
            client.close()
    return net


# -------------------------------------------------------- supervisor side

@dataclass
class FleetGeneration:
    """One launch attempt: its size, per-process results, and the death
    accounting that sized the next generation."""

    gen: int
    n_processes: int
    results: list
    exit_classes: List[str] = field(default_factory=list)
    members: List[str] = field(default_factory=list)
    seconds: float = 0.0

    @property
    def dead(self) -> List[int]:
        return [r.process_id for r in self.results
                if r.exit_class in _DEAD_CLASSES]

    @property
    def clean(self) -> bool:
        return all(r.exit_class == faults_mod.EXIT_CLEAN
                   for r in self.results)


@dataclass
class ElasticRunResult:
    generations: List[FleetGeneration]
    total_steps: int

    @property
    def final_n(self) -> int:
        return self.generations[-1].n_processes


class ElasticError(RuntimeError):
    """The fleet could not finish within max_reforms generations."""


class ElasticSupervisor:
    """Launcher-side recovery supervisor: run a worker fleet to
    completion across worker deaths.

    ``argv`` is the worker program (it must follow the worker-side
    contract above: restore from ``checkpoint_dir``, run
    `run_elastic_steps`, exit 0 when ``total_steps`` is reached). Each
    generation launches through `launcher.launch_local` on ``device``
    (one device a process: ``cuda:<i>`` or the CPU) — fresh rendezvous
    port, wall-clock deadline as the hard straggler bound — and the
    supervisor journals every generation into a durable
    `ClusterCoordinator` (``snapshot_path``): a restarted supervisor
    resumes the generation count, and members register with the same
    coordinator, replacements through its ``replace_dead`` rank
    adoption. ``faults`` (a `FaultSchedule`) applies to generation 0
    only — the injected failure, not an afterlife curse.
    """

    def __init__(self, argv: Sequence[str], *, n_processes: int,
                 checkpoint_dir: str, total_steps: int,
                 min_processes: int = 1, max_reforms: int = 3,
                 device: str = "cuda",
                 gen_timeout: float = 240.0, grace: float = 5.0,
                 death_grace: float = 20.0,
                 faults=None, snapshot_path: Optional[str] = None,
                 extra_env: Optional[dict] = None,
                 echo: Optional[Callable[[str], None]] = None,
                 cwd: Optional[str] = None):
        if min_processes < 1:
            raise ValueError("min_processes must be >= 1")
        if min_processes > n_processes:
            raise ValueError("min_processes cannot exceed n_processes")
        self.argv = list(argv)
        self.n_processes = n_processes
        self.checkpoint_dir = checkpoint_dir
        self.total_steps = total_steps
        self.min_processes = min_processes
        self.max_reforms = max_reforms
        self.device = device
        self.gen_timeout = gen_timeout
        self.grace = grace
        # dead-rendezvous teardown: after the first death, survivors get
        # this long to rescue-checkpoint and exit resumable on their own
        # before the launcher reaps them
        self.death_grace = death_grace
        self.faults = (faults_mod.FaultSchedule.parse(faults)
                       if faults is not None
                       and not isinstance(faults, faults_mod.FaultSchedule)
                       else faults)
        self.extra_env = dict(extra_env or {})
        self.echo = echo
        self.cwd = cwd
        from deeplearning4j_tpu_torch.parallel.cluster import (
            ClusterCoordinator,
        )

        # the durable control plane: generation journal + rank registry
        # (replacement workers adopt dead ranks through it); with
        # snapshot_path every re-form survives a supervisor restart too
        self.coordinator = ClusterCoordinator(
            heartbeat_timeout=CONTROL_HEARTBEAT_TIMEOUT_S,
            snapshot_path=snapshot_path).start()

    def close(self) -> None:
        self.coordinator.shutdown()

    # ------------------------------------------------------------- run
    def run(self) -> ElasticRunResult:
        from deeplearning4j_tpu_torch.distributed.launcher import (
            launch_local,
        )
        from deeplearning4j_tpu_torch.telemetry.recorder import (
            ENV_VAR,
            get_default,
        )
        from deeplearning4j_tpu_torch.telemetry.trace import (
            MemoryWatch,
            StragglerWatch,
        )

        rec = get_default()
        generations: List[FleetGeneration] = []
        gen = int(self.coordinator.read_config(GEN_KEY, -1)) + 1
        n = self.n_processes
        members = [f"w{i}" for i in range(n)]
        replacements: List[str] = []
        env = dict(self.extra_env)
        env.setdefault(ENV_TOTAL_STEPS, str(self.total_steps))
        env[ENV_CONTROL] = self.coordinator.address
        # the heartbeat-path straggler consumer: while a generation
        # runs, tail its per-process telemetry shards and put typed
        # `anomaly` events on the record the moment the fleet's step
        # completions skew (or a member stalls)
        tpath = env.get(ENV_VAR) or os.environ.get(ENV_VAR)
        watch = StragglerWatch(tpath, recorder=rec) if tpath else None
        # the memory-path consumer, same shape: the leak / headroom /
        # cost-drift detectors over the shards' `memory` and
        # `cost_drift` events (a worker's fit samples memory at the
        # DL4J_TPU_MEM_EVERY cadence)
        memwatch = MemoryWatch(tpath, recorder=rec) if tpath else None

        def on_poll():
            if watch is not None:
                watch.poll()
            if memwatch is not None:
                memwatch.poll()

        while True:
            self.coordinator.record_config(GEN_KEY, gen)
            env[ENV_MEMBERS] = ",".join(members)
            env[ENV_REPLACEMENTS] = ",".join(replacements)
            with rec.span("elastic_generation", gen=gen, n_processes=n,
                          members=list(members),
                          replacements=list(replacements)) as span:
                t0 = time.perf_counter()
                results = launch_local(
                    self.argv, n, device=self.device,
                    timeout=self.gen_timeout, grace=self.grace,
                    death_grace=self.death_grace,
                    faults=self.faults if gen == 0 else None,
                    extra_env=env, echo=self.echo, cwd=self.cwd,
                    on_poll=on_poll if tpath else None)
                if watch is not None:
                    # one forced pass over the generation's full record
                    # so a skew that landed between polls still makes
                    # the journal before the re-form decision
                    watch.poll(force=True)
                    span["straggler_anomalies"] = len(watch.findings)
                if memwatch is not None:
                    memwatch.poll(force=True)
                    span["memory_anomalies"] = len(memwatch.findings)
                g = FleetGeneration(
                    gen=gen, n_processes=n, results=results,
                    exit_classes=[r.exit_class for r in results],
                    members=list(members),
                    seconds=time.perf_counter() - t0)
                generations.append(g)
                span["exit_classes"] = g.exit_classes
                self.coordinator.record_config(
                    f"elastic/members/{gen}",
                    {"n_processes": n, "exit_classes": g.exit_classes,
                     "members": list(members),
                     "replacements": list(replacements)})
            if g.clean:
                return ElasticRunResult(generations=generations,
                                        total_steps=self.total_steps)
            dead = set(g.dead)
            survivors = [w for i, w in enumerate(members) if i not in dead]
            n_next = max(len(survivors), self.min_processes)
            if len(generations) > self.max_reforms:
                raise ElasticError(
                    f"fleet did not finish within {self.max_reforms} "
                    f"re-forms; exit classes per generation: "
                    f"{[h.exit_classes for h in generations]}")
            # the control plane's view of the re-form: the dead leave the
            # alive set (their ranks become adoptable), the survivors are
            # held in it across the relaunch, and the replacements get
            # fresh worker ids
            for i in sorted(dead):
                self.coordinator.deregister(members[i])
            for w in survivors:
                self.coordinator.register(w)
            taken = set(self.coordinator.known_workers())
            fresh = (f"w{k}" for k in range(10 ** 6)
                     if f"w{k}" not in taken)
            replacements = [next(fresh)
                            for _ in range(n_next - len(survivors))]
            replan = self._replan(n_next, gen=gen + 1)
            self.coordinator.record_config(
                f"elastic/placement/{gen + 1}", replan.winner.to_json())
            rec.fault("reform", gen=gen + 1, n_processes=n_next,
                      survivors=len(survivors),
                      replacements=len(replacements),
                      replacement_workers=list(replacements),
                      dead=sorted(dead), prior_exit_classes=g.exit_classes,
                      placement=replan.winner.describe(),
                      straggler_anomalies=(len(watch.findings)
                                           if watch is not None else 0))
            gen += 1
            n = n_next
            members = survivors + replacements

    def _replan(self, n_processes: int, *, gen: int):
        """The supervisor half of the elastic re-plan: rank the next
        generation's fleet shape BEFORE relaunching — the re-formed
        workers re-derive the identical winner rank-independently
        through `searched_global_mesh` — and put the search on the
        record (`placement_search` event, path="reform") plus the
        durable coordinator journal. With no model in-process the
        generic profile ranks data-axis coverage and the zero1 choice."""
        from deeplearning4j_tpu_torch.reshard import search as search_mod

        fleet = search_mod.FleetShape(n_processes, 1)
        t0 = time.perf_counter()
        result = _search_with_batch_fallback(search_mod.GENERIC_PROFILE,
                                             fleet, None)
        search_mod.emit_search_event(
            result, path="reform", gen=gen,
            search_ms=(time.perf_counter() - t0) * 1e3)
        return result


def worker_total_steps(default: Optional[int] = None) -> int:
    """The supervisor-announced step budget, from the env it gives every
    generation (worker-side convenience for `run_elastic_steps` callers).
    """
    val = os.environ.get(ENV_TOTAL_STEPS)
    if val is None:
        if default is None:
            raise KeyError(f"{ENV_TOTAL_STEPS} is not set — launch "
                           "through ElasticSupervisor or pass "
                           "total_steps explicitly")
        return default
    return int(val)


def main_argv(worker_script: str, *args: str) -> List[str]:
    """`argv` for a python worker script run by the current interpreter."""
    return [sys.executable, worker_script, *list(args)]
