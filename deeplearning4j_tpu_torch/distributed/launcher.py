"""Local multi-process fleet launcher (JAX counterpart
deeplearning4j_tpu/distributed/launcher.py) — what makes the port's
multi-rank paths testable on one host.

Spawns N OS processes running the same program, each wired with the
rendezvous env contract (`distributed/bootstrap.py`) and given ONE
device through `bootstrap.ENV_DEVICE`: ``cuda:<i>`` for process i, or
the CPU (where the JAX package's launcher hands each process virtual
CPU devices). Per-process stdout/stderr is streamed line by line with a
``[pN]`` prefix and kept for post-mortems; a wall-clock deadline
terminates and then kills stragglers, so a wedged rendezvous or
collective can never hang a test run.

``launch_plan`` renders the same fleet as copy-pastable shell lines.
``faults=`` hands a process-scoped fault schedule (distributed/faults.py)
to the members it names through the env contract, and a SIGKILL the
schedule named is classified ``injected-kill``.
"""

from __future__ import annotations

import os
import shlex
import signal
import subprocess
import threading
import time
from dataclasses import dataclass, field
from typing import Callable, List, Optional, Sequence

from deeplearning4j_tpu_torch.distributed import bootstrap
from deeplearning4j_tpu_torch.distributed import faults as faults_mod
from deeplearning4j_tpu_torch.distributed.bootstrap import free_port

__all__ = ["ProcessResult", "classify_exit", "free_port", "launch_local",
           "launch_plan"]


@dataclass
class ProcessResult:
    """Outcome of one fleet member: exit code (None when the reaper had
    to kill a straggler that never reported one), captured log lines,
    whether the launch deadline expired on it, and the classified exit
    (`classify_exit`)."""

    process_id: int
    returncode: Optional[int] = None
    lines: List[str] = field(default_factory=list)
    timed_out: bool = False
    exit_class: str = ""

    @property
    def output(self) -> str:
        return "\n".join(self.lines)


def classify_exit(returncode: Optional[int], timed_out: bool,
                  kill_injected: bool = False) -> str:
    """One fleet member's exit, as a class a supervisor can act on:
    ``deadline-reaped`` (never exited; reaped at the deadline),
    ``clean`` (0), ``resumable`` (`faults.RESUMABLE_EXIT_CODE`),
    ``injected-kill`` (SIGKILL that the fault schedule named),
    ``sigabrt``, else ``error``."""
    if timed_out:
        return faults_mod.EXIT_DEADLINE
    if returncode == 0:
        return faults_mod.EXIT_CLEAN
    if returncode == faults_mod.RESUMABLE_EXIT_CODE:
        return faults_mod.EXIT_RESUMABLE
    if returncode == -signal.SIGKILL and kill_injected:
        return faults_mod.EXIT_INJECTED_KILL
    if returncode == -signal.SIGABRT:
        return faults_mod.EXIT_SIGABRT
    return faults_mod.EXIT_ERROR


def _process_env(coordinator: str, process_id: int, n_processes: int,
                 device: str, extra_env: Optional[dict]) -> dict:
    """The env block of process `process_id`: the rendezvous contract
    and its one device (``cuda:<process_id>`` for ``device="cuda"``)."""
    env = bootstrap.rendezvous_env(coordinator, process_id, n_processes)
    env[bootstrap.ENV_DEVICE] = (f"cuda:{process_id}" if device == "cuda"
                                 else str(device))
    if extra_env:
        env.update(extra_env)
    return env


def _pump(proc, process_id: int, lines: List[str],
          echo: Optional[Callable[[str], None]]) -> None:
    """Reader thread: stream one process's merged stdout/stderr into its
    result (and through `echo` with the ``[pN]`` prefix)."""
    for raw in iter(proc.stdout.readline, b""):
        line = raw.decode("utf-8", errors="replace").rstrip("\n")
        lines.append(line)
        if echo is not None:
            echo(f"[p{process_id}] {line}")
    proc.stdout.close()


def launch_local(argv: Sequence[str], n_processes: int = 2, *,
                 device: str = "cuda",
                 timeout: float = 300.0, grace: float = 5.0,
                 coordinator_port: Optional[int] = None,
                 extra_env: Optional[dict] = None,
                 echo: Optional[Callable[[str], None]] = None,
                 cwd: Optional[str] = None,
                 faults=None,
                 death_grace: Optional[float] = None,
                 on_poll: Optional[Callable[[], None]] = None
                 ) -> List[ProcessResult]:
    """Run ``argv`` as an N-process rendezvous fleet on this host.

    Every child gets the env contract (coordinator on a free local port
    unless ``coordinator_port`` pins one) and its device: process i
    owns ``cuda:i`` (``device="cuda"``, the default) or the CPU
    (``device="cpu"``, gloo). Blocks until every process exits or
    ``timeout`` seconds elapse; on expiry the whole fleet is terminated,
    then killed after ``grace`` seconds — stragglers are always reaped.
    Results arrive in process-id order with captured logs and a
    classified exit, each also echoed as a ``[pN] -- exit: <class>``
    epilogue line; ``echo`` (e.g. ``print``) streams lines live.

    ``faults``: a `faults.FaultSchedule` (or spec string / list) given
    to the processes it names through `bootstrap.ENV_FAULTS`; every
    injected fault and every observed exit class is a typed telemetry
    ``fault`` event, so the run reads from the JSONL alone.

    ``death_grace``: once any member exits with neither 0 nor the
    resumable code, the rest get this many seconds to exit on their own
    (the rescue path) before being reaped (survivors of a dead peer
    otherwise wait in the broken collective until the process group's
    timeout or the deadline). None keeps the deadline as the sole
    reaper.

    ``on_poll``: called on every monitor pass while the fleet runs (the
    elastic supervisor's straggler and memory watches tail the
    per-process telemetry there). Its exceptions are contained: a
    broken watcher never kills the launch, and each distinct failure is
    put on the record once as an ``error`` event (where ``on_poll``)."""
    from deeplearning4j_tpu_torch.telemetry.recorder import get_default

    if faults is not None and not isinstance(faults,
                                             faults_mod.FaultSchedule):
        faults = faults_mod.FaultSchedule.parse(faults)
    coordinator = f"127.0.0.1:{coordinator_port or free_port()}"
    argv = list(argv)
    procs: List[subprocess.Popen] = []
    threads: List[threading.Thread] = []
    results = [ProcessResult(i) for i in range(n_processes)]
    rec = get_default()
    with rec.span("distributed_launch", n_processes=n_processes,
                  argv0=argv[0], coordinator=coordinator) as span:
        if faults is not None:
            for f in faults:
                rec.fault(f.kind, process_id=f.process_id, step=f.step,
                          spec=f.spec(), injected=True)
        base = dict(os.environ)
        for i in range(n_processes):
            env = dict(base)
            env.update(_process_env(coordinator, i, n_processes, device,
                                    extra_env))
            if faults is not None and faults.for_process(i):
                env[bootstrap.ENV_FAULTS] = faults.to_env()
            p = subprocess.Popen(argv, env=env, cwd=cwd,
                                 stdout=subprocess.PIPE,
                                 stderr=subprocess.STDOUT)
            t = threading.Thread(target=_pump,
                                 args=(p, i, results[i].lines, echo),
                                 daemon=True)
            t.start()
            procs.append(p)
            threads.append(t)
        deadline = time.monotonic() + timeout
        death_at = None
        poll_errors = set()
        pending = set(range(n_processes))
        while pending:
            now = time.monotonic()
            if now >= deadline or (death_at is not None
                                   and now >= death_at):
                break
            for i in sorted(pending):
                rc = procs[i].poll()
                if rc is None:
                    continue
                results[i].returncode = rc
                pending.discard(i)
                if death_grace is not None and death_at is None and \
                        rc not in (0, faults_mod.RESUMABLE_EXIT_CODE):
                    death_at = time.monotonic() + death_grace
                    span["death_grace_tripped_by"] = i
            if on_poll is not None:
                try:
                    on_poll()
                except Exception as exc:  # advisory: the launch goes on
                    if repr(exc) not in poll_errors:
                        poll_errors.add(repr(exc))
                        rec.error("on_poll", exc=exc)
            if pending:
                time.sleep(0.05)
        stragglers = [i for i, p in enumerate(procs) if p.poll() is None]
        if stragglers:
            for i in stragglers:
                results[i].timed_out = True
                procs[i].terminate()
            kill_at = time.monotonic() + grace
            for i in stragglers:
                try:
                    procs[i].wait(timeout=max(kill_at - time.monotonic(),
                                              0.1))
                except subprocess.TimeoutExpired:
                    procs[i].kill()
                    procs[i].wait()
        for i, p in enumerate(procs):
            if results[i].returncode is None and not results[i].timed_out:
                results[i].returncode = p.poll()
        for t in threads:
            t.join(timeout=2.0)
        for r in results:
            injected = (faults is not None
                        and faults.kill_scheduled(r.process_id))
            r.exit_class = classify_exit(r.returncode, r.timed_out,
                                         kill_injected=injected)
            epilogue = (f"-- exit: {r.exit_class} "
                        f"(rc={r.returncode}, timed_out={r.timed_out})")
            r.lines.append(epilogue)
            if echo is not None:
                echo(f"[p{r.process_id}] {epilogue}")
            rec.fault(r.exit_class, process_id=r.process_id,
                      returncode=r.returncode, timed_out=r.timed_out,
                      observed_exit=True)
            if r.exit_class not in (faults_mod.EXIT_CLEAN,
                                    faults_mod.EXIT_RESUMABLE,
                                    faults_mod.EXIT_INJECTED_KILL,
                                    faults_mod.EXIT_DEADLINE):
                rec.error("distributed_launch",
                          error=f"p{r.process_id} {r.exit_class}",
                          traceback_str="\n".join(r.lines[-40:]),
                          process_id=r.process_id,
                          returncode=r.returncode)
        span["returncodes"] = [r.returncode for r in results]
        span["exit_classes"] = [r.exit_class for r in results]
        span["timed_out"] = [r.process_id for r in results if r.timed_out]
    return results


def launch_plan(argv: Sequence[str], n_processes: int = 2, *,
                device: str = "cuda",
                coordinator: Optional[str] = None) -> List[str]:
    """The same fleet as printable shell lines (dry run): one
    env-prefixed command per process, backgrounded, plus a ``wait``."""
    coordinator = coordinator or f"127.0.0.1:{free_port()}"
    cmd = " ".join(shlex.quote(a) for a in argv)
    lines = []
    for i in range(n_processes):
        env = _process_env(coordinator, i, n_processes, device, None)
        prefix = " ".join(f"{k}={shlex.quote(v)}"
                          for k, v in sorted(env.items()))
        lines.append(f"{prefix} {cmd} &")
    lines.append("wait")
    return lines
