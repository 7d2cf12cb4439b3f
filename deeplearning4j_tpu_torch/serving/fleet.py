"""Zero-downtime fleet operations (JAX counterpart
deeplearning4j_tpu/serving/fleet.py): live weight hot-swap, replica
self-healing and telemetry-driven autoscaling, all off the request path.

* **Live weight hot-swap** — `hot_swap` restores a checkpoint step (the
  port's format, util/checkpoint.py) into a SHADOW net, a second param
  slot the replicas never read, on the engine net's device; checks it
  against the served set (the same leaves, each of the same shape, dtype
  and device); and publishes it through the `WeightStore`: one reference
  flip. A replica reads `store.current` exactly once per batch, so every
  in-flight and queued request completes against one coherent param set
  — generation N or N+1, never a mix — and each `request` event names
  the generation it served (`weight_gen`). The old `WeightSet` stays
  alive while a batch that read it runs: the batch holds the reference.
  A step that fails the checks (another architecture, a truncated model
  file, no committed step) raises `WeightSwapError` with the OLD weights
  still serving; either way a typed `weight_swap` event records step,
  restore_ms, generation and ok. `CheckpointWatcher` polls a directory
  and hot-swaps each newly committed step.

* **Replica self-healing** — `ReplicaFaultInjector` carries the
  replica-scoped fault specs (distributed/faults.py: `r0:kill@batch3`,
  `r1:hang@batch2`, `r0:kill@decode5`) into the engine's worker threads;
  `FleetSupervisor.poll` finds a death from the thread's liveness or a
  stale heartbeat, reaps it (fails the in-flight batch loudly, drains
  its queued batches back to the batcher), and respawns it after a
  `RespawnBackoff` delay, re-running warmup first: every bucket shape is
  already seen, so the trace count does not move.

* **Autoscaling** — `autoscale_decision` is a pure function of (queue
  depth, recent p99, replica count, clock, hysteresis state); the
  supervisor samples the engine and the recorder's ring buffer, emits an
  `autoscale` event per tick, and grows or drains replicas through
  `engine.add_replica()` / `engine.retire_replica()` (a retiring replica
  finishes its queued work first). The device-memory headroom signal
  (`recent_headroom`) reads the `memory` events of the engine's memory
  sampler (telemetry/memstat.py): on the card they carry the device's
  bytes in use and its limit; off the card they carry none and the
  signal is None, as the JAX package's is off the TPU.

Every decision surface is a pure function or takes an injectable clock,
so the tests drive the whole state machine with fake clocks and no
sleeps. This module is the one place that publishes params to a serving
engine; nothing else assigns a worker's live params.
"""

from __future__ import annotations

import os
import random
import threading
import time
from dataclasses import dataclass
from typing import Any, Optional

from deeplearning4j_tpu_torch.distributed.faults import FaultSchedule


class WeightSwapError(RuntimeError):
    """A hot-swap restore was rejected (shape/dtype/device mismatch,
    truncated checkpoint, no committed step); the old weights are still
    serving — a rejection never interrupts traffic."""


class ReplicaKilled(RuntimeError):
    """An injected replica death (`rN:kill@...`). A thread cannot be
    killed: the engine fails the in-flight batch loudly and lets the
    worker thread end; the supervisor requeues and respawns."""


# ------------------------------------------------------------ weight store

@dataclass(frozen=True)
class WeightSet:
    """One immutable published param set: a worker that read it serves
    all of it."""

    generation: int
    step: int
    params: Any
    state: Any


class WeightStore:
    """The double buffer behind live hot-swap. `current` is one attribute
    read of an immutable `WeightSet`; `publish` builds the new set
    completely before the one-reference flip, so a reader sees the old
    or the new generation, never a mix, and the old set stays intact for
    batches that already hold it. Publishers serialize on a lock;
    readers never lock."""

    def __init__(self, params, state, step: int = 0):
        self._current = WeightSet(0, int(step), params, state)
        self._lock = threading.Lock()
        self.last_swap_ts: Optional[float] = None

    @property
    def current(self) -> WeightSet:
        return self._current

    @property
    def generation(self) -> int:
        return self._current.generation

    @property
    def step(self) -> int:
        return self._current.step

    def publish(self, params, state, step: int) -> WeightSet:
        """Flip to a new generation; the assignment is the swap."""
        with self._lock:
            new = WeightSet(self._current.generation + 1, int(step),
                            params, state)
            self._current = new
            self.last_swap_ts = time.time()
            return new

    def describe(self) -> dict:
        return {"generation": self.generation, "step": self.step,
                "last_swap_ts": self.last_swap_ts}


def validate_swap(current_params, candidate_params) -> None:
    """The pre-flip gate: the candidate must hold the same leaves as the
    served params, each of the same shape and dtype and on the same
    device (a leaf on another device would fail mid-forward, after the
    flip). Raises `WeightSwapError` naming the first offending leaf."""
    from deeplearning4j_tpu_torch.util.checkpoint import tensor_leaves

    cur = tensor_leaves(current_params, "params")
    new = tensor_leaves(candidate_params, "params")
    if [p for p, _ in cur] != [p for p, _ in new]:
        raise WeightSwapError(
            f"param tree mismatch: serving {[p for p, _ in cur]} vs "
            f"candidate {[p for p, _ in new]}")
    for (path, a), (_, b) in zip(cur, new):
        if a.shape != b.shape or a.dtype != b.dtype:
            raise WeightSwapError(
                f"leaf {path} mismatch: serving {tuple(a.shape)}/{a.dtype} "
                f"vs candidate {tuple(b.shape)}/{b.dtype}")
        if a.device != b.device:
            raise WeightSwapError(
                f"leaf {path} is on {b.device}, the served params on "
                f"{a.device}")


# -------------------------------------------------------- restore + swap

def restore_for_serving(net, checkpoint_dir: str, step=None) -> int:
    """The serving restore: `resume_from` into `net` on its own device.
    Engines call this at startup; `hot_swap` calls it on a shadow net.
    Returns the restored step (0 = cold start)."""
    return int(net.resume_from(checkpoint_dir, step=step))


def _shadow_net(net):
    """A fresh net of the same configuration on the same device — the
    second param slot a restore fills; the serving net's params are
    never touched."""
    import copy

    shadow = type(net)(copy.deepcopy(net.conf), device=net.device)
    shadow.init()
    return shadow


def latest_step(checkpoint_dir: str) -> Optional[int]:
    """Newest committed step (meta.json is written last, so a step
    without one is mid-write), or None."""
    from deeplearning4j_tpu_torch.util.checkpoint import Checkpointer

    steps = Checkpointer(checkpoint_dir).steps()
    return steps[-1] if steps else None


def validate_checkpoint_shapes(current_params, checkpoint_dir: str,
                               step: int) -> None:
    """The PRE-restore gate: the manifest a step's meta.json recorded at
    save time must match the served params leaf for leaf in path, shape
    and dtype, and the model file must be whole (its recorded size). It
    reads no array data, so a checkpoint of another architecture is
    rejected before any read; an unreadable or truncated step fails the
    same gate (rejection is the safe direction — the old weights keep
    serving)."""
    from deeplearning4j_tpu_torch.util.checkpoint import (MODEL_FILE,
                                                         Checkpointer,
                                                         first_difference,
                                                         manifest)

    ck = Checkpointer(checkpoint_dir)
    try:
        meta = ck.read_meta(step)
        recorded = meta["leaves"]["params"]
        model_bytes = int(meta["model_bytes"])
    except (OSError, ValueError, KeyError, TypeError) as exc:
        raise WeightSwapError(
            f"checkpoint step {step} is unreadable: {exc!r}") from exc
    served = manifest(current_params, "params")
    if served != recorded:
        raise WeightSwapError(
            f"checkpoint step {step} param mismatch: "
            f"{first_difference(served, recorded)} — wrong architecture "
            "for this engine")
    path = os.path.join(ck.step_dir(step), MODEL_FILE)
    size = os.path.getsize(path) if os.path.exists(path) else None
    if size != model_bytes:
        raise WeightSwapError(
            f"checkpoint step {step} is truncated: {MODEL_FILE} holds "
            f"{size} bytes, its manifest {model_bytes}")


def hot_swap(engine, checkpoint_dir: str, step=None) -> dict:
    """Restore `step` (default: latest) into a shadow net OFF the
    request path, check it, and flip every replica onto the new
    generation. Emits the `weight_swap` event either way; on any failure
    the old weights keep serving and `WeightSwapError` carries the
    cause."""
    rec = engine.recorder
    t0 = time.perf_counter()
    try:
        if getattr(engine, "_workers", None):
            raise WeightSwapError(
                "generation engines hot-swap by rolling replica "
                "restart, not a live flip: an in-flight generation's "
                "KV cache binds it to the weights that wrote it")
        target = step if step is not None else latest_step(checkpoint_dir)
        if target is None:
            raise WeightSwapError(
                f"no committed checkpoint under {checkpoint_dir}")
        served = engine.weights.current.params
        validate_checkpoint_shapes(served, checkpoint_dir, target)
        shadow = _shadow_net(engine.net)
        restored = restore_for_serving(shadow, checkpoint_dir, step=target)
        validate_swap(served, shadow.params)
        new = engine.weights.publish(shadow.params, shadow.state, restored)
    except Exception as exc:
        restore_ms = round(1000.0 * (time.perf_counter() - t0), 3)
        rec.error("weight_swap", exc=exc)
        rec.event("weight_swap", ok=False, step=step,
                  restore_ms=restore_ms,
                  generation=engine.weights.generation,
                  error=f"{type(exc).__name__}: {exc}")
        if isinstance(exc, WeightSwapError):
            raise
        raise WeightSwapError(f"hot swap failed, old weights still "
                              f"serving: {exc}") from exc
    restore_ms = round(1000.0 * (time.perf_counter() - t0), 3)
    rec.event("weight_swap", ok=True, step=new.step,
              restore_ms=restore_ms, generation=new.generation)
    return {"step": new.step, "generation": new.generation,
            "restore_ms": restore_ms}


class CheckpointWatcher:
    """Follow a training job's checkpoint directory: each newly
    committed step hot-swaps into the engine. A step whose restore is
    REJECTED is remembered (never retried in a hot loop) and the old
    weights keep serving. `poll_once` is the testable unit; `start`
    wraps it in a daemon thread."""

    def __init__(self, engine, checkpoint_dir: str, *,
                 interval_s: float = 0.5):
        self.engine = engine
        self.checkpoint_dir = checkpoint_dir
        self.interval_s = float(interval_s)
        self.seen_step = int(engine.weights.step)
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def poll_once(self) -> Optional[dict]:
        """One watch tick: swap the newest unseen committed step, if
        any. Returns the swap record, a rejection record (`ok: False`),
        or None when nothing is new."""
        step = latest_step(self.checkpoint_dir)
        if step is None or step <= self.seen_step:
            return None
        self.seen_step = step  # even a rejected step is not retried
        try:
            out = hot_swap(self.engine, self.checkpoint_dir, step=step)
        except WeightSwapError as exc:
            return {"ok": False, "step": step, "error": str(exc)}
        out["ok"] = True
        return out

    def start(self) -> "CheckpointWatcher":
        def loop():
            while not self._stop.wait(self.interval_s):
                self.poll_once()

        self._thread = threading.Thread(target=loop, daemon=True,
                                        name="fleet-ckpt-watch")
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)


# ------------------------------------------------------- fault injection

class ReplicaFaultInjector:
    """Replica-scoped fault specs, fired inside the worker thread that
    owns the unit counter. One-shot per fault (a respawned replica
    restarts its counter; the same spec must not kill it forever). The
    `fault` event lands BEFORE the fault acts."""

    def __init__(self, schedule, recorder=None):
        if not isinstance(schedule, FaultSchedule):
            schedule = FaultSchedule.parse(schedule)
        self.faults = [f for f in schedule if f.scope == "replica"]
        self.recorder = recorder
        self._fired: set = set()
        self._lock = threading.Lock()

    def _rec(self):
        if self.recorder is not None:
            return self.recorder
        from deeplearning4j_tpu_torch.telemetry import get_default

        return get_default()

    def check(self, replica_index: int, unit: str, count: int) -> None:
        """Fire any scheduled fault for (replica, unit, count): kill
        raises `ReplicaKilled`; hang parks this thread for good (the
        supervisor's heartbeat bound reaps it)."""
        for f in self.faults:
            if (f.process_id != replica_index or f.unit != unit
                    or f.step != count):
                continue
            with self._lock:
                if f in self._fired:
                    continue
                self._fired.add(f)
            self._rec().fault(f"replica-{f.kind}", replica=replica_index,
                              spec=f.spec(), unit=unit, count=count,
                              fired=True)
            if f.kind == "kill":
                raise ReplicaKilled(f.spec())
            if f.kind == "hang":
                threading.Event().wait()  # for good; reaped by heartbeat


# ------------------------------------------------------- respawn backoff

class RespawnBackoff:
    """Exponential respawn delay with a deterministic, CAPPED jitter: a
    replica that keeps dying must not be respawned in a tight loop, and
    supervisors must not respawn in lockstep. Seeded stdlib Random: the
    same seed gives the same delays."""

    def __init__(self, base_s: float = 0.05, factor: float = 2.0,
                 cap_s: float = 2.0, jitter_frac: float = 0.2,
                 seed: int = 0):
        if not 0.0 <= jitter_frac <= 1.0:
            raise ValueError(f"jitter_frac must be in [0, 1], got "
                             f"{jitter_frac}")
        self.base_s = float(base_s)
        self.factor = float(factor)
        self.cap_s = float(cap_s)
        self.jitter_frac = float(jitter_frac)
        self._rng = random.Random(seed)
        self.attempt = 0

    def next(self) -> float:
        """Delay before the next respawn: min(base * factor^k, cap) plus
        jitter in [0, jitter_frac * delay], so the total never exceeds
        cap_s * (1 + jitter_frac)."""
        delay = min(self.base_s * (self.factor ** self.attempt),
                    self.cap_s)
        self.attempt += 1
        return delay + self._rng.uniform(0.0, self.jitter_frac * delay)

    def reset(self) -> None:
        """A replica that served again cleanly earns a fresh ladder."""
        self.attempt = 0


# ------------------------------------------------------------ autoscaling

@dataclass(frozen=True)
class AutoscalePolicy:
    """The hysteresis knobs. Scale UP when queue depth or recent p99
    crosses its high-water mark; scale DOWN only when BOTH are under the
    low-water marks. Separate cooldowns: growing is cheap and urgent,
    draining is neither. `min_headroom` (0 disables) is the device-memory
    floor: below it growth is vetoed and one replica drains."""

    min_replicas: int = 1
    max_replicas: int = 4
    up_queue_depth: int = 8
    down_queue_depth: int = 1
    up_p99_ms: float = float("inf")
    down_p99_ms: float = float("inf")
    cooldown_up_s: float = 0.25
    cooldown_down_s: float = 2.0
    min_headroom: float = 0.0


@dataclass
class AutoscaleState:
    """The supervisor's hysteresis memory."""

    last_up_t: float = float("-inf")
    last_down_t: float = float("-inf")


def autoscale_decision(policy: AutoscalePolicy, state: AutoscaleState, *,
                       queue_depth: int, p99_ms: float, n_replicas: int,
                       now: float, headroom: Optional[float] = None) -> int:
    """The pure scale decision: +1 (grow), -1 (drain one), or 0. Mutates
    only `state`. A scale-up also arms the DOWN cooldown so a burst's
    tail cannot drain what its head grew. `headroom` (fraction of device
    memory left, None = no signal) below `policy.min_headroom` vetoes
    growth and drains one replica on the DOWN cooldown."""
    breached = (policy.min_headroom > 0 and headroom is not None
                and headroom < policy.min_headroom)
    if breached:
        if n_replicas > policy.min_replicas \
                and now - state.last_down_t >= policy.cooldown_down_s:
            state.last_down_t = now
            return -1
        return 0
    over = (queue_depth >= policy.up_queue_depth
            or p99_ms >= policy.up_p99_ms)
    if over and n_replicas < policy.max_replicas \
            and now - state.last_up_t >= policy.cooldown_up_s:
        state.last_up_t = now
        state.last_down_t = now
        return 1
    under = (queue_depth <= policy.down_queue_depth
             and p99_ms <= policy.down_p99_ms)
    if under and n_replicas > policy.min_replicas \
            and now - state.last_down_t >= policy.cooldown_down_s \
            and now - state.last_up_t >= policy.cooldown_down_s:
        state.last_down_t = now
        return -1
    return 0


def recent_p99_ms(recorder, n: int = 64) -> float:
    """p99 of the last `n` successful `request` events' `total_s` in the
    recorder's in-memory ring — the supervisor's latency signal (0.0
    before any request completed)."""
    lat = [1000.0 * float(ev["total_s"]) for ev in list(recorder.events)
           if ev.get("event") == "request" and ev.get("ok")
           and "total_s" in ev][-n:]
    if not lat:
        return 0.0
    lat.sort()
    k = min(len(lat) - 1, max(0, int(round(0.99 * (len(lat) - 1)))))
    return lat[k]


def recent_headroom(recorder) -> Optional[float]:
    """Min per-device memory headroom (1 - bytes_in_use/bytes_limit) of
    the LATEST `memory` event in the recorder's ring, or None when no
    memory event carries device limits: no signal, not "plenty of room"
    (off the card a `memory` event carries no devices)."""
    for ev in reversed(list(recorder.events)):
        if ev.get("event") != "memory":
            continue
        ratios = []
        for row in (ev.get("devices") or {}).values():
            limit = float(row.get("bytes_limit", 0) or 0)
            if limit > 0:
                ratios.append(
                    1.0 - float(row.get("bytes_in_use", 0)) / limit)
        return min(ratios) if ratios else None
    return None


# ------------------------------------------------------------- supervisor

class FleetSupervisor:
    """The per-engine operations loop: replica self-healing plus
    (optionally) autoscaling. `poll(now)` is the whole state machine —
    injectable clock, no internal sleeps — and `run_in_thread` wraps it
    for a live fleet. Each tick:

    1. **Detect** — a worker is dead when it marked itself dead (the
       kill path), its thread ended without draining, or it holds a
       batch past `death_after_s` of heartbeat silence (the hang path).
    2. **Reap** — `engine.fleet_reap` fails the in-flight batch loudly
       and drains queued batches back to the batcher.
    3. **Respawn** — after the backoff delay, `engine.fleet_respawn`
       re-runs warmup (no new shape) and re-admits the worker; a
       `replica-respawn` fault event carries `respawn_ms`.
    4. **Autoscale** — with a policy: sample queue depth, recent p99
       and headroom, apply `autoscale_decision`, grow or drain through
       the engine, and emit an `autoscale` event.
    """

    def __init__(self, engine, *, policy: Optional[AutoscalePolicy] = None,
                 death_after_s: float = 2.0,
                 backoff: Optional[RespawnBackoff] = None,
                 clock=time.monotonic, recorder=None):
        self.engine = engine
        self.policy = policy
        self.death_after_s = float(death_after_s)
        self.backoff = backoff or RespawnBackoff()
        self._clock = clock
        self.recorder = recorder if recorder is not None else engine.recorder
        self.scale_state = AutoscaleState()
        self._respawn_due: dict = {}  # worker -> due time
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def _is_dead(self, w, now: float) -> bool:
        if not w.alive:
            return True  # marked itself dead (the kill path)
        thread = getattr(w, "_thread", None)
        if thread is not None and not thread.is_alive() \
                and w.lifecycle == "serving":
            return True  # ended without draining
        if getattr(w, "current_batch", None) is not None \
                and now - w.last_beat > self.death_after_s:
            return True  # wedged mid-batch: the heartbeat went stale
        return False

    def poll(self, now: Optional[float] = None) -> dict:
        now = self._clock() if now is None else now
        actions = {"reaped": [], "respawned": [], "scale": 0}
        for w in self.engine.fleet_workers():
            if w.lifecycle in ("draining", "retired"):
                continue  # a scale-down drain is not a death
            if w in self._respawn_due:
                continue
            if w.lifecycle == "dead" or self._is_dead(w, now):
                requeued = self.engine.fleet_reap(
                    w, reason="heartbeat-stale" if w.alive else "died")
                delay = self.backoff.next()
                self._respawn_due[w] = now + delay
                self.recorder.fault(
                    "replica-dead", replica=w.index, requeued=requeued,
                    respawn_in_s=round(delay, 4))
                actions["reaped"].append(w.index)
        for w, due in list(self._respawn_due.items()):
            if now < due:
                continue
            del self._respawn_due[w]
            t0 = time.perf_counter()
            self.engine.fleet_respawn(w)
            respawn_ms = round(1000.0 * (time.perf_counter() - t0), 3)
            self.backoff.reset()
            self.recorder.fault("replica-respawn", replica=w.index,
                                respawn_ms=respawn_ms)
            actions["respawned"].append(w.index)
        if self.policy is not None:
            snap = self.engine.fleet_snapshot()
            p99 = recent_p99_ms(self.recorder)
            headroom = recent_headroom(self.recorder)
            d = autoscale_decision(
                self.policy, self.scale_state,
                queue_depth=snap["queue_depth"], p99_ms=p99,
                n_replicas=snap["n_replicas"], now=now,
                headroom=headroom)
            if d > 0:
                self.engine.add_replica()
            elif d < 0:
                self.engine.retire_replica()
            actions["scale"] = d
            fields = {}
            if headroom is not None:
                fields["headroom"] = round(headroom, 4)
            self.recorder.event(
                "autoscale", n_serving=snap["n_serving"] + max(0, d),
                n_replicas=snap["n_replicas"] + d,
                queue_depth=snap["queue_depth"],
                p99_ms=round(p99, 3), action=d,
                max_replicas=self.policy.max_replicas, **fields)
        return actions

    def run_in_thread(self, interval_s: float = 0.05) -> "FleetSupervisor":
        def loop():
            while not self._stop.wait(interval_s):
                try:
                    self.poll()
                except Exception as exc:  # keep supervising; log loudly
                    self.recorder.error("fleet-supervisor", exc=exc)

        self._thread = threading.Thread(target=loop, daemon=True,
                                        name="fleet-supervisor")
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)


__all__ = [
    "AutoscalePolicy",
    "AutoscaleState",
    "CheckpointWatcher",
    "FleetSupervisor",
    "ReplicaFaultInjector",
    "ReplicaKilled",
    "RespawnBackoff",
    "WeightSet",
    "WeightStore",
    "WeightSwapError",
    "autoscale_decision",
    "hot_swap",
    "latest_step",
    "recent_headroom",
    "recent_p99_ms",
    "restore_for_serving",
    "validate_checkpoint_shapes",
    "validate_swap",
]
