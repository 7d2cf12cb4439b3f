"""Multi-process / multi-host control plane (JAX counterpart
deeplearning4j_tpu/parallel/cluster.py: the port's own copy, with the
same wire protocol, so a client of either package talks to a
coordinator of the other).

Replaces the reference's scaleout stack — the Akka master/worker actors
with heartbeat-based dead-worker removal
(`deeplearning4j-scaleout/deeplearning4j-scaleout-akka/.../MasterActor.java:61-158`),
the ZooKeeper configuration registry
(`deeplearning4j-scaleout-zookeeper/.../ZooKeeperConfigurationRegister.java`),
and the Hazelcast distributed state tracker (`HazelCastStateTracker.java`) —
with a single small TCP coordinator plus worker clients:

- **ClusterCoordinator**: registry (worker ranks), heartbeat monitor with
  dead-worker removal, a JSON config registry, synchronization barriers,
  and synchronous parameter-averaging rounds (the Spark master's
  aggregate-and-broadcast, elastic: a round completes with whoever is
  still alive when a contributor dies mid-round). With `snapshot_path`
  the registry/claim state persists to JSON on every mutation and a
  restarted coordinator reloads it (HazelCastStateTracker semantics) —
  paired with the client's reconnect-and-re-register, the control plane
  itself is no longer a single in-memory point of failure.
- **ClusterClient**: register/heartbeat/config/barrier/average calls.
- **run_elastic_worker**: the worker training loop — local steps on the
  worker's data shard, parameter averaging every `sync_every` steps,
  a checkpoint after each sync, resume-from-checkpoint on restart
  (elastic recovery: kill a worker, restart it, it rejoins from the last
  checkpoint). The checkpoint is the port's own format
  (util/checkpoint.py, a directory), where the JAX package writes a
  ModelSerializer zip.
- **initialize_multihost**: brings up `torch.distributed` through
  `distributed.bootstrap.initialize`; this module's coordinator still
  provides registration/heartbeat/elastic restart around it.

The wire protocol is a newline-delimited JSON control line, optionally
followed by a length-prefixed raw float32 frame (the JSON line carries
`payload_bytes`): control messages stay human-debuggable JSON while
parameter vectors travel as binary — no base64 bloat (~33%) and no full
string copy per round, so 100MB+ models move at socket speed. Latency is
amortized: one round-trip per averaging round, not per step.

Pure stdlib and numpy at import; torch only inside `run_elastic_worker`.
"""

from __future__ import annotations

import json
import os
import socket
import socketserver
import threading
import time
from typing import Dict, Optional

import numpy as np


def _to_bytes(arr: np.ndarray) -> bytes:
    return np.ascontiguousarray(arr, np.float32).tobytes()


def _from_bytes(payload: bytes) -> np.ndarray:
    return np.frombuffer(payload, np.float32).copy()


def _send_msg(sock: socket.socket, obj, payload: Optional[bytes] = None) -> None:
    """One message = JSON header line (+ optional raw binary frame whose
    length the header announces in `payload_bytes`)."""
    if payload is not None:
        obj = dict(obj, payload_bytes=len(payload))
    sock.sendall((json.dumps(obj) + "\n").encode())
    if payload:  # separate send: no header+payload concatenation copy
        sock.sendall(payload)


# Upper bound on a single binary frame (1 GiB ~= a 268M-param float32
# flat view — far above any model this coordinator averages). A corrupt
# or hostile header cannot make the peer allocate arbitrary memory in one
# read. Module-level and read at CALL time, so genuinely
# larger models raise it process-wide (cluster.MAX_FRAME_BYTES = ...),
# or per-endpoint via the max_frame_bytes constructor args.
MAX_FRAME_BYTES = 1 << 30


def _recv_msg(fileobj, max_frame_bytes: Optional[int] = None):
    """Read (msg, payload) from a BINARY buffered stream; payload is None
    for pure-control messages (header without `payload_bytes`) and b"" for
    an announced zero-length frame."""
    cap = MAX_FRAME_BYTES if max_frame_bytes is None else max_frame_bytes
    line = fileobj.readline()
    if not line:
        raise ConnectionError("peer closed")
    msg = json.loads(line)
    n = msg.pop("payload_bytes", None)
    payload = None
    if n is not None:
        n = int(n)
        if n < 0 or n > cap:
            raise ConnectionError(
                f"frame of {n} bytes exceeds the {cap}-byte "
                "limit (corrupt header? raise cluster.MAX_FRAME_BYTES "
                "for larger models)")
        payload = fileobj.read(n)
        if payload is None or len(payload) < n:
            raise ConnectionError("peer closed mid-payload")
    return msg, payload


class _Round:
    """One synchronous averaging/barrier round."""

    def __init__(self):
        self.contributions: Dict[str, np.ndarray] = {}
        self.done = threading.Event()
        self.result: Optional[np.ndarray] = None
        self.result_bytes: Optional[bytes] = None


class ClusterCoordinator:
    """Master actor + config registry + state tracker in one process.

    Start with `coord = ClusterCoordinator().start()`; workers connect to
    `coord.address`. `heartbeat_timeout` controls dead-worker removal
    (reference MasterActor clears disconnected workers on heartbeat,
    MasterActor.java:111-158).
    """

    def __init__(self, host: str = "127.0.0.1", port: int = 0,
                 heartbeat_timeout: float = 10.0,
                 round_timeout: Optional[float] = None,
                 snapshot_path: Optional[str] = None):
        self.heartbeat_timeout = heartbeat_timeout
        # max wall time an averaging round waits for alive-but-silent
        # workers before finishing without them (progress guarantee; a
        # worker whose local step takes longer than this is misconfigured)
        self.round_timeout = (round_timeout if round_timeout is not None
                              else 6.0 * heartbeat_timeout)
        self._lock = threading.RLock()
        self._workers: Dict[str, dict] = {}
        self._ranks: Dict[str, int] = {}  # stable across re-registration
        self._configs: Dict[str, dict] = {}
        self._next_rank = 0
        self._avg_rounds: Dict[int, _Round] = {}
        self._barriers: Dict[str, _Round] = {}
        # durable registry/claim state (HazelCastStateTracker semantics):
        # every mutation snapshots {ranks, configs, workers} to JSON, and a
        # restarted coordinator reloads it — shard claims (config keys
        # "shard_owner/<s>") and ranks survive a coordinator crash, so the
        # fleet resumes instead of re-sharding from scratch. In-flight
        # averaging rounds are NOT persisted: contributors' reconnect
        # logic simply re-submits and a fresh round forms.
        self.snapshot_path = snapshot_path
        if snapshot_path and os.path.exists(snapshot_path):
            with open(snapshot_path) as fh:
                snap = json.load(fh)
            self._ranks = {w: int(r) for w, r in snap.get("ranks", {}).items()}
            self._next_rank = int(snap.get("next_rank", len(self._ranks)))
            self._configs = dict(snap.get("configs", {}))
            # restored workers start provisionally alive: their clients'
            # heartbeats re-confirm within one interval, and treating them
            # dead instead would let a fast re-claimer steal their shard
            # slots during the restart gap
            now = time.monotonic()
            self._workers = {w: {"rank": self._ranks[w], "last_seen": now}
                             for w in snap.get("workers", [])
                             if w in self._ranks}

        coord = self

        class Handler(socketserver.StreamRequestHandler):
            def handle(self):
                try:
                    while True:
                        msg, payload = _recv_msg(self.rfile)
                        reply, reply_payload = coord._dispatch(msg, payload)
                        _send_msg(self.request, reply, reply_payload)
                except (ConnectionError, OSError, json.JSONDecodeError):
                    pass

        class Server(socketserver.ThreadingTCPServer):
            allow_reuse_address = True
            daemon_threads = True

        self._server = Server((host, port), Handler)
        self.address = "%s:%d" % self._server.server_address
        self._thread = threading.Thread(target=self._server.serve_forever,
                                        daemon=True)

    # ------------------------------------------------------------ lifecycle
    def start(self) -> "ClusterCoordinator":
        self._thread.start()
        return self

    def shutdown(self) -> None:
        self._server.shutdown()
        self._server.server_close()

    @property
    def port(self) -> int:
        """Bound TCP port (rebind a restarted coordinator to the same one
        so reconnecting clients find it)."""
        return self._server.server_address[1]

    def _save_snapshot(self) -> None:
        """Persist registry/claim state; call under self._lock after every
        mutation. Atomic tmp+replace so a crash mid-write leaves the
        previous snapshot intact."""
        if not self.snapshot_path:
            return
        snap = {"version": 1, "ranks": self._ranks,
                "next_rank": self._next_rank, "configs": self._configs,
                "workers": sorted(self._workers)}
        tmp = self.snapshot_path + ".tmp"
        with open(tmp, "w") as fh:
            json.dump(snap, fh)
        os.replace(tmp, self.snapshot_path)

    # ------------------------------------------------------------- queries
    def record_config(self, key: str, value) -> None:
        """In-process config write (no socket round-trip) — the elastic
        supervisor journals fleet generations through this, making every
        re-form durable in the same snapshot the ranks live in."""
        with self._lock:
            self._configs[key] = value
            self._save_snapshot()

    def read_config(self, key: str, default=None):
        with self._lock:
            return self._configs.get(key, default)

    def register(self, worker: str) -> int:
        """In-process registration (the wire op's semantics): marks
        `worker` alive now and returns its rank, stable across
        re-registration — the elastic supervisor holds a re-form's
        survivors in the alive set this way while they relaunch."""
        return self._dispatch({"op": "register", "worker": worker})[0]["rank"]

    def deregister(self, worker: str) -> None:
        """In-process deregistration: `worker` leaves the alive set (its
        rank stays reserved to it, and becomes adoptable by a
        ``replace_dead`` registration)."""
        self._dispatch({"op": "deregister", "worker": worker})

    def known_workers(self) -> list:
        """Every worker id the registry has ever ranked, alive or not."""
        with self._lock:
            return sorted(self._ranks)

    def alive_workers(self):
        now = time.monotonic()
        with self._lock:
            dead = [w for w, info in self._workers.items()
                    if now - info["last_seen"] > self.heartbeat_timeout]
            for w in dead:  # dead-worker removal (MasterActor semantics)
                del self._workers[w]
            if dead:
                self._save_snapshot()
            return dict(self._workers)

    # ------------------------------------------------------------ dispatch
    def _dispatch(self, msg: dict, payload: Optional[bytes] = None):
        """Returns (reply_dict, reply_payload_bytes_or_None)."""
        op = msg.get("op")
        if op == "register":
            with self._lock:
                wid = msg["worker"]
                reassigned_from = None
                if wid not in self._ranks and msg.get("replace_dead"):
                    # elastic replacement: a NEW worker adopts the
                    # lowest rank whose owner left the alive set (died,
                    # deregistered, or heartbeat-expired), so a re-formed
                    # fleet keeps a dense [0, N') rank space instead of
                    # growing fresh ranks past dead ones. A known wid
                    # never reassigns — rejoining workers keep their own
                    # rank (the snapshot-restore invariant).
                    alive = self.alive_workers()
                    for old, rank in sorted(self._ranks.items(),
                                            key=lambda kv: kv[1]):
                        if old not in alive:
                            del self._ranks[old]
                            self._ranks[wid] = rank
                            reassigned_from = old
                            break
                if wid not in self._ranks:
                    self._ranks[wid] = self._next_rank
                    self._next_rank += 1
                self._workers[wid] = {"rank": self._ranks[wid],
                                      "last_seen": time.monotonic()}
                self._save_snapshot()
                return {"ok": True, "rank": self._ranks[wid],
                        "reassigned_from": reassigned_from,
                        "n_workers": len(self._workers),
                        "heartbeat_timeout": self.heartbeat_timeout,
                        "round_timeout": self.round_timeout}, None
        if op == "heartbeat":
            with self._lock:
                if msg["worker"] in self._workers:
                    self._workers[msg["worker"]]["last_seen"] = time.monotonic()
                    return {"ok": True}, None
            return {"ok": False, "error": "unknown worker (re-register)"}, None
        if op == "deregister":
            with self._lock:
                self._workers.pop(msg["worker"], None)
                self._save_snapshot()
            return {"ok": True}, None
        if op == "workers":
            return {"ok": True, "workers": sorted(self.alive_workers())}, None
        if op == "set_config":
            with self._lock:
                self._configs[msg["key"]] = msg["value"]
                self._save_snapshot()
            return {"ok": True}, None
        if op == "get_config":
            with self._lock:
                if msg["key"] not in self._configs:
                    return {"ok": False, "error": "no such config"}, None
                return {"ok": True, "value": self._configs[msg["key"]]}, None
        if op == "claim_slot":
            # atomic data-shard claim (the read-modify-write happens under
            # the coordinator lock — a set_config/get_config read-back is
            # racy): assign the caller the lowest slot in [0, n_slots)
            # that is unclaimed, already its own, or whose owner left the
            # alive set. Claims live in the config registry under
            # "shard_owner/<s>" so operators can inspect them.
            with self._lock:
                alive = set(self.alive_workers())
                wid = msg["worker"]
                n = int(msg["n_slots"])
                # the caller's EXISTING claim wins over reassignable
                # slots: otherwise a re-claiming worker could be handed a
                # lower dead-owner slot while still registered as its old
                # slot's (alive) owner, orphaning that shard forever
                for s in range(n):
                    if self._configs.get(f"shard_owner/{s}") == wid:
                        return {"ok": True, "slot": s}, None
                for s in range(n):
                    key = f"shard_owner/{s}"
                    owner = self._configs.get(key)
                    if owner is None or owner not in alive:
                        self._configs[key] = wid
                        self._save_snapshot()
                        return {"ok": True, "slot": s}, None
                return {"ok": True, "slot": None}, None
        if op == "average":
            return self._average(msg, payload)
        if op == "barrier":
            return self._barrier(msg), None
        return {"ok": False, "error": f"unknown op {op!r}"}, None

    # ----------------------------------------------------- averaging round
    def _average(self, msg: dict, payload: bytes):
        step = int(msg["step"])
        worker = msg["worker"]
        arr = _from_bytes(payload)
        with self._lock:
            if worker in self._workers:
                self._workers[worker]["last_seen"] = time.monotonic()
            rnd = self._avg_rounds.setdefault(step, _Round())
            if not rnd.done.is_set():
                rnd.contributions[worker] = arr
                if set(rnd.contributions) >= set(self.alive_workers()):
                    self._finish_round(rnd)
        # elastic completion: the liveness re-check finishes the round as
        # soon as every still-alive worker has contributed (dead workers
        # drop out via heartbeat expiry); round_timeout is the last-resort
        # progress guarantee against alive-but-stuck contributors
        deadline = time.monotonic() + self.round_timeout
        while not rnd.done.wait(timeout=0.05):
            with self._lock:
                if not rnd.done.is_set() and (
                        set(rnd.contributions) >= set(self.alive_workers())
                        or time.monotonic() > deadline):
                    self._finish_round(rnd)
        with self._lock:
            # completed rounds stay cached so a straggler contributing to an
            # already-finished step gets the same result instead of opening
            # (and hanging on) a fresh round; prune well-past steps
            for old in [k for k in self._avg_rounds if k < step - 16]:
                del self._avg_rounds[old]
        return ({"ok": True, "n": len(rnd.contributions)},
                rnd.result_bytes)

    def _finish_round(self, rnd: _Round) -> None:
        if rnd.done.is_set():
            return
        rnd.result = np.mean(list(rnd.contributions.values()), axis=0)
        # serialize ONCE per round, not once per contributor's reply
        rnd.result_bytes = _to_bytes(rnd.result)
        rnd.done.set()

    # -------------------------------------------------------------- barrier
    def _barrier(self, msg: dict) -> dict:
        name = msg["name"]
        worker = msg["worker"]
        with self._lock:
            rnd = self._barriers.setdefault(name, _Round())
            rnd.contributions[worker] = np.zeros(0)
            if set(rnd.contributions) >= set(self.alive_workers()):
                rnd.done.set()
        deadline = time.monotonic() + self.round_timeout
        while not rnd.done.wait(timeout=0.05):
            with self._lock:
                if (set(rnd.contributions) >= set(self.alive_workers())
                        or time.monotonic() > deadline):
                    rnd.done.set()
        with self._lock:
            self._barriers.pop(name, None)
        return {"ok": True}


class ClusterClient:
    """Worker-side connection to the coordinator (one socket, heartbeats on
    a daemon thread — the worker actor's heartbeat loop).

    Survives a coordinator restart: calls and heartbeats that hit a dead
    socket reconnect with backoff for up to ``reconnect_timeout`` seconds
    and re-register (ranks and shard claims are stable — the restarted
    coordinator reloads them from its snapshot), so a fleet rides through
    a kill-and-restart of the control plane without losing claims."""

    def __init__(self, address: str, worker_id: str,
                 heartbeat_interval: float = 1.0,
                 reconnect_timeout: float = 30.0,
                 replace_dead: bool = False):
        host, port = address.rsplit(":", 1)
        self.address = (host, int(port))
        self.worker_id = worker_id
        self.reconnect_timeout = reconnect_timeout
        # replacement worker (elastic re-form): adopt the lowest rank
        # whose owner is no longer alive instead of minting a new one
        self.replace_dead = replace_dead
        self.reassigned_from = None
        self._lock = threading.Lock()
        self._sock = None
        self._file = None
        with self._lock:
            self._reconnect()  # initial connect retries like any other
        self._hb_stop = threading.Event()
        self._hb = threading.Thread(
            target=self._heartbeat_loop, args=(heartbeat_interval,),
            daemon=True)
        self._hb.start()

    def _connect_once(self) -> None:
        """One connection + registration attempt (caller holds _lock)."""
        if self._sock is not None:
            try:
                self._sock.close()
            except OSError:
                pass
        self._sock = socket.create_connection(self.address, timeout=120)
        self._file = self._sock.makefile("rb")
        reg = {"op": "register", "worker": self.worker_id}
        if self.replace_dead:
            reg["replace_dead"] = True
        _send_msg(self._sock, reg)
        reply, _ = _recv_msg(self._file)
        self.rank = reply["rank"]
        self.reassigned_from = reply.get("reassigned_from")
        # a blocked average() waits up to the server's round_timeout; give
        # the socket comfortable headroom beyond it
        self._sock.settimeout(2.0 * reply.get("round_timeout", 60.0) + 60.0)

    def _reconnect(self) -> None:
        """Connect/re-register with FULL-JITTER exponential backoff until
        reconnect_timeout (caller holds _lock) — the window a restarting
        coordinator has to come back up. Jitter matters here even more
        than in the rendezvous bootstrap: after an elastic re-form every
        surviving worker reconnects at once, and synchronized retry
        waves are exactly the thundering herd a tiny single-threaded
        accept queue cannot absorb."""
        from deeplearning4j_tpu_torch.distributed.bootstrap import Backoff

        backoff = Backoff(base=0.1, cap=2.0,
                          max_elapsed=self.reconnect_timeout)
        while True:
            try:
                self._connect_once()
                return
            except (ConnectionError, OSError):
                if not backoff.pause():
                    raise

    def _call(self, msg: dict, payload: Optional[bytes] = None):
        msg = dict(msg, worker=self.worker_id)
        with self._lock:
            deadline = time.monotonic() + self.reconnect_timeout
            while True:
                try:
                    _send_msg(self._sock, msg, payload)
                    reply, reply_payload = _recv_msg(self._file)
                    break
                except (ConnectionError, OSError):
                    # dead socket (coordinator restart?): the ops are safe
                    # to re-send — registration/config/claims are
                    # idempotent and an average contribution is keyed by
                    # (step, worker). deregister is NOT retried: a dead
                    # coordinator forgets us anyway.
                    if (msg.get("op") == "deregister"
                            or time.monotonic() > deadline):
                        raise
                    self._reconnect()
        if not reply.get("ok"):
            raise RuntimeError(f"coordinator error: {reply.get('error')}")
        return reply, reply_payload

    def _heartbeat_loop(self, interval: float) -> None:
        # injected `drop-heartbeat` fault: this worker goes silent (the
        # coordinator reaps it after heartbeat_timeout and its shard slot
        # becomes claimable) while the process itself stays alive — the
        # partial-failure mode a kill can't simulate
        from deeplearning4j_tpu_torch.distributed.faults import active_faults
        from deeplearning4j_tpu_torch.telemetry.recorder import get_default

        faults = active_faults()
        if faults.drop_heartbeat:
            get_default().fault("drop-heartbeat", worker=self.worker_id,
                                fired=True)
            return
        # separate connection so heartbeats never queue behind a long
        # averaging round; a broken socket is dropped and re-dialed on the
        # next beat (coordinator-restart tolerance)
        sock = None
        f = None
        while not self._hb_stop.wait(interval):
            try:
                if sock is None:
                    sock = socket.create_connection(self.address, timeout=30)
                    f = sock.makefile("rb")
                _send_msg(sock, {"op": "heartbeat", "worker": self.worker_id})
                reply, _ = _recv_msg(f)
                if not reply.get("ok") and not self._hb_stop.is_set():
                    # demoted after a transient stall: re-register (the
                    # coordinator keeps ranks stable across re-registration).
                    # The _hb_stop guard avoids re-registering a worker whose
                    # close() already deregistered it (in-flight heartbeat).
                    _send_msg(sock, {"op": "register",
                                     "worker": self.worker_id})
                    _recv_msg(f)
            except (OSError, ConnectionError):
                if sock is not None:
                    try:
                        sock.close()
                    except OSError:
                        pass
                sock = None
        if sock is not None:
            try:
                sock.close()
            except OSError:
                pass

    # ---------------------------------------------------------------- API
    def workers(self):
        return self._call({"op": "workers"})[0]["workers"]

    def set_config(self, key: str, value) -> None:
        self._call({"op": "set_config", "key": key, "value": value})

    def get_config(self, key: str, default=None):
        """Config value, or `default` for a key nobody has set."""
        try:
            return self._call({"op": "get_config", "key": key})[0]["value"]
        except RuntimeError as e:
            if "no such config" in str(e):
                return default
            raise

    def barrier(self, name: str) -> None:
        self._call({"op": "barrier", "name": name})

    def average(self, step: int, flat_params: np.ndarray) -> np.ndarray:
        _, payload = self._call({"op": "average", "step": step},
                                _to_bytes(flat_params))
        return _from_bytes(payload)

    def close(self, deregister: bool = True) -> None:
        """deregister=False drops the connection but keeps the worker in
        the coordinator's alive set until heartbeat expiry — a probe
        handing off to a training client under the SAME worker_id uses it
        so a claimed shard slot cannot be stolen during the handoff."""
        self._hb_stop.set()
        if deregister:
            try:
                self._call({"op": "deregister"})
            except Exception:
                pass
        self._sock.close()

    def claim_slot(self, n_slots: int):
        """Atomically claim a data-shard slot in [0, n_slots); None when
        every slot is held by an alive worker (retry after a beat)."""
        return self._call({"op": "claim_slot",
                           "n_slots": int(n_slots)})[0]["slot"]


# ---------------------------------------------------------------- training

def restore_zip_into(net, checkpoint_path: str) -> int:
    """Copy a `ModelSerializer` zip's params, layer state, optimizer state
    and step counter into the CALLER's `net` (initialised first if it is
    not), so its runtime configuration (mesh, listeners, a custom
    optimizer) survives a restart where a new object would drop it. A zip
    of the JAX package resumes with its updater's moments
    (util/model_serializer.py). A zip of another architecture (param
    tree or shapes) raises ValueError. Returns the restored step."""
    from deeplearning4j_tpu_torch.nn import tree
    from deeplearning4j_tpu_torch.util.model_serializer import (
        ModelSerializer,
    )

    if net.params is None:
        net.init()
    restored = ModelSerializer.restore(checkpoint_path, device=net.device)

    def layout(params):
        return [(p, tuple(t.shape)) for p, t in tree.leaves(params)]

    if layout(restored.params) != layout(net.params):
        raise ValueError(
            f"checkpoint {checkpoint_path} holds a different architecture "
            "than the worker's net — delete the stale checkpoint or pass "
            "the matching configuration")
    net.params = restored.params
    net.opt_state = restored.opt_state
    net.state = restored.state
    net.iteration_count = restored.iteration_count
    return net.iteration_count


def run_elastic_worker(address: str, worker_id: str, net, batches, *,
                       sync_every: int = 1, checkpoint_path: Optional[str] = None,
                       epochs: int = 1, client: Optional["ClusterClient"] = None):
    """Elastic data-parallel worker loop (multi-PROCESS param averaging).

    net: an initialized MultiLayerNetwork/ComputationGraph; batches: this
    worker's shard as a list of DataSets (the RDD partition analogue).
    Every `sync_every` local steps the flat parameter vector
    (`params_flat`, f32) is averaged across alive workers through the
    coordinator and written back (`set_params_flat`); after each sync
    the model is checkpointed as a `ModelSerializer` zip at
    `checkpoint_path` (written to `<path>.tmp`, then moved into place),
    and a restarted worker resumes from the zip's step counter
    (`restore_zip_into`; a zip the JAX package's worker wrote resumes
    too). Reference: the Spark master's fault tolerance came from RDD
    lineage; here it is checkpoint-and-rejoin.

    Returns the trained net.
    """
    from deeplearning4j_tpu_torch.util.model_serializer import (
        ModelSerializer,
    )

    start_step = 0
    if checkpoint_path and os.path.exists(checkpoint_path):
        start_step = restore_zip_into(net, checkpoint_path)
    # accepting a live client keeps a claimed shard slot heartbeating
    # through the caller's setup gap — a fresh registration here would
    # leave the slot sweepable for one heartbeat_timeout
    client = client or ClusterClient(address, worker_id)
    try:
        if net.params is None:
            net.init()
        step = 0
        for _ in range(epochs):
            for ds in batches:
                step += 1
                if step <= start_step:
                    continue  # fast-forward a resumed worker
                net.fit(ds)
                if step % sync_every == 0:
                    avg = client.average(step, net.params_flat())
                    net.set_params_flat(avg)
                    if checkpoint_path:
                        tmp = checkpoint_path + ".tmp"
                        ModelSerializer.write_model(net, tmp)
                        os.replace(tmp, checkpoint_path)
    finally:
        client.close()
    return net


def initialize_multihost(coordinator_address: Optional[str] = None,
                         num_processes: Optional[int] = None,
                         process_id: Optional[int] = None,
                         device=None) -> dict:
    """Bring up the multi-process runtime: `torch.distributed` over the
    rendezvous at `coordinator_address` (arguments default from the env
    contract; see `distributed.bootstrap.initialize`, which new code
    should call directly). After it, a `parallel.make_mesh` over every
    rank runs the collectives inside each step; the ClusterCoordinator
    above remains the control plane (registration, elastic restart,
    config registry). Returns bootstrap's info dict."""
    from deeplearning4j_tpu_torch.distributed import bootstrap

    return bootstrap.initialize(coordinator_address=coordinator_address,
                                num_processes=num_processes,
                                process_id=process_id, device=device)
