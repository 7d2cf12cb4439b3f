"""A split net served by the ranks of its "model" group in lockstep.

The JAX package serves a placed net from one process over all its
devices. The port holds one card a process, so a net split over
"model" (`net.set_mesh(mesh, axes={"model": ...})`) is served by the
group's ranks together: every step's split layers run collectives over
the group (ops/shard_comm.py `ProcessGroupShards`), so every rank must
run the same steps in the same order. `GenerationEngine`'s worker
decides its steps from queue timing, which two ranks would not share.

So rank 0 of the group (the leader) alone takes requests, admits,
schedules and picks the tokens, and before each step it broadcasts the
step's plan over the group: a small int64 tensor. The other ranks (the
followers) run a loop, entered from `GenerationEngine.start`, that
receives each plan and runs the same step on its shard:

    [PREFILL, slot, start, n_real, Tc, 0, tokens[Tc] ...]
    [DECODE,  B,    0,     0,      0,  0, tokens[B], positions[B] ...]
    [STOP, ...]

A decode plan's tokens are the tokens the leader chose at the previous
step (its argmax, or a sampled request's K12 draw), so the ranks'
generators never need to agree. A cache row is its slot's index, so
the plan needs no page assignment: the page pool is the leader's
admission accounting. `drain` on the leader ends its thread with a STOP
plan, which ends the followers' loops.

Every rank builds its engine with the same arguments and calls
`warmup()`: the warmup steps run on every rank without a plan, in the
same order. Lockstep serving refuses speculative decoding, several
replicas and injected faults at construction (`LockstepUnsupported`):
their steps are decided by host state the plan does not carry.

A failure between a plan's broadcast and the end of its step, on any
rank, leaves the ranks out of step: a peer may wait in a collective the
failed rank never joins. So such a failure ends the rank's serving for
good (`LockstepBroken`): a leader fails every request it holds and
refuses new ones, a follower's loop ends, neither sends another plan or
is respawned, and a peer left in a collective raises when the group's
timeout runs out (the process group's own: bootstrap's
PROCESS_GROUP_TIMEOUT_S), or at once when the failed rank's process
exits, and then ends the same way. A failure after a step (the token's
fetch, a K12 draw) leaves the ranks in step: that request fails and
serving goes on. The leader's thread sends the STOP plan however it
ends, unless its lockstep broke.
"""

from __future__ import annotations

import threading

import numpy as np
import torch

from deeplearning4j_tpu_torch.serving.engine import _GenWorker, _token_ids
from deeplearning4j_tpu_torch.serving.fleet import ReplicaKilled

STOP, PREFILL, DECODE = 0, 1, 2
HEADER = 6


class LockstepUnsupported(ValueError):
    """An engine option that lockstep serving does not carry."""


class LockstepBroken(ReplicaKilled):
    """A step failed after its plan went out (or a collective of the
    group failed): this rank no longer runs the group's steps, fails
    every request it holds and is not respawned."""


def lockstep_worker(net, *, replicas, speculative_k, faults):
    """(worker class, whether this rank leads) for a GenerationEngine
    over `net`: the lockstep worker over the process group of `net`'s
    "model" role, whatever its size, when the net is placed with one;
    else the plain worker."""
    import functools

    import torch.distributed as dist

    from deeplearning4j_tpu_torch.parallel.placement import mesh_axis

    axis = mesh_axis(net, "model")
    if axis is None:
        return _GenWorker, True
    group = net._mesh.group(axis)
    for bad, what in ((int(speculative_k) != 0, "speculative decoding"),
                      (int(replicas) != 1, "more than one replica"),
                      (faults is not None, "injected faults")):
        if bad:
            raise LockstepUnsupported(
                f"lockstep serving of a split net does not take {what}: "
                "the step plan carries no drafts, replicas or fault state")
    return (functools.partial(LockstepWorker, group=group),
            dist.get_rank(group) == 0)


class LockstepWorker(_GenWorker):
    """A generation worker whose steps the ranks of `group` run
    together: the leader's steps broadcast their plan first, and a
    follower's `follow` loop runs the plans it receives. `plans` counts
    the steps run under a plan (the same on every rank at the end)."""

    def __init__(self, *args, group, **kw):
        import torch.distributed as dist

        super().__init__(*args, **kw)
        self.group = group
        self.src = dist.get_global_rank(group, 0)
        self.plans = 0
        self._live = False  # set by start: warmup steps send no plan
        self._broken = False
        width = max(self.prefill_chunk, 2 * self.plan.n_slots)
        self._buf = torch.zeros(HEADER + width, dtype=torch.int64,
                                device=self.net.device)

    # ------------------------------------------------------------ plans
    def _broadcast(self, plan=None) -> np.ndarray:
        """Send `plan` (the leader) or receive the leader's (plan None)."""
        import torch.distributed as dist

        if plan is not None:
            self._buf.copy_(torch.from_numpy(plan))
        dist.broadcast(self._buf, self.src, group=self.group)
        return plan if plan is not None else self._buf.cpu().numpy()

    def _send(self, op, head=(), body=()) -> None:
        if not self._live:
            return  # warmup runs on every rank without a plan
        plan = np.zeros(self._buf.numel(), np.int64)
        plan[0] = op
        plan[1:1 + len(head)] = head
        body = np.concatenate([np.ravel(b) for b in body]) if body else ()
        plan[HEADER:HEADER + len(body)] = body
        self._broadcast(plan)
        if op != STOP:
            with self._mu:
                self.plans += 1

    def _planned(self, op, head, body, step, *args):
        """Broadcast a plan, then run its step (`step(*args)`, a step
        function of the net) on this rank; returns the step's output
        rows. A failure in between breaks this rank's lockstep."""
        try:
            self._send(op, head, body)
            probs, self.cache = step(*args)
        except Exception as exc:
            if not self._live:
                raise  # a warmup step: the caller's error
            self._broken = True
            raise LockstepBroken(f"lockstep step failed after its plan "
                                 f"went out: {exc!r}") from exc
        return probs

    def _run_prefill(self, ws, tokens, kmask, rows, start, last_idx,
                     requests=()):
        probs = self._planned(
            PREFILL, (rows[0], start[0], last_idx[0] + 1, tokens.shape[1]),
            (tokens,), self._prefill, ws.params, ws.state, self.cache,
            tokens, kmask, rows, start, last_idx)
        return _token_ids(probs, requests, self.generator)

    def _run_decode(self, ws, tokens, pos, requests=()):
        probs = self._planned(DECODE, (len(tokens),), (tokens, pos),
                              self._decode, ws.params, ws.state, self.cache,
                              tokens, pos)
        return _token_ids(probs, requests, self.generator)

    def _die(self, active, exc, clock) -> None:
        """The lockstep broke: every occupied slot's request and every
        queued one fails, and the queue refuses new ones."""
        super()._die([i for i, s in enumerate(self.slots.slots)
                      if s is not None], exc, clock)
        with self._cv:
            self._closed = True
            pending = list(self.pending)
            self.pending.clear()
        err = f"{type(exc).__name__}: {exc}"
        for req in pending:
            req.finish(clock(), error=err)
            with self._mu:
                self.failed += 1
            self._request_event(req, ok=False, error=err)

    def respawn(self, clock) -> None:
        raise LockstepBroken("a lockstep rank cannot rejoin its group's "
                             "steps: build a new engine on every rank")

    def _loop_ended(self) -> None:
        if self._live and not self._broken:
            try:
                self._send(STOP)
            except Exception as exc:  # a peer already gone
                self.recorder.error(f"gen-replica:{self.index}", exc=exc)

    def start(self, clock) -> None:
        self._live = True
        super().start(clock)

    # --------------------------------------------------------- follower
    def _step(self, plan: np.ndarray) -> bool:
        """Run one received plan on this rank's shard; False at STOP."""
        op = int(plan[0])
        if op == STOP:
            return False
        ws, body = self.weights.current, plan[HEADER:]
        if op == PREFILL:
            slot, start, n_real, Tc = (int(v) for v in plan[1:5])
            kmask = np.zeros((1, Tc), np.float32)
            kmask[0, :n_real] = 1.0
            _, self.cache = self._prefill(
                ws.params, ws.state, self.cache, body[None, :Tc], kmask,
                np.asarray([slot]), np.asarray([start]),
                np.asarray([n_real - 1]))
        elif op == DECODE:
            B = int(plan[1])
            _, self.cache = self._decode(ws.params, ws.state, self.cache,
                                         body[:B], body[B:2 * B])
        else:
            raise ValueError(f"unknown lockstep plan op {op}")
        with self._mu:
            self.plans += 1
        return True

    def follow(self, clock) -> None:
        """Start the follower's thread: receive and run plans until the
        leader's STOP, or until one fails (the worker is then dead)."""
        self.last_beat = clock()

        def loop():
            try:
                while self._step(self._broadcast()):
                    self.last_beat = clock()
                self.lifecycle = "retired"
            except Exception as exc:  # out of step: the loop ends for good
                self.alive = False
                self.lifecycle = "dead"
                self.recorder.error(f"gen-follower:{self.index}", exc=exc)

        self.lifecycle = "serving"
        # the inherited join is the handle: the loop ends at the leader's
        # stop plan, which the engine's drain() waits for
        self._thread = threading.Thread(  # graftlint: disable=G028
            target=loop, daemon=True, name=f"gen-follower-{self.index}")
        self._thread.start()
