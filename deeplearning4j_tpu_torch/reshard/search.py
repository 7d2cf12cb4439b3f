"""Automatic placement search — the cost model picks the fastest mesh,
not just moves to it (the port's own copy of
deeplearning4j_tpu/reshard/search.py: the same enumeration, scores and
ranked tables for the same inputs; `profile_net` reads the port's net).

The ROADMAP item this delivers: placements were hand-specified, so every
fleet shape shipped whatever dp x tp x pp x sp x ep assignment a human
guessed — the one knob with the largest step-time leverage was untuned.
The planner's exact bytes-moved machinery (arXiv:2112.01075) already
knows how to *cost* a layout; this module turns that discipline one
level up: enumerate every `planner.Placement` a fleet shape admits,
prune the illegal ones with the SAME `PlacementError` validation the
reshard planner uses (zero1 x TP, non-dividing axes, role on a missing
axis — feasibility comes for free), and rank the survivors with a
pure-stdlib per-step cost model. arXiv:2004.13336's automatic
weight-update sharding is the special case we already ship (zero1 on
the data axis); the search generalizes it to the whole role vocabulary.
The sweep -> score -> freeze -> gate shape is the kernel autotuner's
discipline applied to the mesh itself.

Like the planner, everything on the search path is pure stdlib and pure
data:

- no import beyond the standard library on the search path;
- no dependence on rank or clock — every fleet member computes the
  byte-identical ranking (asserted under simulated `process_index`
  0 vs 1, the same discipline as `plan_reshard`), which is what lets
  the elastic re-plan run on every worker without coordination.

## The cost model (exact rationals; bytes and bytes-equivalents)

For a candidate with role sizes dp/tp/pp/sp/ep, a model profile with
param leaves L (name, shape, itemsize), TP/EP rules R, and an
`Objective` with global batch B and per-device HBM budget H:

| term | formula |
|---|---|
| `tp_shards(l)` | product of the rule-named role sizes sharding leaf l (a rule activates only when ALL its named roles are >1 — the `tensor_parallel.sharding_for` semantics; a named dim that does not divide is a `PlacementError` prune) |
| `params_dev` | sum_l bytes(l)/tp_shards(l) / pp  (pipeline stages split the layer stack) |
| `grads_dev` | params_dev |
| `moments_dev` | 2 x params_dev / (dp if zero1 else 1)  (the 2004.13336 weight-update shard) |
| `act_micro` | (B/dp/n_micro) x (seq_len/sp) x act_width x 4  — the activation envelope of ONE microbatch (act_width = sum of last dims of ndim>=2 leaves); n_micro = microbatch_factor x pp when pp>1 else 1 |
| `memory_dev` | params_dev + grads_dev + moments_dev + act_micro x max(pp, 1)  — rejected when > H ("no feasible placement fits the HBM budget" when every candidate dies here) |
| dp collective | 2 x G x (dp-1)/dp with G = grads_dev (ring allreduce), + G x (dp-1)/dp more under zero1 (the param all-gather) |
| tp collective | 2 x (n_layers/pp) x act_micro x (tp-1)/tp x n_micro  (two activation allreduces per layer) |
| sp collective | (n_layers/pp) x act_micro x (sp-1)/sp x n_micro  (ring K/V hops) |
| ep collective | 2 x (n_layers/pp) x act_micro x (ep-1)/ep x n_micro  (dispatch + combine all_to_all) |
| pp transfer | act_micro x n_micro x (pp-1)/pp  (stage-boundary sends) |
| `bubble` | (pp-1)/(n_micro+pp-1) x compute_dev x compute_weight  (the GPipe bubble idles this device's own work) |
| `idle` | (compute_dev - C/n_devices) x compute_weight — the penalty for an axis that divides no work (a model axis whose rules shard nothing leaves its devices redundant); C = 2 x B x seq_len x param_bytes, compute_dev = C / (dp x pp x sp x effective tp x effective ep) |

    score = collective_bytes + bubble + idle        (lower is better)

`Objective(step="forward")` scores the inference surface instead: the
gradient and optimizer terms vanish and the activation collectives run
once per step instead of twice (no backward traversal) — the surface
the predicted-vs-measured bench gate measures, since this container
cannot execute TP train steps (the pre-existing donation-alias class).
`compute_weight` (default 1/16, roughly MXU flops per HBM byte) converts
compute-shaped terms into wire-byte equivalents; memory gates
feasibility but does not enter the score. The score is a RANKING model,
not a latency predictor; `reshard/bench_arm.py` times a searched
placement's steps.

## Surfaces

- `search_placement(net_or_profile, fleet, objective=...)` -> ranked
  `SearchResult`; `result.winner` is a `planner.Placement` that
  `net.set_mesh(...)` consumes directly (parallel/placement.py builds
  the mesh over the process group's ranks and the role map from it).
  The port runs one process per device, so its fleet of n ranks is
  searched as `FleetShape(1, n)`: the process-spanning prune below
  is the JAX package's rule for its multi-device processes.

Every surface emits a typed `placement_search` telemetry event
(`emit_search_event`) so the candidates considered, the prunes, and the
winner's score breakdown are on the record before any mesh is built.
"""

from __future__ import annotations

import re
from dataclasses import dataclass
from fractions import Fraction
from typing import Optional, Sequence, Tuple

from deeplearning4j_tpu_torch.reshard.planner import (
    Placement,
    PlacementError,
    VALID_ROLES,
)

# canonical axis order of every candidate mesh (axes are NAMED by their
# role, the CLI `--mesh data=2,model=2` convention, so rule specs and
# set_mesh role maps line up for free)
ROLE_ORDER = ("data", "model", "pipe", "seq", "expert")

ACT_ITEMSIZE = 4  # activations modeled f32 (the training envelope)


class SearchError(RuntimeError):
    """No feasible placement survived the prune (e.g. nothing fits the
    per-device HBM budget); carries the per-candidate reasons."""


# ------------------------------------------------------------------ input

@dataclass(frozen=True)
class FleetShape:
    """A fleet as the launcher sees it: N processes x K devices each."""

    process_count: int
    devices_per_process: int

    def __post_init__(self):
        if self.process_count < 1 or self.devices_per_process < 1:
            raise ValueError(f"bad fleet shape {self.describe()}")

    @classmethod
    def parse(cls, spec: str) -> "FleetShape":
        """'2x4' -> FleetShape(2, 4); '8' -> FleetShape(1, 8)."""
        parts = str(spec).lower().split("x")
        if len(parts) == 1:
            return cls(1, int(parts[0]))
        if len(parts) != 2:
            raise ValueError(f"bad --fleet spec {spec!r}; expected PxK")
        return cls(int(parts[0]), int(parts[1]))

    @property
    def n_devices(self) -> int:
        return self.process_count * self.devices_per_process

    def describe(self) -> str:
        return f"{self.process_count}x{self.devices_per_process}"


@dataclass(frozen=True)
class ParamLeaf:
    """One param-tree leaf as pure data."""

    name: str
    shape: Tuple[int, ...]
    itemsize: int = 4

    @property
    def bytes(self) -> int:
        n = self.itemsize
        for d in self.shape:
            n *= d
        return n


@dataclass(frozen=True)
class ModelProfile:
    """Everything the cost model needs to know about a net, as pure
    data: its param leaves, layer count, sequence length (1 for
    non-sequence models), the roles its conf/container can actually
    run (`supports`), and the TP/EP placement rules with ROLE-named
    spec entries (plain tuples — `tensor_parallel`'s PartitionSpec
    rules convert via `tuple(spec)`)."""

    name: str
    leaves: Tuple[ParamLeaf, ...]
    n_layers: int
    seq_len: int = 1
    supports: Tuple[str, ...] = ("data", "model")
    rules: Tuple[Tuple[str, Tuple[Optional[str], ...]], ...] = ()

    @property
    def param_bytes(self) -> int:
        return sum(l.bytes for l in self.leaves)

    @property
    def activation_width(self) -> int:
        return sum(l.shape[-1] for l in self.leaves if len(l.shape) >= 2)


@dataclass(frozen=True)
class Objective:
    """What the search optimizes under: the per-step workload shape and
    the per-device memory budget. `zero1_options` widens the candidate
    set with weight-update-sharded variants of the pure-dp placements;
    `compute_weight` converts compute-shaped terms (bubble, idle
    devices) into wire-byte equivalents. ``step`` picks the cost
    surface: "train" (the default — gradient allreduce, moments,
    fwd+bwd activation collectives) or "forward" (the inference/serving
    placement: no gradient or optimizer terms, activation collectives
    halved — what the predicted-vs-measured bench gate measures, since
    this container cannot execute TP train steps)."""

    global_batch: int = 32
    hbm_bytes_per_device: int = 16 << 30
    microbatch_factor: int = 2
    compute_weight: Fraction = Fraction(1, 16)
    zero1_options: Tuple[bool, ...] = (False, True)
    step: str = "train"

    def __post_init__(self):
        if self.step not in ("train", "forward"):
            raise ValueError(f"objective step must be 'train' or "
                             f"'forward' (got {self.step!r})")

    def to_json(self) -> dict:
        return {"global_batch": self.global_batch,
                "hbm_bytes_per_device": self.hbm_bytes_per_device,
                "microbatch_factor": self.microbatch_factor,
                "compute_weight": float(self.compute_weight),
                "zero1_options": list(self.zero1_options),
                "step": self.step}


# ----------------------------------------------------------------- output

@dataclass(frozen=True)
class ScoredCandidate:
    """One feasible placement with its exact-rational score breakdown."""

    placement: Placement
    score: Fraction
    memory_bytes: Fraction          # per-device high-water estimate
    collective_bytes: Fraction      # per-device wire bytes per step
    bubble_cost: Fraction           # pp bubble, bytes-equivalent
    idle_cost: Fraction             # redundant-axis penalty, bytes-equiv
    params_bytes: Fraction
    moments_bytes: Fraction
    activation_bytes: Fraction

    def describe(self) -> str:
        return self.placement.describe()

    def to_json(self) -> dict:
        return {"placement": self.placement.to_json(),
                "describe": self.describe(),
                "score": float(self.score),
                "memory_bytes": float(self.memory_bytes),
                "collective_bytes": float(self.collective_bytes),
                "bubble_cost": float(self.bubble_cost),
                "idle_cost": float(self.idle_cost),
                "params_bytes": float(self.params_bytes),
                "moments_bytes": float(self.moments_bytes),
                "activation_bytes": float(self.activation_bytes)}


@dataclass(frozen=True)
class SearchResult:
    """The ranked search output. `candidates` is best-first;
    `winner` is the top candidate's `Placement` — the value
    `net.set_mesh(...)` consumes unmodified."""

    fleet: FleetShape
    profile_name: str
    objective: Objective
    candidates: Tuple[ScoredCandidate, ...]
    pruned: Tuple[Tuple[str, str], ...]  # (placement description, reason)

    @property
    def winner(self) -> Placement:
        return self.candidates[0].placement

    @property
    def best(self) -> ScoredCandidate:
        return self.candidates[0]

    @property
    def n_considered(self) -> int:
        return len(self.candidates) + len(self.pruned)

    def to_json(self) -> dict:
        return {"fleet": self.fleet.describe(),
                "profile": self.profile_name,
                "objective": self.objective.to_json(),
                "candidates": [c.to_json() for c in self.candidates],
                "pruned": [list(p) for p in self.pruned]}

    def table_lines(self, top: int = 5) -> list:
        """The CLI dry-run table: rank, placement, score breakdown."""
        out = [f"# placement search: {self.profile_name} on fleet "
               f"{self.fleet.describe()} ({self.fleet.n_devices} devices)"
               f" — {len(self.candidates)} feasible, "
               f"{len(self.pruned)} pruned"]
        out.append(f"# {'rank':>4}  {'placement':<34} {'score':>12} "
                   f"{'mem/dev':>10} {'coll B/step':>12} {'bubble':>10} "
                   f"{'idle':>10}")
        for i, c in enumerate(self.candidates[:top], start=1):
            out.append(
                f"# {i:>4}  {c.describe():<34} {float(c.score):>12.0f} "
                f"{float(c.memory_bytes):>10.0f} "
                f"{float(c.collective_bytes):>12.0f} "
                f"{float(c.bubble_cost):>10.0f} "
                f"{float(c.idle_cost):>10.0f}")
        for desc, reason in self.pruned[:top]:
            out.append(f"#  pruned {desc:<32} {reason}")
        return out


# ------------------------------------------------------------ enumeration

def _role_factorizations(n: int, roles: Sequence[str]):
    """Every assignment {role: size>=1} with product == n (all devices
    used), deterministic order."""
    roles = list(roles)

    def rec(i, remaining):
        if i == len(roles) - 1:
            yield {roles[i]: remaining}
            return
        d = 1
        while d <= remaining:
            if remaining % d == 0:
                for rest in rec(i + 1, remaining // d):
                    yield {roles[i]: d, **rest}
            d += 1

    yield from rec(0, n)


def enumerate_placements(fleet: FleetShape, *,
                         roles: Sequence[str] = ROLE_ORDER,
                         zero1_options: Tuple[bool, ...] = (False, True)):
    """-> (candidates, pruned): every `Placement` the fleet shape
    admits over `roles` (axes named by role, sizes multiplying to the
    full device count), plus the (description, reason) prunes. The
    feasibility filter IS `planner.Placement.of` — zero1 x TP, role on
    a missing axis, process counts that do not divide all raise
    `PlacementError` there and cost nothing here. Process-spanning
    fleets additionally prune non-data roles (the set_mesh guard:
    cross-process model/pipe/expert/seq placement is still host-side
    device_puts — ARCHITECTURE §Distributed runtime)."""
    bad = set(roles) - set(VALID_ROLES)
    if bad:
        raise ValueError(f"unknown roles {sorted(bad)}; valid: "
                         f"{VALID_ROLES}")
    roles = [r for r in ROLE_ORDER if r in set(roles)]
    candidates, pruned = [], []
    for sizes in _role_factorizations(fleet.n_devices, roles):
        mesh_axes = {r: s for r, s in sizes.items() if s > 1}
        if not mesh_axes:
            mesh_axes = {"data": 1}
        role_map = {r: r for r in mesh_axes}
        desc_sizes = "x".join(str(s) for s in mesh_axes.values())
        if fleet.process_count > 1 and set(mesh_axes) - {"data"}:
            pruned.append((
                f"{desc_sizes} ({','.join(mesh_axes)})",
                "process-spanning mesh supports the 'data' role only "
                "(set_mesh guard — ARCHITECTURE §Distributed runtime)"))
            continue
        zero1_eligible = not (set(mesh_axes) - {"data"})
        for z in zero1_options:
            if z and not zero1_eligible:
                continue  # Placement.of would refuse; skip silently —
                # the un-zero1'd twin of this assignment is the candidate
            try:
                candidates.append(Placement.of(
                    mesh_axes, role_map,
                    process_count=fleet.process_count, zero1=z))
            except PlacementError as exc:
                pruned.append((desc_sizes, str(exc)))
    return candidates, pruned


# ---------------------------------------------------------------- scoring

def _role_sizes(placement: Placement) -> dict:
    sizes = placement.axis_sizes
    return {role: sizes.get(ax, 1) for role, ax in placement.roles}


def _leaf_shards(leaf: ParamLeaf, sizes: dict, rules) -> int:
    """How many ways the candidate's rules shard this leaf — the
    `tensor_parallel.sharding_for` semantics on pure data: first
    matching pattern wins; it activates only when EVERY role it names
    has size > 1; an activated role whose dim does not divide raises
    `PlacementError` (the prune)."""
    for pat, spec in rules or ():
        if re.match(pat, leaf.name):
            entries = tuple(spec)
            named = [r for r in entries if isinstance(r, str)]
            if not all(sizes.get(r, 1) > 1 for r in named):
                break  # replicated (a named role is absent/1)
            shards = 1
            for d, r in enumerate(entries):
                if not isinstance(r, str):
                    continue
                n = sizes[r]
                if d >= len(leaf.shape) or leaf.shape[d] % n:
                    raise PlacementError(
                        f"leaf {leaf.name!r}: dim {d} of {leaf.shape} "
                        f"does not divide over {n}-way role {r!r}")
                shards *= n
            return shards
    return 1


def score_placement(profile: ModelProfile, placement: Placement,
                    objective: Objective,
                    fleet: FleetShape) -> ScoredCandidate:
    """Score one feasible placement (exact rationals throughout).
    Raises `PlacementError` for net-level infeasibility (non-dividing
    leaf dims, batch/microbatch/sequence that do not divide, HBM
    budget exceeded) — the caller records it as a prune."""
    sizes = _role_sizes(placement)
    dp = sizes.get("data", 1)
    tp = sizes.get("model", 1)
    pp = sizes.get("pipe", 1)
    sp = sizes.get("seq", 1)
    ep = sizes.get("expert", 1)
    for role, n in (("model", tp), ("pipe", pp), ("seq", sp),
                    ("expert", ep)):
        if n > 1 and role not in profile.supports:
            raise PlacementError(
                f"profile {profile.name!r} does not support the "
                f"{role!r} role (supports: {profile.supports})")

    B = objective.global_batch
    if B % dp:
        raise PlacementError(
            f"global batch {B} does not divide over the {dp}-way data "
            "axis")
    n_micro = objective.microbatch_factor * pp if pp > 1 else 1
    rows = B // dp
    if rows % n_micro:
        raise PlacementError(
            f"per-replica batch {rows} does not divide into {n_micro} "
            "microbatches")
    if pp > 1 and profile.n_layers % pp:
        raise PlacementError(
            f"{profile.n_layers} layers do not divide over {pp} "
            "pipeline stages")
    if sp > 1 and profile.seq_len % sp:
        raise PlacementError(
            f"sequence length {profile.seq_len} does not divide over "
            f"the {sp}-way seq axis")

    # --- per-device memory (params + grads + moments + activations)
    train = objective.step == "train"
    sharded_roles = set()
    shard_bytes = Fraction(0)
    for leaf in profile.leaves:
        shards = _leaf_shards(leaf, sizes, profile.rules)
        if shards > 1:
            for pat, spec in profile.rules:
                if re.match(pat, leaf.name):
                    sharded_roles |= {r for r in spec
                                      if isinstance(r, str)}
                    break
        shard_bytes += Fraction(leaf.bytes, shards)
    params_dev = shard_bytes / pp
    grads_dev = params_dev if train else Fraction(0)
    moments_dev = (2 * params_dev / (dp if placement.zero1 and dp > 1
                                     else 1)
                   if train else Fraction(0))
    act_micro = (Fraction(rows, n_micro) * Fraction(profile.seq_len, sp)
                 * profile.activation_width * ACT_ITEMSIZE)
    memory_dev = (params_dev + grads_dev + moments_dev
                  + act_micro * max(pp, 1))
    if memory_dev > objective.hbm_bytes_per_device:
        raise PlacementError(
            f"memory estimate {float(memory_dev):.0f} B/device exceeds "
            f"the HBM budget {objective.hbm_bytes_per_device} B")

    # --- collective bytes per device per step; the forward surface has
    # no gradient traffic and runs the activation collectives once
    # (no backward re-traversal) — act_passes carries the halving
    layers_stage = Fraction(profile.n_layers, pp)
    act_passes = 2 if train else 1
    coll = Fraction(0)
    coll += 2 * grads_dev * Fraction(dp - 1, dp)            # grad ring
    if train and placement.zero1 and dp > 1:
        coll += params_dev * Fraction(dp - 1, dp)           # param gather
    tp_effective = tp > 1 and "model" in sharded_roles
    ep_effective = ep > 1 and "expert" in sharded_roles
    if tp_effective:
        coll += act_passes * layers_stage * act_micro \
            * Fraction(tp - 1, tp) * n_micro
    if sp > 1:
        coll += (Fraction(act_passes, 2) * layers_stage * act_micro
                 * Fraction(sp - 1, sp) * n_micro)
    if ep_effective:
        coll += act_passes * layers_stage * act_micro \
            * Fraction(ep - 1, ep) * n_micro
    if pp > 1:
        coll += (Fraction(act_passes, 2) * act_micro * n_micro
                 * Fraction(pp - 1, pp))                    # stage p2p

    # --- compute-shaped terms (bytes-equivalent via compute_weight)
    C = 2 * B * profile.seq_len * profile.param_bytes
    denom = dp * pp * sp * (tp if tp_effective else 1) \
        * (ep if ep_effective else 1)
    compute_dev = Fraction(C, denom)
    bubble = Fraction(0)
    if pp > 1:
        bubble = (Fraction(pp - 1, n_micro + pp - 1) * compute_dev
                  * objective.compute_weight)
    idle = ((compute_dev - Fraction(C, fleet.n_devices))
            * objective.compute_weight)

    return ScoredCandidate(
        placement=placement, score=coll + bubble + idle,
        memory_bytes=memory_dev, collective_bytes=coll,
        bubble_cost=bubble, idle_cost=idle, params_bytes=params_dev,
        moments_bytes=moments_dev, activation_bytes=act_micro)


# ----------------------------------------------------------------- search

def search_placement(net_or_profile, fleet, *, objective=None,
                     roles: Sequence[str] = ROLE_ORDER) -> SearchResult:
    """Enumerate, prune, score, and rank every placement `fleet`
    admits for the given net (or `ModelProfile`). Deterministic and
    rank-independent: the ranking is a pure function of
    (profile, fleet, objective)."""
    if isinstance(fleet, str):
        fleet = FleetShape.parse(fleet)
    profile = (net_or_profile if isinstance(net_or_profile, ModelProfile)
               else profile_net(net_or_profile))
    objective = objective or Objective()
    raw, pruned = enumerate_placements(
        fleet, roles=[r for r in roles if r in profile.supports
                      or r == "data"],
        zero1_options=objective.zero1_options)
    scored = []
    for placement in raw:
        try:
            scored.append(score_placement(profile, placement, objective,
                                          fleet))
        except PlacementError as exc:
            pruned.append((placement.describe(), str(exc)))
    if not scored:
        reasons = "; ".join(f"{d}: {r}" for d, r in pruned[:6])
        raise SearchError(
            f"no feasible placement for {profile.name!r} on fleet "
            f"{fleet.describe()} — every candidate was pruned "
            f"({reasons})")
    scored.sort(key=lambda c: (c.score, c.memory_bytes, c.describe()))
    return SearchResult(fleet=fleet, profile_name=profile.name,
                        objective=objective, candidates=tuple(scored),
                        pruned=tuple(pruned))


def emit_search_event(result: SearchResult, *, path: str,
                      search_ms: float, **fields) -> dict:
    """The typed `placement_search` telemetry event every search
    surface (CLI plan, elastic re-plan, bench) puts on the record:
    candidates considered, prunes, the winner's score breakdown, and
    the search wall time."""
    from deeplearning4j_tpu_torch.telemetry.recorder import get_default

    best = result.best
    return get_default().event(
        "placement_search", path=path, fleet=result.fleet.describe(),
        profile=result.profile_name,
        candidates_considered=result.n_considered,
        candidates_feasible=len(result.candidates),
        pruned=len(result.pruned), winner=best.describe(),
        winner_score=float(best.score),
        winner_memory_bytes=float(best.memory_bytes),
        winner_collective_bytes=float(best.collective_bytes),
        winner_bubble_cost=float(best.bubble_cost),
        winner_idle_cost=float(best.idle_cost),
        search_ms=round(float(search_ms), 3), **fields)


# --------------------------------------------------------------- profiles

def profile_net(net, *, seq_len: Optional[int] = None,
                supports: Optional[Sequence[str]] = None,
                tp_rules=None, name: Optional[str] = None) -> ModelProfile:
    """A `ModelProfile` of a live network container (the impure
    boundary: reads the canonical param shapes — whole leaves, under a
    placement too — and layer counts; initializes the net if needed).
    Rules default to the active `tensor_parallel` role-rule sets with
    role-named axes, converted to pure tuples."""
    from deeplearning4j_tpu_torch.parallel.placement import (
        canonical_template,
    )

    if net.params is None:
        net.init()
    leaves = []

    def walk(tree, prefix=""):
        for k in tree:
            v = tree[k]
            if isinstance(v, dict):
                walk(v, prefix + str(k) + "/")
            else:
                leaves.append(ParamLeaf(
                    prefix + str(k),
                    tuple(int(d) for d in getattr(v, "shape", ()) or ()),
                    int(getattr(getattr(v, "dtype", None), "itemsize", 4)
                        or 4)))

    # the canonical (whole) leaves, under a placement too: shapes only,
    # no collective
    walk(canonical_template(net))
    if hasattr(net, "layer_vertices"):
        n_layers = len(net.layer_vertices)
    else:
        n_layers = len(net.layer_confs)
    if tp_rules is None:
        from deeplearning4j_tpu_torch.parallel.tensor_parallel import \
            resolve_rules

        tp_rules = resolve_rules({"model": "model", "expert": "expert"})
    rules = tuple((pat, tuple(spec)) for pat, spec in tp_rules)
    return ModelProfile(
        name=name or type(net).__name__,
        leaves=tuple(leaves), n_layers=max(1, n_layers),
        seq_len=int(seq_len or 1),
        supports=tuple(supports or ("data", "model")),
        rules=rules)


# Built-in pure-data profiles: the CLI `plan` dry-run stays jax-free
# for named models (a laptop plans a pod placement without a backend).
# "mlp" mirrors the bench/cluster toy (3 dense layers); "lm" mirrors
# the tiny transformer the placement bench measures — its leaves are
# the REAL `models/transformer.transformer_lm` param tree at the bench
# dims, so the profile's divisibility prunes are the net's. d_model=80
# with 5 heads is deliberate: 80 admits tp 2/4/8 (and prunes tp 3/6 —
# the non-dividing-axis prune the 3x2 grid exercises), while 5 heads
# divide NO candidate tp, so every TP arm pays the head-resharding
# cost the collective term stands in for.
_TP_RULES = (
    (r".*_attn/Wqkv$", (None, "model")),
    (r".*_attn/bqkv$", ("model",)),
    (r".*_attn/Wo$", ("model", None)),
    (r".*_ff1/W$", (None, "model")),
    (r".*_ff1/b$", ("model",)),
    (r".*_ff2/W$", ("model", None)),
    (r"embed/W$", (None, "model")),
    (r"out/W$", (None, "model")),
    (r"out/b$", ("model",)),
)

_LM_V, _LM_D, _LM_FF, _LM_T, _LM_L = 80, 80, 160, 48, 2
_LM_H = 5  # heads: coprime to every candidate tp (see above)

BUILTIN_PROFILES = {
    "mlp": ModelProfile(
        name="mlp",
        leaves=(ParamLeaf("dense0/W", (48, 96)), ParamLeaf("dense0/b", (96,)),
                ParamLeaf("dense1/W", (96, 96)), ParamLeaf("dense1/b", (96,)),
                ParamLeaf("out/W", (96, 12)), ParamLeaf("out/b", (12,))),
        n_layers=3, seq_len=1, supports=("data", "model"),
        rules=((r".*dense\d/W$", (None, "model")),
               (r".*dense\d/b$", ("model",)))),
    "lm": ModelProfile(
        name="lm",
        leaves=tuple(
            [leaf for i in range(_LM_L) for leaf in (
                ParamLeaf(f"blk{i}_attn/Wqkv", (_LM_D, 3 * _LM_D)),
                ParamLeaf(f"blk{i}_attn/bqkv", (3 * _LM_D,)),
                ParamLeaf(f"blk{i}_attn/Wo", (_LM_D, _LM_D)),
                ParamLeaf(f"blk{i}_attn/bo", (_LM_D,)),
                ParamLeaf(f"blk{i}_ff1/W", (_LM_D, _LM_FF)),
                ParamLeaf(f"blk{i}_ff1/b", (_LM_FF,)),
                ParamLeaf(f"blk{i}_ff2/W", (_LM_FF, _LM_D)),
                ParamLeaf(f"blk{i}_ff2/b", (_LM_D,)),
                ParamLeaf(f"blk{i}_ln1/gamma", (_LM_D,)),
                ParamLeaf(f"blk{i}_ln1/beta", (_LM_D,)),
                ParamLeaf(f"blk{i}_ln2/gamma", (_LM_D,)),
                ParamLeaf(f"blk{i}_ln2/beta", (_LM_D,)))]
            + [ParamLeaf("embed/W", (_LM_V, _LM_D)),
               ParamLeaf("ln_f/gamma", (_LM_D,)),
               ParamLeaf("ln_f/beta", (_LM_D,)),
               ParamLeaf("out/W", (_LM_D, _LM_V)),
               ParamLeaf("out/b", (_LM_V,))]),
        n_layers=_LM_L, seq_len=_LM_T, supports=("data", "model"),
        rules=_TP_RULES),
}

# the profile the elastic supervisor ranks re-plans with when it has no
# model in-process (the data-role-only spanning constraint makes the
# fleet-level ranking exact for it anyway: dp coverage + zero1 choice)
GENERIC_PROFILE = BUILTIN_PROFILES["mlp"]
