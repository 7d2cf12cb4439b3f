"""The resharding planner — a pure function from (source placement,
target placement, leaf layout) to a deterministic redistribution plan
(the port's own copy of deeplearning4j_tpu/reshard/planner.py: the same
plans, byte for byte, for the same inputs).

ROADMAP's portable resharding engine, layer 1 of 3 (executors live in
`reshard/executor.py`, integration in placement/elastic/serving). The
formulation follows arXiv:2112.01075 (*Memory-efficient array
redistribution through portable collective communication*): a
redistribution is a per-leaf choice among a small vocabulary of
transfer patterns, each with a computable byte cost, and the planner's
job is to pick the cheapest valid pattern and REPORT the lower bound so
the executor's achieved bytes are auditable against it. Composed with
the zero1 optimizer-state shardings (arXiv:2004.13336,
`nn/training.zero1_opt_shardings`), optimizer moments reshard through
the same plans as params.

Everything here is pure stdlib and pure data:

- no import beyond the standard library (the planner plans a
  checkpoint->mesh move without touching a device);
- no dependence on the calling process's rank, host, or clock — the
  same placements yield the byte-identical plan on every process
  (the JAX package's tests/test_reshard.py re-plans under simulated
  process_index 0 vs 1),
  which is what lets every fleet member execute its slice of the plan
  without coordination.

Per-leaf actions:

| action           | when                                            | bytes model |
|---|---|---|
| `keep`           | identical spec, mesh layout, and process set    | 0 |
| `slice_exchange` | every dim refines (T_d a multiple of S_d)       | the lower bound: bytes a target device needs that its aligned source device does not hold |
| `allgather_shard`| coarsening or cross-dim moves                   | full leaf to every target device, minus resident |
| `host_fallback`  | only when forced (`force_host=True` — the       | gather to host + redistribute, no resident credit |
|                  | lockstep host checkpoint's shape, kept for cost |    |
|                  | comparison and for non-coexisting meshes)       |    |

Invariant (asserted by tier-1): for every leaf, `bytes_slice <=
bytes_gather` and `bytes_slice <= bytes_host` — the slice plan IS the
lower bound, so preferring collective plans over host gathers is
structural, not tuned. (`bytes_host` can undercut `bytes_gather` on
byte count alone — the host path sends each target device only its
shard — but it serializes through one host hop, which is why the
planner only emits it when forced.)

A malformed placement (unknown role, role on a missing axis, a spec
axis absent from the mesh, a sharded dim not divisible by its partition
count — the target-mesh-larger-than-checkpoint failure row) raises
`PlacementError` before any plan exists; the executor never sees a
half-valid plan.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from fractions import Fraction
from typing import Optional, Sequence, Tuple

# dp / tp / pp / sp / ep — the same role vocabulary as
# parallel/placement.py (ROLES); the planner re-declares it to stay
# import-free under the lint stubs.
VALID_ROLES = ("data", "model", "pipe", "expert", "seq")

KEEP = "keep"
SLICE_EXCHANGE = "slice_exchange"
ALLGATHER_SHARD = "allgather_shard"
HOST_FALLBACK = "host_fallback"
ACTIONS = (KEEP, SLICE_EXCHANGE, ALLGATHER_SHARD, HOST_FALLBACK)


class PlacementError(ValueError):
    """A placement or leaf layout the engine must refuse to plan for."""


@dataclass(frozen=True)
class Placement:
    """One side of a redistribution: mesh shape x axis roles x process
    count (+ whether zero1 shards the optimizer moments over the data
    axis). Pure data — device objects never appear here."""

    mesh_axes: Tuple[Tuple[str, int], ...]   # ordered (axis name, size)
    roles: Tuple[Tuple[str, str], ...] = ()  # (role, mesh axis) pairs
    process_count: int = 1
    zero1: bool = False

    @classmethod
    def of(cls, mesh_axes, roles=None, *, process_count: int = 1,
           zero1: bool = False) -> "Placement":
        """Build + validate from dicts ({axis: size}, {role: axis})."""
        p = cls(tuple((str(a), int(n)) for a, n in dict(mesh_axes).items()),
                tuple((str(r), str(a))
                      for r, a in dict(roles or {}).items()),
                process_count=int(process_count), zero1=bool(zero1))
        p.validate()
        return p

    # ------------------------------------------------------------ views
    @property
    def axis_sizes(self) -> dict:
        return dict(self.mesh_axes)

    @property
    def n_devices(self) -> int:
        n = 1
        for _, s in self.mesh_axes:
            n *= s
        return n

    def axis_for(self, role: str) -> Optional[str]:
        for r, a in self.roles:
            if r == role:
                return a
        return None

    # -------------------------------------------------------- validation
    def validate(self) -> "Placement":
        if not self.mesh_axes:
            raise PlacementError("placement has an empty mesh")
        seen = set()
        for ax, size in self.mesh_axes:
            if ax in seen:
                raise PlacementError(f"duplicate mesh axis {ax!r}")
            seen.add(ax)
            if size < 1:
                raise PlacementError(f"mesh axis {ax!r} has size {size}")
        for role, ax in self.roles:
            if role not in VALID_ROLES:
                raise PlacementError(
                    f"unknown role {role!r}; valid: {VALID_ROLES}")
            if ax not in seen:
                raise PlacementError(
                    f"role {role!r} maps to axis {ax!r} which is not on "
                    f"the mesh (axes: {sorted(seen)})")
        if self.process_count < 1:
            raise PlacementError(
                f"process_count must be >= 1 (got {self.process_count})")
        if self.n_devices % self.process_count:
            raise PlacementError(
                f"{self.n_devices} mesh devices do not divide over "
                f"{self.process_count} processes")
        if self.zero1:
            extra = {r for r, _ in self.roles} - {"data"}
            if extra:
                raise PlacementError(
                    "zero1 composes with the 'data' role only (got "
                    f"{sorted(extra)}) — same constraint as set_mesh")
        return self

    def to_json(self) -> dict:
        return {"mesh_axes": [list(p) for p in self.mesh_axes],
                "roles": [list(p) for p in self.roles],
                "process_count": self.process_count,
                "zero1": self.zero1}

    @classmethod
    def from_json(cls, obj: dict) -> "Placement":
        return cls.of(dict(tuple(p) for p in obj.get("mesh_axes", [])),
                      dict(tuple(p) for p in obj.get("roles", [])),
                      process_count=obj.get("process_count", 1),
                      zero1=obj.get("zero1", False))

    @classmethod
    def solo(cls) -> "Placement":
        """The trivial one-device placement (an unplaced net, a serving
        process, a checkpoint written before placements were stamped)."""
        return cls.of({"data": 1}, {"data": "data"})

    def describe(self) -> str:
        shape = "x".join(str(s) for _, s in self.mesh_axes)
        roles = ",".join(f"{r}={a}" for r, a in self.roles) or "-"
        return (f"{shape} ({roles}) p{self.process_count}"
                + ("+zero1" if self.zero1 else ""))


@dataclass(frozen=True)
class LeafLayout:
    """One pytree leaf's shape/dtype and its partition spec on each
    side. A spec is a tuple with one entry per dim: a mesh axis name or
    None (the PartitionSpec shape, as plain data)."""

    name: str
    shape: Tuple[int, ...]
    itemsize: int
    src_spec: Tuple[Optional[str], ...] = ()
    dst_spec: Tuple[Optional[str], ...] = ()

    @property
    def bytes(self) -> int:
        n = self.itemsize
        for d in self.shape:
            n *= d
        return n


@dataclass(frozen=True)
class LeafPlan:
    name: str
    action: str
    bytes_leaf: int
    bytes_moved: int
    bytes_lower_bound: int
    bytes_slice: int
    bytes_gather: int
    bytes_host: int
    src_spec: Tuple[Optional[str], ...]
    dst_spec: Tuple[Optional[str], ...]


@dataclass(frozen=True)
class ReshardPlan:
    src: Placement
    dst: Placement
    leaves: Tuple[LeafPlan, ...] = field(default_factory=tuple)

    @property
    def bytes_total(self) -> int:
        return sum(l.bytes_leaf for l in self.leaves)

    @property
    def bytes_moved(self) -> int:
        return sum(l.bytes_moved for l in self.leaves)

    @property
    def bytes_lower_bound(self) -> int:
        return sum(l.bytes_lower_bound for l in self.leaves)

    def actions(self) -> dict:
        out = {a: 0 for a in ACTIONS}
        for l in self.leaves:
            out[l.action] += 1
        return {a: n for a, n in out.items() if n}

    def summary(self) -> dict:
        """The `reshard_plan` telemetry payload (and the CLI dry-run
        totals): everything an audit needs to judge the executed move
        against the plan without re-deriving it."""
        return {"src": self.src.describe(), "dst": self.dst.describe(),
                "n_leaves": len(self.leaves), "actions": self.actions(),
                "bytes_total": self.bytes_total,
                "bytes_moved": self.bytes_moved,
                "bytes_lower_bound": self.bytes_lower_bound}


# ------------------------------------------------------------ cost model

def _partition_counts(shape, spec, placement, name):
    """Per-dim partition counts for one side, validating the spec."""
    sizes = placement.axis_sizes
    counts = []
    spec = tuple(spec) + (None,) * (len(shape) - len(spec))
    if len(spec) > len(shape):
        raise PlacementError(
            f"leaf {name!r}: spec {spec} has more entries than dims "
            f"{shape}")
    for d, ax in enumerate(spec):
        if ax is None:
            counts.append(1)
            continue
        if ax not in sizes:
            raise PlacementError(
                f"leaf {name!r}: spec names axis {ax!r} absent from the "
                f"mesh (axes: {sorted(sizes)})")
        n = sizes[ax]
        if n > 1 and shape[d] % n:
            # the target-mesh-larger-than-checkpoint failure row: a dim
            # that cannot split over the requested axis is a refused
            # plan, not a runtime surprise
            raise PlacementError(
                f"leaf {name!r}: dim {d} of {shape} does not divide over "
                f"{n}-way axis {ax!r}")
        counts.append(n)
    return counts


def _aligned_overlap(s: int, t: int) -> Fraction:
    """Resident fraction along one dim when a target block is served by
    its aligned source block (block j of t reads from block
    floor(j*s/t) of s): the summed interval overlap, exact rational."""
    if s == t:
        return Fraction(1)
    total = Fraction(0)
    for j in range(t):
        lo_t, hi_t = Fraction(j, t), Fraction(j + 1, t)
        i = (j * s) // t
        lo_s, hi_s = Fraction(i, s), Fraction(i + 1, s)
        total += max(Fraction(0), min(hi_t, hi_s) - max(lo_t, lo_s))
    return total


def plan_leaf(leaf: LeafLayout, src: Placement, dst: Placement, *,
              force_host: bool = False) -> LeafPlan:
    """Plan one leaf. Deterministic pure function of its arguments."""
    s_counts = _partition_counts(leaf.shape, leaf.src_spec, src, leaf.name)
    t_counts = _partition_counts(leaf.shape, leaf.dst_spec, dst, leaf.name)
    nbytes = leaf.bytes

    s_shards = 1
    for c in s_counts:
        s_shards *= c
    t_shards = 1
    for c in t_counts:
        t_shards *= c
    r_src = max(1, src.n_devices // max(1, s_shards))
    r_dst = max(1, dst.n_devices // max(1, t_shards))

    # resident fraction under the aligned linear-device mapping: the
    # share of each target shard already on its source-aligned device
    resident_frac = Fraction(1)
    for s, t in zip(s_counts, t_counts):
        resident_frac *= _aligned_overlap(s, t)
    need_total = nbytes * r_dst
    resident = int(nbytes * resident_frac * min(r_src, r_dst))
    same_layout = (s_counts == t_counts
                   and tuple(leaf.src_spec) == tuple(leaf.dst_spec)
                   and src.mesh_axes == dst.mesh_axes
                   and src.process_count == dst.process_count)
    if same_layout:
        resident = need_total

    bytes_slice = max(0, need_total - resident)
    bytes_gather = max(bytes_slice, nbytes * dst.n_devices - resident)
    bytes_host = nbytes + need_total  # up to host, back down; no credit

    if force_host:
        action, moved = HOST_FALLBACK, bytes_host
    elif same_layout:
        action, moved = KEEP, 0
    else:
        refines = all(t % s == 0 for s, t in zip(s_counts, t_counts))
        if refines:
            # every target shard is a contiguous slice of one source
            # shard: point-to-point slice exchange reaches the bound
            action, moved = SLICE_EXCHANGE, bytes_slice
        else:
            action, moved = ALLGATHER_SHARD, bytes_gather
    return LeafPlan(
        name=leaf.name, action=action, bytes_leaf=nbytes,
        bytes_moved=moved, bytes_lower_bound=bytes_slice,
        bytes_slice=bytes_slice, bytes_gather=bytes_gather,
        bytes_host=bytes_host, src_spec=tuple(leaf.src_spec),
        dst_spec=tuple(leaf.dst_spec))


def plan_reshard(src: Placement, dst: Placement,
                 leaves: Sequence[LeafLayout], *,
                 force_host: bool = False) -> ReshardPlan:
    """The planner entry point: validate both placements, plan every
    leaf, return the deterministic plan. `force_host=True` models the
    legacy gather-everything-to-host path (lockstep host
    checkpoints) so its cost is comparable on the same scale — the
    engine itself only emits it for non-coexisting mesh pairs."""
    src.validate()
    dst.validate()
    plans = tuple(plan_leaf(leaf, src, dst, force_host=force_host)
                  for leaf in leaves)
    return ReshardPlan(src=src, dst=dst, leaves=plans)
