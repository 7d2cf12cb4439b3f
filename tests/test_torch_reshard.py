"""The port's resharding engine (deeplearning4j_tpu_torch/reshard/)
against the JAX package's, on the CPU.

The planner: on the JAX package's own test inputs and a matrix of
placements, the port's `plan_reshard` and `plan_for_placements` (over
the canonical params of the LM below) return the JAX plans, compared as
JSON; malformed placements and layouts raise the same `PlacementError`.

The matrix, on gloo fleets of 4 and 2 ranks (tests/torch_parallel_worker.py
`case_reshard`), for the LM of V 64, d 16, 4 heads (every split of 2 or
4 divides), 2 blocks, d_ff 32, T 8, B 8 from the JAX net's params:

- checkpoints: "data" 2 x "model" 2 -> one rank, one rank -> "data" 2 x
  "model" 2 and -> "pipe" 2 x "model" 2 and -> "pipe" 2, ZeRO-1's Adam
  moments of 4 ranks -> 2: the restored canonical params and optimizer
  state equal the saved ones bit for bit, with a `reshard_plan` event;
  one step of the restored placed net equals, bit for bit, one step of
  a twin restored meshless and placed the same way;
- `resume_from(dir, target_mesh=..., target_axes=...)`: a {"data": 2}
  checkpoint into {"model": 2} and into {"pipe": 2}, bit for bit with a
  whole resume followed by the same set_mesh, the bytes read the plan's;
- live moves (`set_mesh` of a placed net, SGD): {"model": 2, "data": 2}
  -> {"model": 4} -> {"data": 2, "model": 2} -> {"model": 4} -> None: the
  canonical params equal the source's bit for bit after every move, each
  move of a placed net records its plan, and the bytes that crossed
  ranks, summed over the ranks, are the plan's and its lower bound: the
  port's ranks sit row-major on the mesh, so model-major 2 x 2 -> 4
  moves nothing (each rank holds its quarter), 4 -> data-major 2 x 2
  1.5 split leaves' worth and data-major 2 x 2 -> 4 half a split leaf's
  worth.
"""

import dataclasses
import json

import numpy as np
import pytest
import torch

from deeplearning4j_tpu.reshard import executor as jex
from deeplearning4j_tpu.reshard import planner as jplanner
from deeplearning4j_tpu_torch.reshard import executor as tex
from deeplearning4j_tpu_torch.reshard import planner as tplanner
from fleet_util import jax_net, run_fleet
from torch_parallel_worker import flat_opt_state, flatten

pytestmark = pytest.mark.port

CFG = dict(vocab_size=64, d_model=16, n_heads=4, n_layers=2, d_ff=32,
           max_length=8)
B = 8

D2M2 = {"mesh": {"data": 2, "model": 2},
        "axes": {"data": "data", "model": "model"}}
M2D2 = {"mesh": {"model": 2, "data": 2},
        "axes": {"data": "data", "model": "model"}}
M4 = {"mesh": {"model": 4}, "axes": {"model": "model"}}
P2M2 = {"mesh": {"pipe": 2, "model": 2},
        "axes": {"pipe": "pipe", "model": "model"}, "M": 2}
P2 = {"mesh": {"pipe": 2}, "axes": {"pipe": "pipe"}, "M": 2}
Z4 = {"mesh": {"data": 4}, "axes": {"data": "data"}, "zero1": True}
Z2 = {"mesh": {"data": 2}, "axes": {"data": "data"}, "zero1": True}
D2 = {"mesh": {"data": 2}, "axes": {"data": "data"}}
M2 = {"mesh": {"model": 2}, "axes": {"model": "model"}}


def _batches(seed=0):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(2):
        x = rng.integers(0, CFG["vocab_size"], (B, CFG["max_length"]))
        x = x.astype(np.int32)
        out.append((x, np.roll(x, -1, axis=1), None))
    return out


def _case(name, **kw):
    case = dict(name=name, kind="reshard", model="lm", cfg=CFG,
                batches=_batches())
    case.update(kw)
    return case


def _as_json(obj):
    return json.dumps(dataclasses.asdict(obj), sort_keys=True, default=str)


# --------------------------------------------------------------- planner

LEAVES = [("w", (8, 24), 4, (None, "model"), (None, "model")),
          ("b", (24,), 4, ("model",), ()),
          ("r", (8, 8), 4, (), ())]
PLACEMENTS = [
    ({"data": 2, "model": 4}, {"data": "data", "model": "model"}, 1, False),
    ({"data": 2, "model": 2}, {"data": "data", "model": "model"}, 1, False),
    ({"data": 1}, {"data": "data"}, 1, False),
    ({"data": 8}, {"data": "data"}, 2, True),
    ({"model": 4}, {"model": "model"}, 4, False),
]


def _pl(mod, p):
    return mod.Placement.of(p[0], p[1], process_count=p[2], zero1=p[3])


@pytest.mark.parametrize("force", [False, True])
def test_plans_equal_the_jax_planner(force):
    """Every pair of placements over the JAX test's leaves (those whose
    specs the pair's meshes carry): the same plan, field for field, as
    JSON."""
    n = 0
    for a in PLACEMENTS:
        for b in PLACEMENTS:
            leaves = [x for x in LEAVES
                      if all(ax is None or ax in a[0] for ax in x[3])
                      and all(ax is None or ax in b[0] for ax in x[4])]
            if not leaves:
                continue
            jp = jplanner.plan_reshard(
                _pl(jplanner, a), _pl(jplanner, b),
                [jplanner.LeafLayout(*x) for x in leaves], force_host=force)
            tp = tplanner.plan_reshard(
                _pl(tplanner, a), _pl(tplanner, b),
                [tplanner.LeafLayout(*x) for x in leaves], force_host=force)
            assert _as_json(tp) == _as_json(jp)
            assert tp.summary() == jp.summary()
            n += 1
    assert n >= 15


@pytest.mark.parametrize("bad", [
    lambda m: m.Placement.of({}, {}),
    lambda m: m.Placement.of({"data": 2}, {"bogus": "data"}),
    lambda m: m.Placement.of({"data": 2}, {"data": "data"},
                             process_count=3),
    lambda m: m.Placement.of({"data": 2, "model": 2},
                             {"data": "data", "model": "model"}, zero1=True),
    lambda m: m.plan_reshard(
        m.Placement.of({"model": 4}, {"model": "model"}),
        m.Placement.of({"model": 4}, {"model": "model"}),
        [m.LeafLayout("w", (9, 7), 4, (None, "model"), ())]),
])
def test_refusals_equal_the_jax_planner(bad):
    with pytest.raises(jplanner.PlacementError) as je:
        bad(jplanner)
    with pytest.raises(tplanner.PlacementError) as te:
        bad(tplanner)
    assert str(te.value) == str(je.value)


@pytest.mark.parametrize("src,dst", [(D2M2, M4), (M4, None), (None, D2M2),
                                     (D2M2, P2M2)])
def test_net_plans_equal_the_jax_executors(src, dst):
    """plan_for_placements over the LM's canonical params (the JAX net
    and the port's of the same conf): the JAX executor's plan, leaf
    names included, as JSON."""
    from deeplearning4j_tpu_torch.models.transformer import transformer_lm

    def pl(mod, spec):
        if spec is None:
            return mod.Placement.solo()
        return mod.Placement.of(spec["mesh"], spec["axes"])

    jnet = jax_net(_case("plan"))
    jnet.opt_state = None
    jplan, _, _ = jex.plan_for_placements(jnet, pl(jplanner, src),
                                          pl(jplanner, dst))
    net = transformer_lm(**CFG, device="cpu").init()
    tplan, _ = tex.plan_for_placements(net.params, pl(tplanner, src),
                                       pl(tplanner, dst))
    assert _as_json(tplan) == _as_json(jplan)


# ---------------------------------------------------------------- matrix

@pytest.fixture(scope="module")
def matrix(tmp_path_factory):
    """The solo checkpoint (made here, from the JAX params, after one
    Adam step), the 4-rank fleet, then the 2-rank fleet."""
    from deeplearning4j_tpu_torch.datasets import DataSet
    from deeplearning4j_tpu_torch.util.checkpoint import Checkpointer
    from torch_parallel_worker import _net
    from fleet_util import fleet_inputs

    d = tmp_path_factory.mktemp("reshard")
    inputs = fleet_inputs(_case("solo"))
    np.savez(d / "solo_in.npz", **inputs)
    solo = _net(_case("solo"), np.load(d / "solo_in.npz"))
    x, y, _ = _batches()[0]
    solo.fit(DataSet(x, y))
    Checkpointer(str(d / "solo" / "rank0")).save(solo)
    want = {f"params/{k}": v for k, v in flatten(
        {k: {n: t.numpy() for n, t in p.items()}
         for k, p in solo.params.items()}).items()}
    want.update({f"opt/{k}": v for k, v in
                 flat_opt_state(solo.opt_state).items()})
    c4 = [_case("save_d2m2", mode="save", src=D2M2, ckpt=str(d / "d2m2")),
          _case("save_z4", mode="save", src=Z4, ckpt=str(d / "z4")),
          _case("to_d2m2", mode="restore", dst=D2M2,
                src_ckpt=str(d / "solo")),
          _case("to_p2m2", mode="restore", dst=P2M2,
                src_ckpt=str(d / "solo")),
          _case("live", mode="live", updater="sgd", lr=0.1,
                chain=[M2D2, M4, D2M2, M4, None])]
    out4 = run_fleet(d, 4, c4)
    c2 = [_case("z4_to_z2", mode="restore", dst=Z2, src_ckpt=str(d / "z4")),
          _case("to_p2", mode="restore", dst=P2, src_ckpt=str(d / "solo")),
          _case("save_d2", mode="save", src=D2, ckpt=str(d / "d2")),
          _case("resume_to_m2", mode="resume", dst=M2,
                src_ckpt=str(d / "d2")),
          _case("resume_to_p2", mode="resume",
                dst={k: v for k, v in P2.items() if k != "M"},
                src_ckpt=str(d / "d2"))]
    out2 = run_fleet(tmp_path_factory.mktemp("reshard2"), 2, c2)
    return {"dir": d, "solo": want, 4: out4, 2: out2}


def _equal(out, prefix, want):
    keys = [k for k in want if k.startswith(("params/", "opt/"))]
    assert keys
    for k in keys:
        np.testing.assert_array_equal(out[f"{prefix}{k}"], want[k],
                                      err_msg=k)


def _saved(out, name):
    return {k[len(name) + 1:]: v for k, v in out.items()
            if k.startswith(f"{name}/params/") or k.startswith(
                f"{name}/opt/")}


@pytest.mark.parametrize("name,n", [("to_d2m2", 4), ("to_p2m2", 4),
                                    ("to_p2", 2)])
def test_solo_checkpoint_restores_into_placed_nets(matrix, name, n):
    """One rank -> "data" 2 x "model" 2, "pipe" 2 x "model" 2 and "pipe"
    2: every rank's canonical params and Adam moments equal the saved
    net's bit for bit, the restore records its plan, and one step of the
    restored placed net is the step of a twin restored meshless and
    placed the same way, bit for bit."""
    for out in matrix[n]:
        _equal(out, f"{name}/restored/", matrix["solo"])
        assert int(out[f"{name}/restore_plans"]) == 1
        assert 0 < int(out[f"{name}/restore_moved"]) == int(
            out[f"{name}/restore_planned"])
        twin = _saved(out, f"{name}/twin")
        _equal(out, f"{name}/stepped/", twin)
        assert float(out[f"{name}/stepped_score"]) == float(
            out[f"{name}/twin_score"])


@pytest.mark.parametrize("name", ["resume_to_m2", "resume_to_p2"])
def test_resume_from_into_a_target_placement(matrix, name):
    """A checkpoint written under {"data": 2} restored by
    resume_from(dir, target_mesh=..., target_axes=...) into {"model":
    2} and into {"pipe": 2}: the net is left placed, every rank's
    canonical params and Adam moments equal the saved net's bit for
    bit, the restore records its plan and the bytes each rank read are
    the plan's, and one step equals, bit for bit, the step of a twin
    that resumes whole and then takes the same set_mesh. A missing named
    step raises FileNotFoundError; an empty directory resumes from 0.
    (The 2-rank gloo fleet, launch deadline 120 s.)"""
    saved = _saved(matrix[2][0], "save_d2")
    for out in matrix[2]:
        assert int(out[f"{name}/start"]) == 1
        assert bool(out[f"{name}/placed"])
        _equal(out, f"{name}/restored/", saved)
        assert int(out[f"{name}/restore_plans"]) == 1
        assert 0 < int(out[f"{name}/restore_moved"]) == int(
            out[f"{name}/restore_planned"])
        _equal(out, f"{name}/stepped/", _saved(out, f"{name}/twin"))
        assert float(out[f"{name}/stepped_score"]) == float(
            out[f"{name}/twin_score"])
        assert bool(out[f"{name}/missing_raises"])
        assert int(out[f"{name}/cold_start"]) == 0


def test_placed_checkpoint_restores_on_one_rank(matrix):
    """"data" 2 x "model" 2 -> one rank: a meshless net restores the
    checkpoint the placed fleet wrote, bit for bit, the move from 2 x 2
    on the record."""
    from deeplearning4j_tpu_torch.models.transformer import transformer_lm
    from deeplearning4j_tpu_torch.telemetry import Recorder, set_default
    from deeplearning4j_tpu_torch.util.checkpoint import Checkpointer

    want = _saved(matrix[4][0], "save_d2m2")
    for out in matrix[4][1:]:
        np.testing.assert_equal(_saved(out, "save_d2m2"), want)
    net = transformer_lm(**CFG, device="cpu").init()
    rec = Recorder(path=None)
    prev = set_default(rec)
    try:
        Checkpointer(str(matrix["dir"] / "d2m2" / "rank0")).restore(net)
    finally:
        set_default(prev)
    got = {f"params/{k}": v for k, v in flatten(
        {k: {n: t.numpy() for n, t in p.items()}
         for k, p in net.params.items()}).items()}
    got.update({f"opt/{k}": v for k, v in
                flat_opt_state(net.opt_state).items()})
    np.testing.assert_equal(got, want)
    plans = [e for e in rec.events if e.get("event") == "reshard_plan"]
    assert plans and plans[0]["path"] == "checkpoint"
    assert plans[0]["src"].startswith("2x2")


def test_zero1_moments_restore_from_4_ranks_to_2(matrix):
    """ZeRO-1 over 4 ranks -> ZeRO-1 over 2: the Adam moments (split by
    rows over the data axis on both sides) and params restore bit for
    bit, reading the bytes the plan states, and the next step agrees
    with the twin's."""
    want = _saved(matrix[4][0], "save_z4")
    assert any(k.startswith("opt/") for k in want)
    for out in matrix[2]:
        _equal(out, "z4_to_z2/restored/", want)
        assert 0 < int(out["z4_to_z2/restore_moved"]) == int(
            out["z4_to_z2/restore_planned"])
        _equal(out, "z4_to_z2/stepped/", _saved(out, "z4_to_z2/twin"))


def _split_bytes():
    """The bytes of the LM's leaves the "model" rules split (f32)."""
    from deeplearning4j_tpu_torch.models.transformer import transformer_lm
    from deeplearning4j_tpu_torch.nn import tree
    from deeplearning4j_tpu_torch.parallel.tensor_parallel import (
        TRANSFORMER_TP_RULES,
        spec_for,
    )
    from types import SimpleNamespace

    mesh = SimpleNamespace(shape={"model": 4})
    net = transformer_lm(**CFG, device="cpu").init()
    return sum(t.numel() * 4 for p, t in tree.leaves(net.params)
               if spec_for("/".join(p), mesh, TRANSFORMER_TP_RULES))


def test_live_moves_keep_the_trees_and_count_their_bytes(matrix):
    """The live chain (module docstring): the canonical params after
    each move equal the source's bit for bit on every rank; each move
    of a placed net records one plan; the bytes that moved are exactly
    0, 1.5 and 0.5 split leaves' worth, the plan's bytes and its lower
    bound; the net still trains after the last move."""
    split = _split_bytes()
    want_moved = {1: 0, 2: 3 * split // 2, 3: split // 2}
    for out in matrix[4]:
        ref = {k[len("live/0/"):]: v for k, v in out.items()
               if k.startswith("live/0/params/")}
        assert ref
        for i in range(1, 5):
            for k, v in ref.items():
                np.testing.assert_array_equal(out[f"live/{i}/{k}"], v,
                                              err_msg=f"move {i} {k}")
        for i in (1, 2, 3):
            assert int(out[f"live/{i}/plans"]) == 1
            for what in ("moved", "planned", "lower_bound"):
                assert int(out[f"live/{i}/bytes_{what}"]) == want_moved[i], (
                    i, what)
        assert int(out["live/4/plans"]) == 0
        assert np.isfinite(float(out["live/after_score"]))


def test_engine_accepts_any_mesh_checkpoint(matrix):
    """A serving engine of the port restores the checkpoint the "data" 2
    x "model" 2 fleet wrote (canonical trees: any training mesh), with
    the plan on the record, and predicts as the restored net does."""
    from deeplearning4j_tpu_torch.models.transformer import transformer_lm
    from deeplearning4j_tpu_torch.serving import (
        BucketLattice,
        InferenceEngine,
    )
    from deeplearning4j_tpu_torch.telemetry import Recorder, set_default
    from deeplearning4j_tpu_torch.util.checkpoint import Checkpointer

    ckpt = str(matrix["dir"] / "d2m2" / "rank0")
    ref = transformer_lm(**CFG, device="cpu").init()
    Checkpointer(ckpt).restore(ref)
    x = _batches(5)[0][0][:1].astype(np.int64)
    expected = ref.output(x).numpy()
    rec = Recorder(path=None)
    prev = set_default(rec)
    try:
        engine = InferenceEngine(
            transformer_lm(**CFG, device="cpu"),
            BucketLattice((1, 2), seq_lens=(CFG["max_length"],)),
            sequence=True, checkpoint=ckpt, recorder=rec)
        engine.start()
        got = np.asarray(engine.predict(x[0]))
        engine.drain()
    finally:
        set_default(prev)
    plans = [e for e in rec.events if e.get("event") == "reshard_plan"]
    assert plans and plans[0]["path"] == "checkpoint"
    np.testing.assert_allclose(got, expected.reshape(got.shape), rtol=0,
                               atol=1e-6)


def test_restore_leaves_nothing_outside_the_ranks_share():
    """The executor's layouts: under "pipe" 2 x "model" 2 a rank of
    stage 1 holds none of stage 0's leaves and its heads' q, k and v
    columns of its own stage's packed projection."""
    from types import SimpleNamespace

    from deeplearning4j_tpu_torch.parallel.tensor_parallel import (
        qkv_columns,
    )

    coords = {3: {"pipe": 1, "model": 1}}
    mesh = SimpleNamespace(coords_of=lambda r: coords[r],
                           axis_size=lambda a: 2)
    plan = SimpleNamespace(stage_of={"blk0_attn": 0, "blk1_attn": 1})
    pipe = SimpleNamespace(plan=plan, pipe_axis="pipe")
    split = SimpleNamespace(leaves={("blk1_attn", "Wqkv"): ("model", 1, 4)})
    like = {("blk0_attn", "Wqkv"): ((16, 48), torch.float32),
            ("blk1_attn", "Wqkv"): ((16, 48), torch.float32)}
    lay = tex.PortLayout(like, 4, mesh, split, None, pipe)
    assert lay.holding(3, ("blk0_attn", "Wqkv")) is None
    got = lay.holding(3, ("blk1_attn", "Wqkv"))
    assert list(got) == [1]
    assert torch.equal(got[1], qkv_columns(16, 4, 2, 1))


def test_in_process_moves_of_model_shards():
    """reshard_in_process, what the card runs at one rank: the LM whole
    -> 2 "model" shards in one process gives each shard its
    tensor_parallel slice (the packed QKV by heads) bit for bit, and
    back -> 1 the whole params bit for bit. The bytes that cross shards
    are the plan's and its lower bound: going out, shard 1's half of
    each split leaf and every whole leaf (slice_exchange); going back,
    shard 1's halves (allgather_shard; the whole leaves are kept)."""
    from deeplearning4j_tpu_torch.models.transformer import transformer_lm
    from deeplearning4j_tpu_torch.nn import tree
    from deeplearning4j_tpu_torch.parallel.tensor_parallel import (
        SplitPlan,
        resolve_rules,
        shard_slice,
    )

    net = transformer_lm(**CFG, device="cpu").init()
    like = {p: (tuple(t.shape), t.dtype) for p, t in tree.leaves(net.params)}
    mesh = tex.virtual_mesh({"model": 2}, "cpu")
    split = SplitPlan(net, mesh, resolve_rules({"model": "model"}))
    whole = tex.PortLayout(like, 1)
    two = tex.PortLayout(like, 2, mesh, split)
    solo = tplanner.Placement.solo()
    m2 = tplanner.Placement.of({"model": 2}, {"model": "model"},
                               process_count=2)
    plan, out_bytes, shards = tex.reshard_in_process(
        {0: net.params}, whole, two, src_pl=solo, dst_pl=m2)
    split_bytes = sum(torch.Size(like[p][0]).numel() * 4
                      for p in split.leaves)
    n_split = len(split.leaves)
    whole_bytes = sum(torch.Size(s).numel() * 4 for p, (s, _) in like.items()
                      if p not in split.leaves)
    assert (out_bytes == plan.bytes_moved == plan.bytes_lower_bound
            == split_bytes // 2 + whole_bytes)
    assert plan.actions() == {"slice_exchange": len(like)}
    for r in (0, 1):
        for path, t in tree.leaves(net.params):
            got = tree.get(shards[r], path)
            if path in split.leaves:
                _, dim, heads = split.leaves[path]
                t = shard_slice(t, dim, 2, r, heads)
            assert torch.equal(got, t), (r, path)
    plan, back_bytes, back = tex.reshard_in_process(
        shards, two, whole, src_pl=m2, dst_pl=solo)
    assert (back_bytes == plan.bytes_moved == plan.bytes_lower_bound
            == split_bytes // 2)
    assert plan.actions() == {"keep": len(like) - n_split,
                              "allgather_shard": n_split}
    for path, t in tree.leaves(net.params):
        assert torch.equal(tree.get(back[0], path), t), path
