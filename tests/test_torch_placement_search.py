"""The port's placement search (deeplearning4j_tpu_torch/reshard/search.py)
against the JAX package's, on the CPU.

The search is the reference's, copied: on the builtin profiles, a toy
profile that supports "pipe", and the profile of the transformer LM
read from the port's net (`profile_net`, the canonical shapes), for
fleets of 1 to 8 devices and the train and forward objectives, the
candidates, their exact-rational score breakdowns, the prunes and the
printed tables equal the JAX search's, compared as JSON; the
`placement_search` event carries the same fields.

On a gloo fleet of 4 ranks (tests/torch_parallel_worker.py
`case_search`): the winner for the LM on `FleetShape(1, 4)` (the
port's ranks are its devices) goes to set_mesh unmodified and two SGD
steps land within 1e-5 of the largest param of the JAX net trained
meshless (the test_distributed bound the JAX package's
`test_winner_feeds_set_mesh_and_trains_to_parity` uses), as do a
declarative "data" 2 x "model" 2 Placement (its split leaves really
split) and a "data" 2 x "pipe" 2 one (pipelined, 4 microbatches by
default).
"""

import json

import numpy as np
import pytest

from deeplearning4j_tpu.datasets.api import DataSet as JDataSet
from deeplearning4j_tpu.reshard import search as jsearch
from deeplearning4j_tpu_torch.reshard import search as tsearch
from fleet_util import jax_net, run_fleet
from torch_parallel_worker import flatten

pytestmark = pytest.mark.port

CFG = dict(vocab_size=64, d_model=16, n_heads=2, n_layers=4, d_ff=32,
           max_length=8)
B = 8


def _toy(mod):
    return mod.ModelProfile(
        name="toy",
        leaves=(mod.ParamLeaf("l0/W", (8, 16)), mod.ParamLeaf("l0/b", (16,)),
                mod.ParamLeaf("l1/W", (16, 8)), mod.ParamLeaf("norm/g", (6,))),
        n_layers=2, seq_len=1, supports=("data", "model", "pipe"),
        rules=((r".*l\d/W$", (None, "model")), (r".*l\d/b$", ("model",))))


def _result_json(res):
    return json.dumps(res.to_json(), sort_keys=True)


@pytest.mark.parametrize("profile", ["mlp", "lm", "toy"])
@pytest.mark.parametrize("fleet", ["1x1", "1x4", "2x4", "1x6", "1x8"])
@pytest.mark.parametrize("step", ["train", "forward"])
def test_search_tables_equal_the_jax_search(profile, fleet, step):
    def run(mod):
        prof = (_toy(mod) if profile == "toy"
                else mod.BUILTIN_PROFILES[profile])
        obj = mod.Objective(global_batch=48, step=step)
        try:
            return mod.search_placement(prof, fleet, objective=obj)
        except mod.SearchError as exc:
            return str(exc)

    jres, tres = run(jsearch), run(tsearch)
    if isinstance(jres, str):
        assert tres == jres
        return
    assert _result_json(tres) == _result_json(jres)
    assert tres.table_lines(top=20) == jres.table_lines(top=20)


def test_enumeration_equals_the_jax_search():
    for fleet in ("1x8", "2x4", "3x2"):
        jc, jp = jsearch.enumerate_placements(jsearch.FleetShape.parse(
            fleet))
        tc, tp = tsearch.enumerate_placements(tsearch.FleetShape.parse(
            fleet))
        assert [p.to_json() for p in tc] == [p.to_json() for p in jc]
        assert tp == jp


def test_profile_of_the_ports_net_equals_the_jax_profile():
    """profile_net reads the port's LM as the JAX one reads its own: the
    same leaves (sorted), layer count and rules; so the same ranking on
    a fleet of 4."""
    from deeplearning4j_tpu.models.transformer import transformer_lm as jlm
    from deeplearning4j_tpu_torch.models.transformer import transformer_lm

    jp = jsearch.profile_net(jlm(**CFG).init(), seq_len=8)
    tp = tsearch.profile_net(transformer_lm(**CFG, device="cpu").init(),
                             seq_len=8)
    def key(leaf):
        return (leaf.name, leaf.shape, leaf.itemsize)

    assert sorted(map(key, tp.leaves)) == sorted(map(key, jp.leaves))
    assert (tp.n_layers, tp.seq_len, tp.supports, tp.rules) == (
        jp.n_layers, jp.seq_len, jp.supports, jp.rules)
    obj = (jsearch.Objective(global_batch=8), tsearch.Objective(
        global_batch=8))
    jr = jsearch.search_placement(jp, "1x4", objective=obj[0])
    tr = tsearch.search_placement(tp, "1x4", objective=obj[1])
    assert [c.describe() for c in tr.candidates] == [
        c.describe() for c in jr.candidates]
    assert [c.score for c in tr.candidates] == [c.score
                                                for c in jr.candidates]


def test_search_event_carries_the_jax_fields():
    from deeplearning4j_tpu.telemetry.recorder import (
        Recorder as JRecorder,
        set_default as jset,
    )
    from deeplearning4j_tpu_torch.telemetry import Recorder, set_default

    events = []
    for mod, rec_cls, setter in ((jsearch, JRecorder, jset),
                                 (tsearch, Recorder, set_default)):
        res = mod.search_placement(mod.BUILTIN_PROFILES["mlp"], "1x8")
        rec = rec_cls(path=None) if rec_cls is Recorder else rec_cls()
        prev = setter(rec)
        try:
            mod.emit_search_event(res, path="test", search_ms=1.5)
        finally:
            setter(prev)
        (ev,) = [e for e in rec.events if e["event"] == "placement_search"]
        events.append({k: v for k, v in ev.items()
                       if k not in ("ts", "run_id", "seq", "pid",
                                    "process", "span_id", "parent_id",
                                    "t", "time", "wall")})
    assert events[1] == {k: v for k, v in events[0].items()
                         if k in events[1]}
    assert events[1]["winner"] == "4x2 (data=data,model=model) p1"


def _batches(seed=0):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(2):
        x = rng.integers(0, CFG["vocab_size"], (B, CFG["max_length"]))
        x = x.astype(np.int32)
        out.append((x, np.roll(x, -1, axis=1), None))
    return out


def _pl(mesh, roles):
    return tsearch.Placement.of(mesh, roles).to_json()


CASE = dict(name="search", kind="search", model="lm", cfg=CFG,
            updater="sgd", lr=0.1, batches=_batches(),
            placements=[_pl({"data": 2, "model": 2},
                            {"data": "data", "model": "model"}),
                        _pl({"data": 2, "pipe": 2},
                            {"data": "data", "pipe": "pipe"})])


@pytest.fixture(scope="module")
def fleet(tmp_path_factory):
    return run_fleet(tmp_path_factory.mktemp("search"), 4, [CASE])


def test_winner_feeds_set_mesh_and_trains_to_parity(fleet):
    """The winner (the same on every rank, the JAX search's for this
    net and fleet) goes to set_mesh unmodified and trains to the JAX
    meshless net's params; one placement_search event a search."""
    from deeplearning4j_tpu.models.transformer import transformer_lm as jlm

    jnet = jax_net(CASE)
    for x, y, _ in CASE["batches"]:
        jnet.fit(JDataSet(x, y))
    ref = flatten(jnet.params)
    scale = max(float(np.abs(np.asarray(v)).max()) for v in ref.values())
    want = jsearch.search_placement(
        jsearch.profile_net(jlm(**CFG).init()), "1x4",
        objective=jsearch.Objective(global_batch=B)).winner.describe()
    for out in fleet:
        assert str(out["search/winner"]) == want
        assert int(out["search/search_events"]) == 1
        for arm in ("winner", "p0", "p1"):
            for k, v in ref.items():
                err = float(np.abs(out[f"search/{arm}/params/{k}"]
                                   - np.asarray(v)).max())
                assert err <= 1e-5 * scale, (arm, k, err)
            np.testing.assert_allclose(float(out[f"search/{arm}/score"]),
                                       float(jnet.score_value), rtol=1e-5)


def test_set_mesh_consumes_placements(fleet):
    """A declarative "model" Placement splits its leaves; a "pipe" one
    pipelines over 2 stages."""
    for out in fleet:
        assert int(out["search/p0/split"]) > 0
        assert int(out["search/p1/pipe"]) == 2
        assert int(out["search/p1/split"]) == 0
