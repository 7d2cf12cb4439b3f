"""The port's sharded embedding engine (embedding/engine.py at ep and dp
> 1), the sparse gradient buckets (parallel/overlap.py) and the "data"
meshes of the device pipeline (nlp/device_pipeline.py) and GloVe
(nlp/glove.py), on the CPU.

The JAX package's sharded engine raises `check_rep` under some jax
versions, so the reference is its dense `nlp/lookup.sgns_step` /
`sg_hs_step`: the JAX engine's own contract makes ep = 1 equal those and
ep = 2 equal ep = 1. Here the port's ep = 1 engine holds the JAX dense
steps within 1e-5 (their scores' f32 order), and the port's sharded
arms hold its ep = 1:

- ep = 2, 3 and 4 (each row owned by one shard, the others adding exact
  zeros): bit for bit;
- dp = 2 and ep 2 x dp 2 (the data shards' pairs summed in another
  order): within 1e-6 of the largest table entry, the f32 sum order of a
  few steps;

in one process (`in_process=True`) and over gloo fleets of 2 and 4
ranks (tests/torch_fleet_worker.py `shards`, one shard a rank), where
Word2Vec's `use_engine(True, ep=2)` also trains to ep = 1 bit for bit.
The device pipeline and GloVe with "data" = 2 hold their meshless runs
within the same f32 sum order (GloVe's joined pairs keep the meshless
order: bit for bit).
"""

import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.nlp import lookup as jlookup
from deeplearning4j_tpu.parallel import overlap as joverlap
from deeplearning4j_tpu_torch.distributed.launcher import launch_local
from deeplearning4j_tpu_torch.embedding.engine import (
    EngineLookupView,
    ShardedEmbeddingEngine,
)
from deeplearning4j_tpu_torch.ops.shard_comm import InProcessShards
from deeplearning4j_tpu_torch.parallel import overlap as toverlap
from tests.torch_fleet_worker import (
    engine_arm,
    glove_arm,
    pipeline_arm,
    w2v_fit,
)

pytestmark = pytest.mark.port

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(ROOT, "tests", "torch_fleet_worker.py")
V, D, B, K, L, STEPS = 61, 16, 32, 4, 5, 5
DP_TOL = 1e-6  # of the largest |entry|: f32 sum order over a few steps


def _inputs():
    rng = np.random.default_rng(23)
    arrays = {"dims": np.asarray([V, D]), "lr": np.asarray(0.05),
              "steps": np.asarray(STEPS),
              "codes": rng.integers(0, 2, (B, L)).astype(np.int8),
              "points": rng.integers(0, V, (B, L)).astype(np.int32),
              "mask": rng.random((B, L)) < 0.8}
    for i in range(STEPS):
        arrays[f"center{i}"] = rng.integers(0, V, B).astype(np.int32)
        arrays[f"context{i}"] = rng.integers(0, V, B).astype(np.int32)
        arrays[f"negs{i}"] = rng.integers(0, V, (B, K)).astype(np.int32)
    from deeplearning4j_tpu_torch.nlp.device_pipeline import (
        build_alias_table,
    )

    J, q = build_alias_table(rng.random(V) + 0.1)
    arrays.update(
        pipe_tokens=rng.integers(0, V, 4096).astype(np.int32),
        pipe_sents=np.repeat(np.arange(256), 16).astype(np.int32),
        pipe_J=J, pipe_q=q,
        pipe_syn0=((rng.random((V, D)) - 0.5) / D).astype(np.float32),
        gl_i=rng.integers(0, V, 512).astype(np.int64),
        gl_j=rng.integers(0, V, 512).astype(np.int64),
        gl_logx=rng.random(512).astype(np.float32),
        gl_fx=rng.random(512).astype(np.float32))
    return arrays


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread: these small steps are launch-bound, and a
    thread pool a core oversubscribes a host that runs other tests."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def inputs():
    return _inputs()


@pytest.fixture(scope="module")
def reference(inputs):
    """The port's ep = 1, meshless runs."""
    torch.manual_seed(0)
    out = engine_arm(inputs, 1, 1)
    out.update(pipeline_arm(inputs, None))
    out.update(glove_arm(inputs, None))
    return out


def _assert_arm(got, ref, prefix, exact):
    """An arm's tables and losses against ep = 1's: equal (`exact`) or
    within the f32 sum order of a few steps."""
    for name in ("sgns/syn0", "sgns/syn1neg", "hs/syn0", "hs/syn1",
                 "sgns/loss", "hs/loss"):
        a, b = got[f"{prefix}{name}"], ref[name]
        if exact:
            np.testing.assert_array_equal(a, b, err_msg=prefix + name)
        elif name.endswith("loss"):
            np.testing.assert_allclose(a, b, rtol=1e-6, err_msg=prefix + name)
        else:
            scale = max(float(np.abs(b).max()), 1e-12)
            assert float(np.abs(a - b).max()) <= DP_TOL * scale, (prefix,
                                                                  name)


def test_ep1_engine_matches_jax_dense_steps(inputs):
    """ep = 1 from the JAX tables: SGNS and HS steps against
    nlp/lookup.sgns_step / sg_hs_step within 1e-5."""
    from deeplearning4j_tpu.nlp.lookup import InMemoryLookupTable

    tab = InMemoryLookupTable(V, D, seed=5)
    init = {n: np.asarray(getattr(tab, n)) for n in ("syn0", "syn1",
                                                     "syn1neg")}
    for use_hs in (False, True):
        eng = ShardedEmbeddingEngine(V, D, negative=K, use_hs=use_hs,
                                     device="cpu")
        for n, a in init.items():
            setattr(eng, n, torch.from_numpy(a.copy()))
        lr = float(inputs["lr"])
        # fresh device arrays: the JAX steps donate their tables
        jt = {n: jnp.asarray(a.copy()) for n, a in init.items()}
        for i in range(STEPS):
            c = inputs[f"center{i}"]
            if use_hs:
                jt["syn0"], jt["syn1"], jl = jlookup.sg_hs_step(
                    jt["syn0"], jt["syn1"], c, inputs["codes"],
                    inputs["points"], inputs["mask"], lr)
                tl = eng.hs_step(c, inputs["codes"], inputs["points"],
                                 inputs["mask"], lr)
            else:
                jt["syn0"], jt["syn1neg"], jl = jlookup.sgns_step(
                    jt["syn0"], jt["syn1neg"], c, inputs[f"context{i}"],
                    inputs[f"negs{i}"], lr)
                tl = eng.sgns_step(c, inputs[f"context{i}"],
                                   inputs[f"negs{i}"], lr)
            np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5)
        for n in ("syn0", "syn1" if use_hs else "syn1neg"):
            np.testing.assert_allclose(getattr(eng, n).numpy(),
                                       np.asarray(jt[n]), atol=1e-5)


@pytest.mark.parametrize("ep,dp", [(2, 1), (3, 1), (4, 1), (1, 2), (2, 2)])
def test_in_process_shards_hold_ep1(inputs, reference, ep, dp):
    """All ep x dp shards in one process: ep bit for bit with ep = 1, dp
    within f32 sum order; one shard holds 1/ep of the table bytes."""
    got = engine_arm(inputs, ep, dp, in_process=True)
    _assert_arm({f"x/{k}": v for k, v in got.items()}, reference, "x/",
                exact=dp == 1)
    padded = -(-V // ep) * ep
    assert int(got["table_bytes"]) == 3 * (padded // ep) * D * 4


def _fleet(tmp_path, n, inputs):
    path = tmp_path / f"inputs{n}.npz"
    np.savez(path, **inputs)
    results = launch_local(
        [sys.executable, WORKER, "shards", str(path), str(tmp_path)],
        n_processes=n, device="cpu", timeout=120.0, death_grace=5.0,
        cwd=ROOT, extra_env={"PYTHONPATH": ROOT, "OMP_NUM_THREADS": "1"})
    for r in results:
        assert r.exit_class == "clean", "\n".join(r.lines[-60:])
    return dict(np.load(tmp_path / f"shards{n}.npz"))


@pytest.fixture(scope="module")
def fleet2(tmp_path_factory, inputs):
    """The 2-rank gloo fleet's results (tests/torch_fleet_worker.py
    `shards`)."""
    return _fleet(tmp_path_factory.mktemp("fleet2"), 2, inputs)


def test_gloo_two_ranks(fleet2, reference):
    """ep = 2 and dp = 2 over a 2-rank gloo fleet, then the device
    pipeline's and GloVe's "data" = 2 over the same ranks."""
    got = fleet2
    _assert_arm(got, reference, "ep2dp1/", exact=True)
    _assert_arm(got, reference, "ep1dp2/", exact=False)
    # a shard of ep = 2 holds half the padded table
    assert int(got["ep2dp1/table_bytes"]) == 3 * (-(-V // 2)) * D * 4
    assert int(got["ep1dp2/table_bytes"]) == 3 * V * D * 4
    _assert_pipeline(got, reference)
    _assert_glove(got, reference)


def test_gloo_four_ranks(tmp_path, inputs, reference):
    """ep = 4 and ep 2 x dp 2 over a 4-rank gloo fleet."""
    got = _fleet(tmp_path, 4, inputs)
    _assert_arm(got, reference, "ep4dp1/", exact=True)
    _assert_arm(got, reference, "ep2dp2/", exact=False)


def _assert_pipeline(got, ref):
    for name in ("pipe/syn0", "pipe/syn1neg"):
        scale = float(np.abs(ref[name]).max())
        assert float(np.abs(got[name] - ref[name]).max()) <= DP_TOL * scale
    np.testing.assert_allclose(got["pipe/loss"], ref["pipe/loss"],
                               rtol=1e-6)
    np.testing.assert_array_equal(got["pipe/pairs"], ref["pipe/pairs"])


def _assert_glove(got, ref):
    for name in ("W", "Wc", "b", "bc", "hW", "hWc", "hb", "hbc"):
        np.testing.assert_array_equal(got[f"glove/{name}"],
                                      ref[f"glove/{name}"], err_msg=name)
    np.testing.assert_allclose(got["glove/loss"], ref["glove/loss"],
                               rtol=1e-6)


@pytest.mark.parametrize("n", [2, 4])
def test_pipeline_and_glove_in_process_shards(inputs, reference, n):
    """The device pipeline's and GloVe's "data" = n in one process."""
    got = pipeline_arm(inputs, InProcessShards(n))
    got.update(glove_arm(inputs, InProcessShards(n)))
    _assert_pipeline(got, reference)
    _assert_glove(got, reference)


def test_sparse_bucket_plans_match_jax():
    """SparseBucket bytes and summaries and the plan errors, word for
    word the JAX package's."""
    for args, kw in ((("sgns_syn0", 512, 64), {"n_participants": 2}),
                     (("hs_syn1", 2560, 128), {"n_participants": 4}),
                     (("x", 3, 5), {"index_dtype": "int64"})):
        got = toverlap.plan_sparse_bucket(*args, **kw)
        ref = joverlap.plan_sparse_bucket(*args, **kw)
        assert got.summary() == ref.summary()
        assert (got.n_bytes, got.gathered_bytes) == (ref.n_bytes,
                                                     ref.gathered_bytes)
    for args, kw in ((("e", 0, 8), {}), (("e", 4, -1), {}),
                     (("e", 4, 8), {"n_participants": 0})):
        with pytest.raises(ValueError) as got:
            toverlap.plan_sparse_bucket(*args, **kw)
        with pytest.raises(ValueError) as ref:
            joverlap.plan_sparse_bucket(*args, **kw)
        assert str(got.value) == str(ref.value)
    plan = toverlap.plan_sparse_bucket("emb", 4, 8)
    for idx, vals in ((torch.zeros(4, dtype=torch.long), torch.zeros(4)),
                      (torch.zeros(5, dtype=torch.long), torch.zeros(5, 8))):
        with pytest.raises(ValueError) as got:
            toverlap.sparse_bucket_reduce([idx], [vals], bucket=plan)
        with pytest.raises(ValueError) as ref:
            joverlap.sparse_bucket_reduce(jnp.asarray(idx.numpy()),
                                          jnp.asarray(vals.numpy()), "data",
                                          bucket=joverlap.plan_sparse_bucket(
                                              "emb", 4, 8))
        assert str(got.value) == str(ref.value)
    # in process: the pairs joined in shard order, never densified
    i, v = toverlap.sparse_bucket_reduce(
        [torch.tensor([3, 1]), torch.tensor([1, 0])],
        [torch.ones(2, 8), 2 * torch.ones(2, 8)])
    assert i.tolist() == [3, 1, 1, 0] and v.shape == (4, 8)


def test_word2vec_and_serving_over_ep2(fleet2):
    """Word2Vec through the engine at ep = 2 over the 2-rank gloo fleet
    trains to ep = 1's tables bit for bit, and the /embed gather of an
    ep = 2 engine (its shards in this process, wrapped in the view)
    returns its rows exactly, its span naming ep = 2."""
    from deeplearning4j_tpu_torch.embedding.serving import (
        EmbeddingServingEngine,
    )
    from deeplearning4j_tpu_torch.telemetry import Recorder

    one = w2v_fit()
    assert int(fleet2["w2v/ep"]) == 2
    np.testing.assert_array_equal(fleet2["w2v/syn0"],
                                  one.lookup_table.vectors())
    np.testing.assert_array_equal(fleet2["w2v/syn1neg"],
                                  one.lookup_table.syn1neg.numpy())
    eng = ShardedEmbeddingEngine(*fleet2["w2v/syn0"].shape, ep=2,
                                 device="cpu", in_process=True)
    eng.syn0 = fleet2["w2v/syn0"]
    view = EngineLookupView(eng)
    rec = Recorder()
    server = EmbeddingServingEngine(view, device="cpu", recorder=rec)
    ids = np.asarray([0, 5, 39, 7], np.int32)
    rows = server._embed_rows(ids)
    np.testing.assert_array_equal(rows.numpy(), fleet2["w2v/syn0"][ids])
    spans = [e for e in rec.events if e.get("name") == "gather"]
    assert spans and all(e["ep"] == 2 for e in spans)
