"""Data parallelism of the port (parallel/, nn/training.py's mesh step)
against the JAX package on the CPU.

The port runs one process per device: its ranks are subprocesses on the
CPU (gloo), started by the port's own launcher with a deadline
(`launch_local(..., timeout=...)`; a rank that fails or is reaped fails
the test), running tests/torch_parallel_worker.py; they import neither
jax nor the JAX package and write their results to `tmp_path`. The JAX
package runs in this process on as many of its 8 virtual CPU devices
(tests/conftest.py) as the port has ranks. Both start from the same
params (made by the JAX package, copied with `weights_io`) and see the
same batches, made with numpy from a seed.

The updaters are linear in the gradient (SGD, Nesterov momentum): Adam's
first steps move a weight by about lr whatever the size of its gradient,
so where a gradient is zero to rounding (the key slice of bqkv, a
convolution bias before a batch norm) the two packages' rounding would
steer it, not the code under test.

Tolerances, after three steps, each against the largest entry of the
JAX array (or, for params, of the JAX net's params): f32 params 1e-5
for the LM, 1e-4 for ResNet-20 and its batch-norm state (global batch
statistics through three batch norms a block: the sums are taken in
another order, split over the ranks); the loss 1e-5 relative. The
Solver path under a mesh (the MLP, 3 line-searched iterations a batch)
is held to the JAX package's solve under the same mesh (1e-5 of the
largest entry on each param) and to the port's meshless solve (1e-5),
of the same params and batches, and 1e-5 relative on the score
(tests/test_torch_solvers.py's X_ATOL and SCORE_RTOL).
"""

import jax
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.datasets.api import DataSet as JDataSet
from deeplearning4j_tpu.datasets.iterators import (
    ListDataSetIterator as JListIt,
)
from deeplearning4j_tpu.models.transformer import transformer_lm as jax_lm
from deeplearning4j_tpu.parallel import data_parallel as jdp
from deeplearning4j_tpu.parallel.mesh import make_mesh as jax_make_mesh
from deeplearning4j_tpu.parallel.overlap import plan_buckets as jax_plan
from deeplearning4j_tpu_torch.models.transformer import (
    transformer_lm as torch_lm,
)
from deeplearning4j_tpu_torch.parallel.overlap import plan_buckets
from fleet_util import assert_trained_close as _assert_trained_close
from fleet_util import jax_net as _jax_net
from fleet_util import run_fleet
from torch_parallel_worker import flatten as _flatten
from torch_parallel_worker import mlp_conf, set_updater

pytestmark = pytest.mark.port

LM_CFG = dict(vocab_size=64, d_model=32, n_heads=2, n_layers=2, d_ff=64,
              max_length=16)
# dropout 0.1 on the packed flash route (T = 512, head dim 128)
DROP_CFG = dict(vocab_size=64, d_model=256, n_heads=2, n_layers=1, d_ff=64,
                max_length=512, dropout=0.1)
B, STEPS = 8, 3
LM_TOL = 1e-5
RESNET_TOL = 1e-4
BUCKETS = (4096, 1 << 30)
# tests/test_torch_solvers.py's tolerances of a solve
X_ATOL, SCORE_RTOL = 1e-5, 1e-5
# the MLP's head split on its classes over "model" (a gathered head):
# the solver's inner products sum the split leaves over the axis
SOLVER_TP_RULES = [(r"layer_1/W$", (None, "model")),
                   (r"layer_1/b$", ("model",))]


def _lm_batches(seed, masked, cfg=LM_CFG, rows=B):
    rng = np.random.default_rng(seed)
    T = cfg["max_length"]
    out = []
    for _ in range(STEPS):
        toks = rng.integers(0, cfg["vocab_size"], (rows, T)).astype(np.int32)
        kw = {}
        if masked:
            lengths = rng.integers(2, T + 1, rows)
            kw["lmask"] = (np.arange(T)[None, :]
                           < lengths[:, None]).astype(np.float32)
        out.append((toks, np.roll(toks, -1, axis=1), kw.get("lmask")))
    return out


def _image_batches(seed, n, rows):
    rng = np.random.default_rng(seed)
    return [(rng.random((rows, 32, 32, 3), dtype=np.float32),
             np.eye(10, dtype=np.float32)[rng.integers(0, 10, rows)], None)
            for _ in range(n)]


def _lm_case(name, kind, masked=False, updater="sgd", cfg=LM_CFG, **kw):
    if updater == "nesterovs":
        kw["momentum"] = 0.9
    return dict(name=name, kind=kind, model="lm", cfg=cfg, updater=updater,
                lr=0.1, batches=_lm_batches(3, masked, cfg), **kw)


def _mlp_case(name, kind, rows=B, **kw):
    rng = np.random.default_rng(0)
    batches = []
    for _ in range(STEPS):
        x = rng.normal(size=(rows, 4)).astype(np.float32)
        y = np.eye(2, dtype=np.float32)[(x.sum(axis=1) > 0).astype(int)]
        batches.append((x, y, None))
    return dict(name=name, kind=kind, model="mlp", updater="sgd", lr=0.1,
                batches=batches, **kw)


def _resnet_case(name, kind, rows=8, **kw):
    return dict(name=name, kind=kind, model="resnet", updater="nesterovs",
                lr=1e-3, momentum=0.9, batches=_image_batches(5, STEPS, rows),
                **kw)


CASES = {
    2: [_lm_case("lm_mono", "dp"),
        _lm_case("lm_mono_masked", "dp", masked=True),
        _lm_case("lm_overlap_4k", "dp", masked=True, overlap=BUCKETS[0]),
        _lm_case("lm_overlap_1g", "dp", overlap=BUCKETS[1]),
        _lm_case("lm_pa_k1", "pa", k=1, updater="nesterovs"),
        _lm_case("lm_pa_k2", "pa", k=2, updater="nesterovs"),
        dict(_lm_case("lm_dropout", "dp", cfg=DROP_CFG),
             batches=_lm_batches(4, False, DROP_CFG, rows=4)),
        _mlp_case("mlp_mono", "dp"),
        _mlp_case("mlp_lbfgs", "solver", algo="lbfgs",
                  mesh={"data": 2}, axes={"data": "data"}),
        _mlp_case("mlp_cg", "solver", algo="conjugate_gradient",
                  mesh={"data": 2}, axes={"data": "data"}),
        _mlp_case("mlp_lbfgs_m2", "solver", algo="lbfgs", mesh={"model": 2},
                  axes={"model": "model"}, tp_rules=SOLVER_TP_RULES),
        _mlp_case("mlp_lbfgs_z1", "solver", algo="lbfgs", mesh={"data": 2},
                  zero1=True),
        _mlp_case("mlp_pa_k1", "pa", k=1),
        _mlp_case("mlp_pa_odd", "pa", rows=B + 1, k=1),
        _resnet_case("resnet_mono", "dp"),
        dict(_resnet_case("resnet_eval", "eval", rows=2),
             eval=_image_batches(7, 1, 6)[0][:2])],
    4: [_lm_case("lm_mono_masked", "dp", masked=True),
        _lm_case("lm_overlap_4k", "dp", overlap=BUCKETS[0]),
        _lm_case("lm_pa_k2", "pa", k=2, updater="nesterovs")],
}


@pytest.fixture(scope="module")
def fleets(tmp_path_factory):
    """{n: [rank outputs]} for the 2- and 4-rank fleets."""
    return {n: run_fleet(tmp_path_factory.mktemp(f"fleet{n}"), n, cases)
            for n, cases in CASES.items()}


def _case(n, name):
    return next(c for c in CASES[n] if c["name"] == name)


def _jax_batches(case):
    return [JDataSet(x, y, labels_mask=m) for x, y, m in case["batches"]]


def _jax_trained(case, n):
    """The JAX package's net after the case's steps on n devices."""
    net = _jax_net(case)
    mesh = jax_make_mesh({"data": n})
    if case["kind"] == "pa":
        jdp.ParameterAveragingTrainer(
            net, mesh, averaging_frequency=case["k"]).fit(
                JListIt(_jax_batches(case)))
        return net
    trainer = jdp.DataParallelTrainer(net, mesh, overlap=case.get("overlap"))
    for ds in _jax_batches(case):
        trainer.fit(ds)
    return net


@pytest.mark.parametrize("n,name", [(2, "lm_mono"), (2, "lm_mono_masked"),
                                    (4, "lm_mono_masked"), (2, "mlp_mono")])
def test_monolithic_arm_matches_jax(fleets, n, name):
    """DataParallelTrainer, monolithic: the one-device step on the
    global batch, the masked loss divided by the GLOBAL mask count
    (every rank's rows carry a different share of it); a graph and a
    MultiLayerNetwork."""
    case = _case(n, name)
    _assert_trained_close(fleets[n], name, _jax_trained(case, n), LM_TOL)


def test_monolithic_dropout_equals_one_device(fleets):
    """With dropout 0.1 on the input, the FF and the attention weights
    (the packed flash route at T = 512, its keep mask in the kernel's
    plain version), the monolithic arm on 2 ranks equals the port's one
    device over the global batch: each rank draws the global batch's
    input masks and keeps its rows, and its flash seed folds its b*H + h
    offset. (JAX's draws cannot be matched: another RNG.)"""
    from deeplearning4j_tpu_torch.datasets import DataSet
    from deeplearning4j_tpu_torch.weights_io import (
        params_from_jax,
        params_to_numpy,
    )

    case = _case(2, "lm_dropout")
    jnet = _jax_net(case)
    net = set_updater(torch_lm(**DROP_CFG, device="cpu"), case).init()
    net.params = {**{k: {} for k in net.params}, **params_from_jax(
        jax.tree.map(np.asarray, jnet.params), "cpu")}
    net.opt_state = net.tx.init(net.params)
    for x, y, _ in case["batches"]:
        net.fit(DataSet(x, y))
    ref = _flatten(params_to_numpy(net.params))
    scale = max(float(np.abs(a).max()) for a in ref.values())
    moved = max(float(np.abs(ref[k] - fleets[2][0][f"lm_dropout/params/{k}"]
                             ).max()) for k in ref)
    assert moved <= LM_TOL * scale, moved
    np.testing.assert_allclose(float(fleets[2][0]["lm_dropout/score"]),
                               net.score_value, rtol=1e-5)


def test_resnet20_global_batch_norm_matches_jax(fleets):
    """ResNet-20 at batch 8 on 2 ranks: the batch norms normalize by the
    statistics of all 8 rows (summed over the ranks in the forward), as
    the JAX package's GSPMD step does; params and running statistics
    after three Nesterov steps."""
    case = _case(2, "resnet_mono")
    _assert_trained_close(fleets[2], "resnet_mono", _jax_trained(case, 2),
                          RESNET_TOL)


@pytest.mark.parametrize("n,name", [(2, "lm_overlap_4k"),
                                    (2, "lm_overlap_1g"),
                                    (4, "lm_overlap_4k")])
def test_overlap_arm_matches_jax(fleets, n, name):
    """DataParallelTrainer(overlap=bucket bytes): the per-shard step
    (local loss, the masked one normalized per shard) with the
    gradients mean-reduced bucket by bucket, at a bucket size that cuts
    the LM into many buckets and at one that takes it whole."""
    case = _case(n, name)
    jnet = _jax_trained(case, n)
    _assert_trained_close(fleets[n], name, jnet, LM_TOL)
    want = len(jnet._overlap_plan.buckets)
    assert int(fleets[n][0][f"{name}/n_buckets"]) == want
    assert (want > 1) == (case["overlap"] == BUCKETS[0])


@pytest.mark.parametrize("n,name", [(2, "lm_pa_k1"), (2, "lm_pa_k2"),
                                    (4, "lm_pa_k2"), (2, "mlp_pa_k1"),
                                    (2, "mlp_pa_odd")])
def test_parameter_averaging_matches_jax(fleets, n, name):
    """ParameterAveragingTrainer at k = 1 and k = 2 with Nesterov
    momentum: local steps on each replica's rows, then the params and
    the momentum averaged; the net keeps replica 0's. A batch of 9 rows
    over 2 replicas drops its last row, as the JAX trainer does."""
    case = _case(n, name)
    _assert_trained_close(fleets[n], name, _jax_trained(case, n), LM_TOL)


@pytest.mark.parametrize("name", ["mlp_lbfgs", "mlp_cg", "mlp_lbfgs_m2",
                                  "mlp_lbfgs_z1"])
def test_solver_under_a_mesh_matches_the_meshless_solve(fleets, name):
    """fit() through the Solver path (3 iterations a batch, three
    batches) under {"data": 2} (LBFGS and CG: each rank's rows, the loss
    and gradient means over "data"; LBFGS with ZeRO-1 too), and under
    {"model": 2} with the head split on its classes (LBFGS: the inner
    products sum the split leaves over "model"): every rank's params
    equal, within 1e-5 of the largest entry (X_ATOL of
    tests/test_torch_solvers.py) of the JAX package's solve under the
    same mesh, roles, rules and ZeRO-1, and within 1e-5 of the meshless
    port's solve on the global batches; the score within 1e-5 relative
    (SCORE_RTOL) of both. (The 2-rank gloo fleet, launch deadline 120 s.)"""
    from deeplearning4j_tpu.nn import conf as jconf
    from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as JNet
    from deeplearning4j_tpu_torch.datasets import DataSet
    from deeplearning4j_tpu_torch.nn import conf as tconf
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
    from deeplearning4j_tpu_torch.weights_io import (
        params_from_jax,
        params_to_numpy,
    )

    case = _case(2, name)
    jnet = set_updater(JNet(mlp_conf(jconf)), case)
    tnet = set_updater(MultiLayerNetwork(mlp_conf(tconf), device="cpu"),
                       case)
    for net in (jnet, tnet):
        net.conf.conf.optimization_algo = case["algo"]
        net.conf.conf.iterations = 3
    jnet.init()
    tnet.init()
    tnet.params = params_from_jax(jax.tree.map(np.asarray, jnet.params),
                                  "cpu")
    jnet.set_mesh(jax_make_mesh(case["mesh"]), axes=case.get("axes"),
                  tp_rules=case.get("tp_rules"),
                  zero1=case.get("zero1", False))
    for x, y, _ in case["batches"]:
        jnet.fit(JDataSet(x, y))
        tnet.fit(DataSet(x, y))
    ref = _flatten(jax.tree.map(np.asarray, jnet.params))
    want = _flatten(params_to_numpy(tnet))
    scale = max(float(np.abs(a).max()) for a in ref.values())
    outs = fleets[2]
    assert int(outs[0][f"{name}/n_split"]) == (2 if "m2" in name else 0)
    for key, v in want.items():
        got = outs[0][f"{name}/params/{key}"]
        for other in outs[1:]:
            np.testing.assert_array_equal(other[f"{name}/params/{key}"],
                                          got)
        np.testing.assert_allclose(got, ref[key], rtol=0,
                                   atol=X_ATOL * scale, err_msg=key)
        np.testing.assert_allclose(got, v, rtol=0, atol=1e-5, err_msg=key)
    for score in (tnet.score_value, float(jnet.score_value)):
        np.testing.assert_allclose(float(outs[0][f"{name}/score"]), score,
                                   rtol=SCORE_RTOL)
    assert int(outs[0][f"{name}/iterations"]) == tnet.iteration_count


def test_evaluation_under_data_mesh_matches_single_device(fleets):
    """output() and evaluate() under a 2-rank data mesh: each rank runs
    its rows and the outputs are gathered (an indivisible batch padded
    and sliced back); equal to the JAX net's single-device output."""
    case = _case(2, "resnet_eval")
    jnet = _jax_net(case)
    x, y = case["eval"]
    ref = np.asarray(jnet.output(x))
    for out in fleets[2]:
        for key, want in (("mesh_out", ref), ("local_out", ref),
                          ("mesh_out_odd", ref[:-1])):
            got = out[f"resnet_eval/{key}"]
            assert got.shape == want.shape
            np.testing.assert_allclose(got, want, rtol=0, atol=2e-5 * float(
                np.abs(want).max()))
        np.testing.assert_array_equal(
            out["resnet_eval/mesh_cm"],
            jnet.evaluate(JDataSet(x, y)).confusion.matrix)


@pytest.mark.parametrize("bucket_bytes", [4096, 65536, 4 << 20])
def test_bucket_plan_summary_equals_jax(bucket_bytes):
    """plan_buckets over the LM's params in its layer order: the same
    buckets (count, leaves, bytes, reverse layer order, keystr paths) as
    the JAX plan of the JAX net's params."""
    jnet = jax_lm(**LM_CFG).init()
    tnet = torch_lm(**LM_CFG, device="cpu").init()
    order = list(jnet.layer_vertices)
    jp = jax_plan(jnet.params, bucket_bytes, layer_order=order)
    tp = plan_buckets(tnet.params, bucket_bytes, layer_order=order)
    assert tp.summary() == jp.summary()
    assert tp.leaf_paths() == jp.leaf_paths()


@pytest.fixture
def world1():
    """A gloo process group of one in this process, torn down after."""
    from deeplearning4j_tpu_torch.distributed import bootstrap
    from deeplearning4j_tpu_torch.parallel.mesh import make_mesh

    mesh = make_mesh({"data": 1}, device="cpu")
    try:
        yield mesh
    finally:
        bootstrap.shutdown()


def test_set_mesh_validation_errors(world1):
    """set_mesh's ValueErrors, as the JAX package raises them; set_mesh
    of a net returns the net, set_mesh(None) clears it."""
    from deeplearning4j_tpu_torch.models.resnet import resnet20
    from deeplearning4j_tpu_torch.parallel.mesh import make_mesh

    net = torch_lm(**LM_CFG, device="cpu").init()
    with pytest.raises(ValueError, match="unknown mesh roles"):
        net.set_mesh(world1, axes={"batch": "data"})
    with pytest.raises(ValueError, match="is not a mesh axis"):
        net.set_mesh(world1, axes={"data": "rows"})
    with pytest.raises(ValueError, match="sequence-parallel-ready conf"):
        net.set_mesh(make_mesh({"seq": 1}, device="cpu"), axes={"seq": "seq"})
    sp = torch_lm(**LM_CFG, seq_parallel_axis="tokens", device="cpu").init()
    with pytest.raises(ValueError, match="is built for seq axis"):
        sp.set_mesh(make_mesh({"seq": 1}, device="cpu"), axes={"seq": "seq"})
    with pytest.raises(ValueError, match="overlap composes with the 'data'"):
        net.set_mesh(make_mesh({"data": 1, "seq": 1}, device="cpu"),
                     axes={"data": "data", "seq": "seq"}, overlap=True)
    with pytest.raises(ValueError, match="overlap=... requires a mesh"):
        net.set_mesh(None, overlap=True)
    with pytest.raises(ValueError, match="requires the ComputationGraph"):
        from deeplearning4j_tpu_torch.models.lenet import lenet5

        lenet5(device="cpu").init().set_mesh(
            make_mesh({"seq": 1}, device="cpu"), axes={"seq": "seq"})
    with pytest.raises(ValueError, match="mesh needs a 'data' axis"):
        from deeplearning4j_tpu_torch.parallel import DataParallelTrainer

        DataParallelTrainer(net, make_mesh({"seq": 1}, device="cpu"))
    assert net._mesh is None
    assert net.set_mesh(world1) is net and net._mesh is world1
    assert net.set_mesh(None) is net and net._mesh is None
    cnn = resnet20(device="cpu").init()
    assert cnn.set_mesh(world1, axes={"data": "data"}) is cnn


@pytest.mark.parametrize("kwargs", [
    dict(axes={"seq": "seq", "pipe": "pipe"}),
    dict(axes={"seq": "seq", "pipe": "pipe"}, n_microbatches=4),
    dict(axes={"seq": "seq", "model": "model"}),
])
def test_unported_roles_raise_citing_a7(world1, kwargs):
    """Sequence parallelism composes with the "pipe" and the "model"
    role (the rest of A7, once refused): the net is placed (its pipeline
    runs the seq axis, or its split layers run the SP step) and one
    step moves its params. (The multi-rank parity is in
    tests/test_torch_sequence_parallel.py and test_torch_pipeline.py.)"""
    from deeplearning4j_tpu_torch.datasets import DataSet
    from deeplearning4j_tpu_torch.parallel.mesh import make_mesh

    net = torch_lm(**LM_CFG, seq_parallel_axis="seq", device="cpu").init()
    mesh = make_mesh({"data": 1, "seq": 1, "model": 1, "pipe": 1},
                     device="cpu")
    assert net.set_mesh(mesh, **kwargs) is net and net._mesh is mesh
    if "pipe" in kwargs["axes"]:
        assert net._pipe.seq_axis == "seq"
        assert net._pipe.n_microbatches == kwargs.get("n_microbatches", 2)
    else:
        assert net._split_plan.layers
    x, y, _ = _lm_batches(9, False)[0]
    before = net.params_flat()
    net.fit(DataSet(x, y))
    assert np.isfinite(net.score_value)
    assert not np.array_equal(before, net.params_flat())


def test_placement_and_sparse_buckets_raise_citing_a7(world1):
    """A reshard.Placement (placement search's winner) of "seq" with
    "pipe" places the net as set_mesh with those roles does: a pipeline
    over the seq axis, which takes a step. The embedding engine's
    sparse gradient buckets (tests/test_torch_embedding_sharded.py)
    raise only what the JAX package's raise, a bad plan or a pair of
    the wrong shape."""
    import torch

    from deeplearning4j_tpu_torch.datasets import DataSet
    from deeplearning4j_tpu_torch.parallel import overlap
    from deeplearning4j_tpu_torch.reshard import Placement

    net = torch_lm(**LM_CFG, seq_parallel_axis="seq", device="cpu").init()
    net.set_mesh(Placement.of({"seq": 1, "pipe": 1},
                              {"seq": "seq", "pipe": "pipe"}))
    assert net._mesh_axes == {"seq": "seq", "pipe": "pipe"}
    assert net._pipe.seq_axis == "seq" and net._pipe.S == 1
    x, y, _ = _lm_batches(9, False)[0]
    net.fit(DataSet(x, y))
    assert np.isfinite(net.score_value)
    with pytest.raises(ValueError, match="positive n_rows/dim"):
        overlap.plan_sparse_bucket("emb", 0, 8)
    plan = overlap.plan_sparse_bucket("emb", 4, 8)
    with pytest.raises(ValueError, match="plan 'emb' is for"):
        overlap.sparse_bucket_reduce([torch.zeros(5, dtype=torch.long)],
                                     [torch.zeros(5, 8)], bucket=plan)


def test_bucketed_reduce_of_one_rank_is_the_identity(world1):
    """bucketed_reduce (the after-the-backward form) over a rank of one:
    every bucket flattened, reduced and cut back to the leaves' shapes
    and dtypes, equal to the input; a plan of another tree is refused."""
    from deeplearning4j_tpu_torch.nn import tree
    from deeplearning4j_tpu_torch.parallel.overlap import bucketed_reduce

    net = torch_lm(**LM_CFG, device="cpu").init()
    grads = tree.tree_map(lambda t: torch.randn_like(t), net.params)
    plan = plan_buckets(grads, 4096, layer_order=list(net.layer_vertices))
    out = bucketed_reduce(grads, plan, world1.group("data"), 1)
    for path, g in tree.leaves(grads):
        torch.testing.assert_close(tree.get(out, path), g, rtol=0, atol=0)
    with pytest.raises(ValueError, match="does not cover"):
        bucketed_reduce({"x": {"W": torch.ones(2)}}, plan,
                        world1.group("data"), 1)


def test_world_of_one_mesh_step_is_the_meshless_step(world1):
    """At one rank the monolithic arm's all-reduce is a copy and a
    division by 1: two steps leave the params bit for bit where the
    meshless net's two steps leave them (one intra-op thread: the CPU's
    threaded reductions do not repeat bit for bit)."""
    from deeplearning4j_tpu_torch.datasets import DataSet
    from deeplearning4j_tpu_torch.parallel import DataParallelTrainer

    (x, y, _), (x2, y2, _) = _lm_batches(9, False)[:2]
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        plain = torch_lm(**LM_CFG, dropout=0.1, device="cpu").init(4)
        dp = torch_lm(**LM_CFG, dropout=0.1, device="cpu").init(4)
        trainer = DataParallelTrainer(dp, world1)
        for xb, yb in ((x, y), (x2, y2)):
            plain.fit(DataSet(xb, yb))
            trainer.fit(DataSet(xb, yb))
    finally:
        torch.set_num_threads(threads)
    assert plain.params_flat().tobytes() == dp.params_flat().tobytes()
    assert plain.score_value == dp.score_value
