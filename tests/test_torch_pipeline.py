"""Pipeline parallelism of the port (parallel/pipeline.py, the "pipe"
role of set_mesh) against the JAX package on the CPU.

In this process: the stage partition against JAX `PipelinePlan` (the
transformer LM of the JAX package's tests/test_unified_mesh.py at 4
blocks, S = 2 and 4, and a graph whose blocks hold a Merge vertex), the
pipelined layout both ways, the refusals with the JAX package's error
texts, and at one rank "pipe" 1 with M = 1 bit for bit with the
meshless step and M = 4 within f32 rounding of it (SGD: 1e-6 of the
largest param).

On gloo fleets of 2 and 4 ranks (tests/torch_parallel_worker.py): that
LM (V 64, d 16, 2 heads, 4 blocks, d_ff 32, T 8, B 8; dropout 0, so
the draws of the two packages never matter) trained 3 steps from the
JAX net's params under {"pipe": 2} with the model's Adam (also with
features and labels masks, and through fit_scanned), {"data": 2,
"pipe": 2} and {"model": 2, "pipe": 2}: every step's loss and the
canonical params within 5e-4 of the JAX net trained meshless, the
tolerance of the JAX package's own PP-against-dense test
(test_unified_mesh.py `test_pp_via_set_mesh_matches_dense`). Where the
pipelined step is not the meshless one — batch norm's statistics per
microbatch, LAMB's trust ratio over a stacked [S] leaf, the MoE aux
loss per microbatch — the port is held to the JAX package's pipelined
net on a CPU mesh of as many devices, within the same 5e-4: the batch-
norm stack of `test_pp_batchnorm_stack_trains` under {"pipe": 2},
LAMB under {"pipe": 2} (which also differs from the meshless LAMB net
by more than that: the norms really sum over "pipe"), and the MoE LM of
`test_pp_ep_moe_matches_dense` under {"expert": 2, "pipe": 2}. The
in-process transport of 2 stages gives the 2-rank fleet's params,
optimizer state and losses bit for bit. `weights_io` carries a JAX net
placed on {"pipe": 2} into the port through its canonical params.
"""

import numpy as np
import pytest
import torch

from deeplearning4j_tpu.datasets.api import DataSet as JDataSet
from deeplearning4j_tpu.parallel.mesh import make_mesh as jax_make_mesh
from fleet_util import jax_net, run_fleet
from torch_parallel_worker import flatten

pytestmark = pytest.mark.port

TOL = 5e-4
CFG = dict(vocab_size=64, d_model=16, n_heads=2, n_layers=4, d_ff=32,
           max_length=8)
MOE = dict(vocab_size=64, d_model=16, n_heads=2, n_layers=4, n_experts=4,
           top_k=2, d_expert_hidden=24, max_length=8, capacity_factor=2.0)
B, STEPS = 8, 3


# "pipe" 2 x "seq" 2: T 256, so each rank's block of 128 takes the ring's
# flash hops inside its stage
SEQ_CFG = dict(CFG, max_length=256)


def _batches(seed=0, masked=False, cfg=CFG, features_mask=True):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(STEPS):
        x = rng.integers(0, cfg["vocab_size"], (B, cfg["max_length"]))
        x = x.astype(np.int32)
        m = None
        if masked:
            m = (rng.random(x.shape) < 0.8).astype(np.float32)
            m[:, 0] = 1.0
        out.append((x, np.roll(x, -1, axis=1), m)
                   + ((m,) if features_mask else ()))
    return out


def _bn_batches(seed=0):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(STEPS):
        x = rng.standard_normal((16, 16)).astype(np.float32) * 2 + 1
        y = np.eye(3, dtype=np.float32)[rng.integers(0, 3, 16)]
        out.append((x, y, None))
    return out


def _case(name, mesh, M, **kw):
    axes = {a: a for a in mesh}
    case = dict(name=name, kind="pipe", model="lm", cfg=CFG, mesh=mesh,
                axes=axes, M=M, batches=_batches())
    case.update(kw)
    return case


_EVAL = _batches(9)[0][:2]
CASES = {
    2: [_case("pp2", {"pipe": 2}, 4, inproc=True, eval=_EVAL),
        _case("pp2_mask", {"pipe": 2}, 4, batches=_batches(masked=True)),
        _case("pp2_scanned", {"pipe": 2}, 4, scanned=True),
        _case("pp2_bn", {"pipe": 2}, 4, model="bn", cfg={},
              batches=_bn_batches()),
        _case("pp2_lamb", {"pipe": 2}, 4, updater="lamb", lr=0.01,
              inproc=True)],
    4: [_case("pp_d2p2", {"data": 2, "pipe": 2}, 2),
        _case("pp_m2p2", {"model": 2, "pipe": 2}, 4),
        _case("pp_p2s2", {"pipe": 2, "seq": 2}, 2, cfg=SEQ_CFG,
              sp_axis="seq", batches=_batches(cfg=SEQ_CFG), odd_T=True),
        _case("pp_p2s2_mask", {"pipe": 2, "seq": 2}, 2, cfg=SEQ_CFG,
              sp_axis="seq", batches=_batches(masked=True, cfg=SEQ_CFG,
                                              features_mask=False)),
        _case("pp_e2p2", {"expert": 2, "pipe": 2}, 2, model="moe",
              cfg=MOE)],
}


@pytest.fixture(scope="module")
def fleets(tmp_path_factory):
    return {n: run_fleet(tmp_path_factory.mktemp(f"pp{n}"), n, cases)
            for n, cases in CASES.items()}


def _case_of(name):
    return next(c for cs in CASES.values() for c in cs if c["name"] == name)


def _jax_ds(b):
    x, y, m, *fm = b
    fm = fm[0] if fm else None
    return JDataSet(x, y, features_mask=fm, labels_mask=m)


def _jax_trained(case, pipelined=False):
    """The case's JAX net trained on its batches, meshless or (the
    pipelined reference) on a CPU mesh of the case's shape; the loss of
    every step."""
    net = jax_net(case)
    if pipelined:
        net.set_mesh(jax_make_mesh(case["mesh"]), axes=case["axes"],
                     n_microbatches=case["M"])
    losses = []
    for b in case["batches"]:
        net.fit(_jax_ds(b))
        losses.append(float(net.score_value))
    params = (net._canonical_params() if pipelined else net.params)
    return flatten(params), np.asarray(losses), net


def _assert_close(outs, name, ref, ref_losses, tol=TOL):
    for out in outs:
        got = out[f"{name}/losses"]
        np.testing.assert_allclose(got, ref_losses, rtol=0, atol=tol,
                                   err_msg=name)
        for key, want in ref.items():
            err = float(np.abs(out[f"{name}/params/{key}"]
                               - np.asarray(want)).max())
            assert err <= tol, (name, key, err)


# ------------------------------------------------------------ gloo fleets

@pytest.mark.parametrize("n,name", [(2, "pp2"), (2, "pp2_mask"),
                                    (2, "pp2_scanned"), (4, "pp_d2p2"),
                                    (4, "pp_m2p2"), (4, "pp_p2s2"),
                                    (4, "pp_p2s2_mask")])
def test_pipelined_fit_matches_jax_meshless(fleets, n, name):
    """Three Adam steps pipelined over 2 stages (with "data", "model" or
    "seq" at 4 ranks — "seq": the ring over each stage's seq group, the
    JAX package's test_seq_pipe_via_set_mesh_matches_dense and, with a
    labels mask whose valid count differs from block to block,
    test_seq_pipe_masked_loss_matches_dense at M = 2; masked; through
    fit_scanned): every step's loss and the canonical params on every
    rank within 5e-4 of the JAX net trained meshless; each rank holds
    PRE, POST and only its own stage's blocks. (Gloo fleets of 2 and 4
    ranks, launch deadline 120 s each.)"""
    case = _case_of(name)
    ref, losses, _ = _jax_trained(case)
    _assert_close(fleets[n], name, ref, losses)
    stages = [{f"blk{b}_attn" for b in range(2)},
              {f"blk{b}_attn" for b in range(2, 4)}]
    for out in fleets[n]:
        held = set(out[f"{name}/held"].tolist())
        assert {"embed", "posenc", "ln_f", "out"} <= held
        assert sum(s <= held for s in stages) == 1
        assert not (stages[0] | stages[1]) <= held


@pytest.mark.parametrize("n,name", [(2, "pp2_bn"), (2, "pp2_lamb"),
                                    (4, "pp_e2p2")])
def test_pipelined_fit_matches_jax_pipelined(fleets, n, name):
    """Where the pipelined step is not the meshless one (batch norm per
    microbatch, LAMB's norm over the stacked [S] leaf, the MoE aux loss
    per microbatch): within 5e-4 of the JAX package's pipelined net of
    the same stages and microbatches; the batch-norm state moved and
    equals the JAX net's; LAMB's norm summed over "pipe" matters (the
    meshless LAMB net is more than 5e-4 away)."""
    case = _case_of(name)
    ref, losses, jnet = _jax_trained(case, pipelined=True)
    _assert_close(fleets[n], name, ref, losses)
    if name == "pp2_bn":
        for key, want in flatten(jnet.state).items():
            for out in fleets[n]:
                np.testing.assert_allclose(out[f"{name}/state/{key}"],
                                           np.asarray(want), rtol=0,
                                           atol=TOL, err_msg=key)
        mean = fleets[n][0][f"{name}/state/blk0_bn/mean"]
        assert not np.allclose(mean, 0.0)
    if name == "pp2_lamb":
        dense, _, _ = _jax_trained(case)
        gap = max(float(np.abs(fleets[n][0][f"{name}/params/{k}"]
                               - np.asarray(v)).max())
                  for k, v in dense.items())
        assert gap > TOL


def test_seq_pipe_refuses_a_length_the_seq_axis_does_not_divide(fleets):
    """Under {"pipe": 2, "seq": 2} a batch of T = 255 raises the JAX
    package's ValueError, word for word, on every rank. (The 4-rank gloo
    fleet, launch deadline 120 s.)"""
    for out in fleets[4]:
        assert str(out["pp_p2s2/odd_T_error"]) == (
            "sequence length 255 not divisible over the 2-way seq axis")


def test_in_process_transport_equals_the_process_group(fleets):
    """The in-process pipeline of 2 stages (Adam, and LAMB with its norm
    over the stages' leaves) leaves the params, the optimizer state and
    every loss of the 2-rank fleet bit for bit."""
    for name in ("pp2", "pp2_lamb"):
        assert bool(fleets[2][0][f"{name}/inproc_same"]), name


def test_pipelined_output_and_score_match_jax(fleets):
    """output() and score() of the pipelined net (the other stage's
    params gathered) match the JAX meshless net's after the same
    steps, within the fit's 5e-4; every rank gives the same."""
    case = _case_of("pp2")
    jnet = jax_net(case)
    for b in case["batches"]:
        jnet.fit(_jax_ds(b))
    x, y = case["eval"]
    want = np.asarray(jnet.output(x))
    for out in fleets[2]:
        np.testing.assert_allclose(out["pp2/output"], want, rtol=0,
                                   atol=TOL)
        np.testing.assert_allclose(float(out["pp2/eval_score"]),
                                   float(jnet.score(JDataSet(x, y))),
                                   rtol=0, atol=TOL)


# ------------------------------------------------------------ in process

def _nets(**cfg):
    from deeplearning4j_tpu.models.transformer import transformer_lm as jlm
    from deeplearning4j_tpu_torch.models.transformer import transformer_lm
    from deeplearning4j_tpu_torch.weights_io import params_from_jax

    jnet = jlm(**cfg).init()
    net = transformer_lm(**cfg, device="cpu").init()
    net.params = params_from_jax(
        {k: {n: np.asarray(v) for n, v in d.items()}
         for k, d in jnet.params.items()}, "cpu")
    return jnet, net


def _merge_graph(conf_mod, graph_cls, **kw):
    """Four blocks of two dense branches merged and projected back, from
    either package's conf module."""
    g = (conf_mod.NeuralNetConfiguration.builder().seed(3)
         .learning_rate(0.1).updater("sgd").graph_builder())
    g.add_inputs("in")
    src = "in"
    for b in range(4):
        g.add_layer(f"b{b}_l", conf_mod.DenseLayer(n_in=8, n_out=4,
                                                   activation="tanh"), src)
        g.add_layer(f"b{b}_r", conf_mod.DenseLayer(n_in=8, n_out=4,
                                                   activation="relu"), src)
        g.add_vertex(f"b{b}_m", conf_mod.MergeVertexConf(), f"b{b}_l",
                     f"b{b}_r")
        g.add_layer(f"b{b}_p", conf_mod.DenseLayer(n_in=8, n_out=8,
                                                   activation="identity"),
                    f"b{b}_m")
        src = f"b{b}_p"
    g.add_layer("out", conf_mod.OutputLayer(n_in=8, n_out=3,
                                            activation="softmax"), src)
    g.set_outputs("out")
    return graph_cls(g.build(), **kw).init()


def _merge_nets():
    from deeplearning4j_tpu.nn import conf as jconf
    from deeplearning4j_tpu.nn.conf.graph_conf import (
        MergeVertexConf as JMerge,
    )
    from deeplearning4j_tpu.nn.graph import ComputationGraph as JGraph
    from deeplearning4j_tpu_torch.nn import conf as tconf
    from deeplearning4j_tpu_torch.nn.conf.graph_conf import MergeVertexConf
    from deeplearning4j_tpu_torch.nn.graph import ComputationGraph

    jconf.MergeVertexConf, tconf.MergeVertexConf = JMerge, MergeVertexConf
    return (_merge_graph(jconf, JGraph),
            _merge_graph(tconf, ComputationGraph, device="cpu"))


@pytest.mark.parametrize("model,S", [("lm", 2), ("lm", 4), ("merge", 2),
                                     ("merge", 4)])
def test_partition_equals_jax_plan(model, S):
    """The port's plan on the same conf has the JAX plan's PRE and POST
    layers and per-stage groups, in the same (topological) order."""
    from deeplearning4j_tpu.parallel.pipeline import PipelinePlan as JPlan
    from deeplearning4j_tpu_torch.parallel.pipeline import PipelinePlan

    jnet, net = _nets(**CFG) if model == "lm" else _merge_nets()
    jp, tp = JPlan(jnet, S), PipelinePlan(net, S)
    assert tp.pre_layers == jp.pre_layers
    assert tp.post_layers == jp.post_layers
    assert tp.group_layers == jp.group_layers
    assert tp.stage_groups == jp.stage_groups
    assert (tp.body_ext, tp.post_ext, tp.loss_ext) == (
        jp.body_ext, jp.post_ext, jp.loss_ext)


def test_pipelined_layout_both_ways_equals_jax():
    """to_pipelined stacks each stage leaf on a leading [S] axis as the
    JAX plan does, pre and post as they are; to_canonical inverts it."""
    from deeplearning4j_tpu.parallel.pipeline import PipelinePlan as JPlan
    from deeplearning4j_tpu_torch.nn import tree
    from deeplearning4j_tpu_torch.parallel.pipeline import PipelinePlan

    jnet, net = _nets(**CFG)
    jpp = JPlan(jnet, 2).to_pipelined(jnet.params)
    plan = PipelinePlan(net, 2)
    pp = plan.to_pipelined(net.params)
    assert len(pp["stages"]) == len(jpp["stages"])
    for a, b in zip(pp["stages"], jpp["stages"]):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    for region in ("pre", "post"):
        assert sorted(pp[region]) == sorted(jpp[region])
    back = plan.to_canonical(pp)
    for path, t in tree.leaves(net.params):
        assert torch.equal(tree.get(back, path), t)


def _refusal(build, S=2):
    """The error of pipelining `build()`'s net over S stages in each
    package: (JAX's, the port's)."""
    from deeplearning4j_tpu.parallel.pipeline import (
        PipelinePlan as JPlan,
        check_pp_supported as jcheck,
    )
    from deeplearning4j_tpu_torch.parallel.pipeline import (
        PipelinePlan,
        check_pp_supported,
    )

    out = []
    for net, plan, check in zip(build(), (JPlan, PipelinePlan),
                                (jcheck, check_pp_supported)):
        with pytest.raises(ValueError) as e:
            check(net)
            plan(net, S)
        out.append(str(e.value))
    return out


def _lm_pair(tweak=None, **cfg):
    from deeplearning4j_tpu.models.transformer import transformer_lm as jlm
    from deeplearning4j_tpu_torch.models.transformer import transformer_lm

    nets = (jlm(**CFG, **cfg), transformer_lm(**CFG, **cfg, device="cpu"))
    for net in nets:
        if tweak:
            tweak(net)
        net.init()
    return nets


def _per_layer_updater(net):
    net.layer_vertices["blk0_ff1"].layer.updater = "nesterovs"


def _solver(net):
    net.conf.conf.optimization_algo = "lbfgs"


def _tbptt(net):
    net.conf.backprop_type = "truncated_bptt"


def _vgg():
    from deeplearning4j_tpu.models.vgg import vgg16 as jvgg
    from deeplearning4j_tpu_torch.models.vgg import vgg16

    return jvgg(num_classes=10).init(), vgg16(num_classes=10,
                                              device="cpu").init()


@pytest.mark.parametrize("what", ["stages", "conv", "tbptt", "solver",
                                  "updater"])
def test_refusals_carry_the_jax_texts(what):
    """S = 3 over 4 blocks, a VGG conv stack, TBPTT, a second-order
    solver and a per-layer updater raise the JAX package's ValueError,
    word for word."""
    if what == "stages":
        jax_msg, msg = _refusal(_lm_pair, S=3)
        assert "do not divide" in msg
    elif what == "conv":
        jax_msg, msg = _refusal(_vgg)
        assert "IDENTICAL" in msg and "data axis" in msg
    else:
        tweak = {"tbptt": _tbptt, "solver": _solver,
                 "updater": _per_layer_updater}[what]
        jax_msg, msg = _refusal(lambda: _lm_pair(tweak))
    assert msg == jax_msg


def test_multilayer_network_and_seq_refused():
    """"pipe" on a MultiLayerNetwork raises the JAX package's ValueError
    naming the graph container; "seq" with "pipe" places the graph (its
    pipeline runs the seq axis) and takes a step."""
    from deeplearning4j_tpu_torch.datasets import DataSet
    from deeplearning4j_tpu_torch.distributed import bootstrap
    from deeplearning4j_tpu_torch.models.lenet import lenet5
    from deeplearning4j_tpu_torch.models.transformer import transformer_lm
    from deeplearning4j_tpu_torch.parallel.mesh import make_mesh

    bootstrap.initialize(device="cpu")
    try:
        mesh = make_mesh({"pipe": 1, "seq": 1}, device="cpu")
        with pytest.raises(ValueError, match="requires the ComputationGraph"):
            lenet5(device="cpu").init().set_mesh(mesh, axes={"pipe": "pipe"})
        net = transformer_lm(**CFG, seq_parallel_axis="seq",
                             device="cpu").init()
        net.set_mesh(mesh, axes={"pipe": "pipe", "seq": "seq"})
        assert net._pipe is not None and net._pipe.seq_axis == "seq"
        x, y, _, _ = _batches(5)[0]
        before = net.params_flat()
        net.fit(DataSet(x, y))
        assert np.isfinite(net.score_value)
        assert not np.array_equal(before, net.params_flat())
    finally:
        bootstrap.shutdown()


def _sgd_lm():
    from deeplearning4j_tpu_torch.models.transformer import transformer_lm

    net = transformer_lm(**CFG, device="cpu")
    g = net.conf.conf
    g.updater, g.learning_rate = "sgd", 0.1
    for v in net.layer_vertices.values():
        v.layer.updater, v.layer.learning_rate = "sgd", None
    return net.init(5)


@pytest.mark.parametrize("M", [1, 4])
def test_one_rank_pipe_against_the_meshless_step(M):
    """At world size 1, "pipe" 1: with M = 1 three steps leave the params
    and every loss bit for bit where the meshless net's leave them (the
    same ops in the same order); with M = 4 within f32 rounding (1e-6 of
    the largest param, SGD). n_microbatches defaults to 2·S; set_mesh
    (None) gives the params back. One intra-op thread."""
    from deeplearning4j_tpu_torch.datasets import DataSet
    from deeplearning4j_tpu_torch.distributed import bootstrap
    from deeplearning4j_tpu_torch.nn import tree
    from deeplearning4j_tpu_torch.parallel.mesh import make_mesh

    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    bootstrap.initialize(device="cpu")
    try:
        mesh = make_mesh({"pipe": 1}, device="cpu")
        plain, piped = _sgd_lm(), _sgd_lm()
        piped.set_mesh(mesh, axes={"pipe": "pipe"})
        assert piped._pipe.n_microbatches == 2
        piped.set_mesh(mesh, axes={"pipe": "pipe"}, n_microbatches=M)
        for x, y, _, _ in _batches(3):
            plain.fit(DataSet(x, y))
            piped.fit(DataSet(x, y))
            if M == 1:
                assert piped.score_value == plain.score_value
        scale = max(float(t.abs().max()) for _, t in
                    tree.leaves(plain.params))
        for path, t in tree.leaves(plain.params):
            got = tree.get(piped.canonical_params(), path)
            if M == 1:
                assert torch.equal(got, t), path
            else:
                assert float((got - t).abs().max()) <= 1e-6 * scale, path
        piped.set_mesh(None)
        assert piped._pipe is None and set(piped.params) == set(plain.params)
    finally:
        bootstrap.shutdown()
        torch.set_num_threads(threads)


def test_weights_io_carries_a_pipelined_jax_net():
    """weights_io.params_from_jax_net takes a JAX net placed on
    {"pipe": 2} (its params restacked into the pipelined layout) back
    to canonical trees: the port's net of them gives the JAX net's
    output (1e-5 of the largest logit), and params_to_numpy of the port's
    pipelined in-process net gives them back whole, bit for bit."""
    from deeplearning4j_tpu.models.transformer import transformer_lm as jlm
    from deeplearning4j_tpu_torch.models.transformer import transformer_lm
    from deeplearning4j_tpu_torch.parallel.pipeline import place_in_process
    from deeplearning4j_tpu_torch.weights_io import (
        params_from_jax_net,
        params_to_numpy,
    )

    jnet = jlm(**CFG).init()
    jnet.set_mesh(jax_make_mesh({"pipe": 2}), axes={"pipe": "pipe"},
                  n_microbatches=2)
    assert "stages" in jnet.params
    net = transformer_lm(**CFG, device="cpu").init()
    net.params = params_from_jax_net(jnet, "cpu")
    x = _batches(4)[0][0]
    want = np.asarray(jnet.output(x))
    got = net.output(x).numpy()
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-5 * np.abs(want).max())
    place_in_process(net, 2)
    back = flatten(params_to_numpy(net))
    for key, v in flatten(jnet._canonical_params()).items():
        np.testing.assert_array_equal(back[key], np.asarray(v))
