"""A JAX zip's `updater.npz` resumes training in the port
(deeplearning4j_tpu_torch/weights_io.py `opt_state_from_jax`,
nn/updater.py `OPTAX_LEAVES`), and `set_optimizer` on both port
containers, against the JAX package on the CPU.

The JAX package trains a net 3 steps and writes its zip; the port
restores it (`updater_restored` True) and both then take 3 more steps on
the same batches. Their params agree within `ADAM_ATOL`, the tolerance
of the port's Adam parity tests (tests/test_torch_tensor_parallel.py),
for every rule the JAX package builds with optax (SGD, Nesterovs, Adam,
AdamW, RMSProp, AdaGrad, AdaDelta), in the per-leaf tree layout and in
the flat view (`FlatViewTransform`, forced at a small size by lowering
the JAX package's `_FLAT_MIN_PARAMS` in the test), in a `flat_layout` 1
zip (row-major vectors) of the MoE LM whose router is a lane-hostile
leaf, and under a per-layer override (optax.multi_transform) on both
containers. A zip whose leaves match no layout raises the named error.
The nets are tanh MLPs (no dead unit whose zero gradient Adam would
amplify from rounding noise) and a narrow MoE LM: each case takes a few
seconds.
"""

import io
import json
import zipfile

import jax
import numpy as np
import optax
import pytest

import deeplearning4j_tpu.nn.updater as jupdater
from deeplearning4j_tpu.datasets.api import DataSet as JDataSet
from deeplearning4j_tpu.models.transformer import (
    transformer_moe_lm as jmoe_lm,
)
from deeplearning4j_tpu.nn import conf as jconf
from deeplearning4j_tpu.nn.graph import ComputationGraph as JGraph
from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as JNet
from deeplearning4j_tpu.util.model_serializer import (
    ModelSerializer as JSerializer,
)
from deeplearning4j_tpu_torch.datasets import DataSet as TDataSet
from deeplearning4j_tpu_torch.nn import conf as tconf
from deeplearning4j_tpu_torch.nn import updater as tupdater
from deeplearning4j_tpu_torch.nn.graph import ComputationGraph as TGraph
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork as TNet
from deeplearning4j_tpu_torch.util.model_serializer import ModelSerializer
from deeplearning4j_tpu_torch.weights_io import (
    UpdaterMappingError,
    params_from_jax,
    params_to_numpy,
)

pytestmark = pytest.mark.port

ADAM_ATOL = 2e-4
RULES = ["sgd", "nesterovs", "adam", "adamw", "rmsprop", "adagrad",
         "adadelta"]
MOE = dict(vocab_size=64, d_model=32, n_heads=2, n_layers=1, n_experts=4,
           d_expert_hidden=64, max_length=8)


def _mln(pkg, updater, override=False):
    first = dict(n_in=6, n_out=10, activation="tanh")
    if override:
        first.update(updater="sgd", learning_rate=0.2)
    return (pkg.NeuralNetConfiguration.builder().seed(3).learning_rate(0.05)
            .updater(updater).list()
            .layer(pkg.DenseLayer(**first))
            .layer(pkg.DenseLayer(n_in=10, n_out=8, activation="tanh"))
            .layer(pkg.OutputLayer(n_in=8, n_out=3, activation="softmax",
                                   loss_function="mcxent"))
            .build())


def _graph(pkg, updater):
    g = (pkg.NeuralNetConfiguration.builder().seed(4).learning_rate(0.05)
         .updater(updater).graph_builder().add_inputs("in"))
    g.add_layer("a", pkg.DenseLayer(n_in=6, n_out=10, activation="tanh",
                                    learning_rate=0.01), "in")
    g.add_layer("b", pkg.DenseLayer(n_in=10, n_out=8, activation="tanh",
                                    updater="nesterovs"), "a")
    g.add_layer("out", pkg.OutputLayer(n_in=8, n_out=3, activation="softmax",
                                       loss_function="mcxent"), "b")
    g.set_outputs("out")
    return g.build()


def _data(seed, kind="mlp"):
    rng = np.random.default_rng(seed)
    if kind == "moe":
        x = rng.integers(0, MOE["vocab_size"], (4, 8)).astype(np.int32)
        return x, np.roll(x, -1, 1)
    x = rng.normal(size=(16, 6)).astype(np.float32)
    return x, np.eye(3, dtype=np.float32)[rng.integers(0, 3, 16)]


def _jax_net(kind, updater="adam"):
    if kind == "moe":
        return jmoe_lm(**MOE).init()
    if kind == "graph":
        return JGraph(_graph(jconf, updater)).init()
    return JNet(_mln(jconf, updater, override=kind == "override")).init()


def _resume_and_compare(jnet, path, kind="mlp"):
    """Restore `path` in the port, take 3 more steps on both, compare."""
    net = ModelSerializer.restore(path, device="cpu")
    assert net.updater_restored is True
    assert net.iteration_count == jnet.iteration_count
    for i in range(3, 6):
        x, y = _data(i, kind)
        jnet.fit(JDataSet(x, y))
        net.fit(TDataSet(x, y))
    want = jax.tree.map(np.asarray, jnet.params)
    got = params_to_numpy(net)
    worst = 0.0
    for path_, leaf in jax.tree_util.tree_leaves_with_path(want):
        other = got
        for k in path_:
            other = other[k.key]
        worst = max(worst, float(np.abs(other - leaf).max()))
    assert worst <= ADAM_ATOL, worst
    return net, worst


def _train_and_zip(jnet, tmp_path, kind="mlp"):
    for i in range(3):
        jnet.fit(JDataSet(*_data(i, kind)))
    path = str(tmp_path / "jax.zip")
    JSerializer.write_model(jnet, path)
    return path


def _fresh_updater_net(path):
    """The zip's net in the port with a FRESH updater state: it must end
    far from the JAX run (else the restored moments proved nothing)."""
    net = ModelSerializer.restore(path, device="cpu")
    net.opt_state = net.tx.init(net.params)
    return net


@pytest.mark.parametrize("updater", RULES)
def test_each_rule_resumes_from_a_jax_zip(updater, tmp_path):
    jnet = _jax_net("mlp", updater)
    path = _train_and_zip(jnet, tmp_path)
    assert not isinstance(jnet.tx, jupdater.FlatViewTransform)
    fresh = _fresh_updater_net(path)
    net, worst = _resume_and_compare(jnet, path)
    if updater not in ("sgd",):  # SGD keeps no moments: counters only
        for i in range(3, 6):
            fresh.fit(TDataSet(*_data(i)))
        far = max(float(np.abs(a - b).max()) for a, b in zip(
            jax.tree.leaves(params_to_numpy(fresh)),
            jax.tree.leaves(params_to_numpy(net))))
        assert far > 10 * max(worst, 1e-7), (far, worst)
    counts = {label: st["count"] for label, st in net.opt_state.items()}
    assert counts == {"__default__": 6}


@pytest.mark.parametrize("updater", RULES)
def test_the_flat_view_resumes(updater, tmp_path, monkeypatch):
    monkeypatch.setattr(jupdater, "_FLAT_MIN_PARAMS", 0)
    jnet = _jax_net("mlp", updater)
    assert isinstance(jnet.tx, jupdater.FlatViewTransform)
    path = _train_and_zip(jnet, tmp_path)
    with zipfile.ZipFile(path) as zf:
        leaves = np.load(io.BytesIO(zf.read("updater.npz")))
        total = sum(l.size for l in jax.tree.leaves(jnet.params))
        # SGD keeps no moment: its state is counters only
        assert any(leaves[k].shape == (total,) for k in leaves.files) \
            == (updater != "sgd")
    _resume_and_compare(jnet, path)


def _chip_smoke():
    """chip_smoke.py as a module (its phases run only under main())."""
    import importlib.util

    from tests.torch_zip_fixture import ROOT

    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.mark.parametrize("updater", ["adam", "rmsprop"])
def test_chip_smokes_flat_writer_is_the_jax_packages(updater, tmp_path,
                                                    monkeypatch):
    """chip_smoke.py phase 27c writes the flagship's `updater.npz` in the
    JAX package's flat-view layout (`jax_flat_updater`): on a JAX zip
    restored in the port it gives back the zip's leaves bit for bit."""
    import torch

    monkeypatch.setattr(jupdater, "_FLAT_MIN_PARAMS", 0)
    path = _train_and_zip(_jax_net("mlp", updater), tmp_path)
    with zipfile.ZipFile(path) as zf:
        npz = np.load(io.BytesIO(zf.read("updater.npz")))
        want = [npz[k] for k in sorted(npz.files, key=lambda k: int(k[4:]))]
    net = ModelSerializer.restore(path, device="cpu")
    assert any(tupdater.lane_hostile(tuple(l.shape))
               for l in jax.tree.leaves(params_to_numpy(net)))
    got = _chip_smoke().jax_flat_updater(torch, net)
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)


def _downgrade_to_layout_1(path, params):
    """Rewrite a flat-view zip as a `flat_layout` 1 zip wrote it: every
    full-length vector row-major (lane-hostile leaves un-rotated)."""
    shapes = [l.shape for l in jax.tree.leaves(params)]
    total = sum(int(np.prod(s)) for s in shapes)
    with zipfile.ZipFile(path) as zf:
        entries = {n: zf.read(n) for n in zf.namelist()}
    npz = np.load(io.BytesIO(entries["updater.npz"]))
    leaves = [npz[k] for k in sorted(npz.files, key=lambda k: int(k[4:]))]
    rotated = 0
    out = []
    for leaf in leaves:
        if leaf.shape == (total,):
            pieces = tupdater.unflatten_flat(leaf, shapes)
            rotated += sum(tupdater.lane_hostile(s) for s in shapes)
            leaf = np.concatenate([p.ravel() for p in pieces])
        out.append(leaf)
    assert rotated, "the zip holds no lane-hostile leaf"
    buf = io.BytesIO()
    np.savez(buf, *out)
    entries["updater.npz"] = buf.getvalue()
    meta = json.loads(entries["meta.json"])
    meta["flat_layout"] = 1
    entries["meta.json"] = json.dumps(meta).encode()
    with zipfile.ZipFile(path, "w", zipfile.ZIP_DEFLATED) as zf:
        for n, data in entries.items():
            zf.writestr(n, data)


def test_a_layout_1_zip_of_the_moe_lm_resumes(tmp_path, monkeypatch):
    monkeypatch.setattr(jupdater, "_FLAT_MIN_PARAMS", 0)
    jnet = _jax_net("moe")
    assert isinstance(jnet.tx, jupdater.FlatViewTransform)
    routers = [l.shape for p, l in jax.tree_util.tree_leaves_with_path(
        jnet.params) if jax.tree_util.keystr(p).endswith("['Wg']")]
    assert routers and all(tupdater.lane_hostile(s) for s in routers)
    path = _train_and_zip(jnet, tmp_path, "moe")
    _downgrade_to_layout_1(path, jnet.params)
    jnet = JSerializer.restore(path)  # the JAX side upgrades it too
    _resume_and_compare(jnet, path, "moe")


@pytest.mark.parametrize("kind", ["override", "graph"])
def test_a_per_layer_override_resumes(kind, tmp_path):
    jnet = _jax_net(kind)
    assert "inner_states" in repr(jax.tree.structure(jnet.opt_state)) or \
        hasattr(jnet.opt_state, "inner_states")
    path = _train_and_zip(jnet, tmp_path)
    net, _ = _resume_and_compare(jnet, path)
    assert len(net.opt_state) >= 2


def test_leaves_that_match_no_layout_raise_the_named_error(tmp_path):
    jnet = _jax_net("mlp")
    path = _train_and_zip(jnet, tmp_path)
    with zipfile.ZipFile(path) as zf:
        entries = {n: zf.read(n) for n in zf.namelist()}
    npz = np.load(io.BytesIO(entries["updater.npz"]))
    buf = io.BytesIO()
    np.savez(buf, *[npz[k] for k in sorted(
        npz.files, key=lambda k: int(k[4:]))][:-2])
    entries["updater.npz"] = buf.getvalue()
    with zipfile.ZipFile(path, "w") as zf:
        for n, data in entries.items():
            zf.writestr(n, data)
    with pytest.raises(UpdaterMappingError, match=r"holds 12 leaves of "
                       r"shapes \[\(\), \(6, 10\)"):
        ModelSerializer.restore(path, device="cpu")


# ------------------------------------------------------------ set_optimizer

def _custom_pair(container):
    """(JAX net with optax.adam(0.005, b1=0.8, b2=0.99, eps=1e-7), port
    net with the matching custom Optimizer), the same params."""
    if container == "graph":
        jnet = JGraph(_graph(jconf, "sgd")).init()
        tnet = TGraph(_graph(tconf, "sgd"), device="cpu").init()
    else:
        jnet = JNet(_mln(jconf, "sgd")).init()
        tnet = TNet(_mln(tconf, "sgd"), device="cpu").init()
    tnet.params = params_from_jax(jax.tree.map(np.asarray, jnet.params),
                                  "cpu")
    jnet.set_optimizer(optax.adam(0.005, b1=0.8, b2=0.99, eps=1e-7))
    rule = (tconf.NeuralNetConfiguration.builder().learning_rate(0.005)
            .updater("adam").adam_mean_decay(0.8).adam_var_decay(0.99)
            .epsilon(1e-7).build())
    tnet.set_optimizer(tupdater.build_optimizer(rule, {}))
    return jnet, tnet


@pytest.mark.parametrize("container", ["mln", "graph"])
def test_set_optimizer_trains_as_the_jax_custom_rule(container):
    jnet, tnet = _custom_pair(container)
    tnet.fit(TDataSet(*_data(0)))       # a cached step is dropped below
    tnet.set_optimizer(tnet.tx)
    tnet.params = params_from_jax(jax.tree.map(np.asarray, jnet.params),
                                  "cpu")
    tnet.opt_state = tnet.tx.init(tnet.params)
    for i in range(4):
        x, y = _data(i)
        jnet.fit(JDataSet(x, y))
        tnet.fit(TDataSet(x, y))
    want = jax.tree.leaves(jax.tree.map(np.asarray, jnet.params))
    got = jax.tree.leaves(params_to_numpy(tnet))
    worst = max(float(np.abs(a - b).max()) for a, b in zip(want, got))
    assert worst <= 1e-5, worst
    # the configuration's own rule (SGD at 0.05) ends elsewhere
    _, plain = _custom_pair(container)
    plain.set_optimizer(tupdater.build_optimizer(plain.conf.conf, {}))
    for i in range(4):
        plain.fit(TDataSet(*_data(i)))
    far = max(float(np.abs(a - b).max()) for a, b in zip(
        jax.tree.leaves(params_to_numpy(plain)), got))
    assert far > 100 * max(worst, 1e-7), (far, worst)


class _HalfSgd:
    """A custom rule that is not an `Optimizer`: updates = -0.5 g."""

    def init(self, params):
        return {}

    def update(self, grads, state, params):
        from deeplearning4j_tpu_torch.nn import tree

        return tree.tree_map(lambda g: -0.5 * g, grads), state


def test_set_optimizer_takes_any_rule_and_the_mesh_guard_names_itself():
    net = TNet(_mln(tconf, "adam"), device="cpu").init()
    before = params_to_numpy(net)
    net.set_optimizer(_HalfSgd())
    assert net.opt_state == {} and net._train_step is None
    net.fit(TDataSet(*_data(0)))
    after = params_to_numpy(net)
    assert any(not np.array_equal(before[k][p], after[k][p])
               for k in before for p in before[k])
    # a placement keeps the optimizer state in its own layout
    net._mesh, net._zero1 = object(), object()
    with pytest.raises(tupdater.OptimizerPlacementError, match="set_mesh"):
        net.set_optimizer(tupdater.build_optimizer(net.conf.conf, {}))


# ---------------------------------------------- the committed JAX fixture

def _zip_arrays(path):
    with zipfile.ZipFile(path) as zf:
        out = {"configuration.json": json.loads(zf.read("configuration.json")),
               "meta.json": json.loads(zf.read("meta.json"))}
        for name in ("params.npz", "state.npz", "updater.npz"):
            npz = np.load(io.BytesIO(zf.read(name)))
            out[name] = [npz[k] for k in sorted(npz.files,
                                                key=lambda k: int(k[4:]))]
    return out


def test_the_committed_fixture_is_what_the_jax_package_makes(tmp_path):
    """tests/torch_zip_fixture.py run again gives the committed arrays
    (within float32 rounding: XLA's CPU code may differ by machine)."""
    from tests import torch_zip_fixture as fx

    made_zip, made_next = fx.make(tmp_path)
    want = _zip_arrays(fx.FIXTURE_DIR / fx.ZIP)
    got = _zip_arrays(made_zip)
    assert got["configuration.json"] == want["configuration.json"]
    assert got["meta.json"] == want["meta.json"]
    for name in ("params.npz", "state.npz", "updater.npz"):
        assert len(got[name]) == len(want[name]), name
        for a, b in zip(got[name], want[name]):
            assert a.shape == b.shape and a.dtype == b.dtype, name
            np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-7)
    want_next = np.load(fx.FIXTURE_DIR / fx.NEXT)
    got_next = np.load(made_next)
    assert sorted(got_next.files) == sorted(want_next.files)
    for k in want_next.files:
        np.testing.assert_allclose(got_next[k], want_next[k], rtol=1e-5,
                                   atol=1e-7, err_msg=k)
    total = sum(p.stat().st_size for p in fx.FIXTURE_DIR.iterdir())
    assert total < 1 << 20, total


def _fixture_run(fx, nxt, mode):
    """The committed JAX zip in the port: restored with its updater
    ("resumed"), with a fresh one (`tx.init`, "fresh") or left unstepped
    ("still"), then 3 more steps (none when "still"); returns
    chip_smoke.py's `fixture_differences` against the JAX continuation
    and the net."""
    net = ModelSerializer.restore(str(fx.FIXTURE_DIR / fx.ZIP),
                                  device="cpu")
    assert net.updater_restored is True and net.iteration_count == 3
    if mode == "fresh":
        net.opt_state = net.tx.init(net.params)
    if mode != "still":
        for seed in range(3, 6):
            net.fit(TDataSet(nxt[f"x{seed}"], nxt[f"y{seed}"]))
    got = params_to_numpy(net)
    return _chip_smoke().fixture_differences(got, nxt), net


def test_the_fixture_resumes_in_the_port():
    """What chip_smoke.py phase 27c runs on the card, here on the CPU:
    the committed JAX zip restored with its updater, 3 more Adam steps,
    the params against the JAX continuation within ADAM_ATOL; the same
    zip resumed with a fresh updater, and left unstepped, both end
    outside it (so the limit tells the restored moments apart)."""
    from tests import torch_zip_fixture as fx

    nxt = np.load(fx.FIXTURE_DIR / fx.NEXT)
    (worst, key), net = _fixture_run(fx, nxt, "resumed")
    assert worst <= ADAM_ATOL, worst
    # the key-bias slices: each net moves them by about lr a step
    assert key <= 2 * 3 * fx.LM["learning_rate"], key
    assert net.iteration_count == 6
    for mode in ("fresh", "still"):
        (control, _), _ = _fixture_run(fx, nxt, mode)
        assert control > 5 * ADAM_ATOL, (mode, control)


# ------------------------------------------- the averaging worker's zips

def test_the_port_worker_resumes_a_jax_workers_zip(tmp_path):
    """A zip the JAX package's ModelSerializer wrote at the checkpoint
    path: the port's run_elastic_worker resumes at its step with its
    Adam moments (one worker: averaging is the identity), and writes its
    own zip there after every round."""
    from deeplearning4j_tpu_torch.parallel.cluster import (
        ClusterCoordinator,
        run_elastic_worker,
    )

    jnet = _jax_net("mlp", "adam")
    ckpt = _train_and_zip(jnet, tmp_path)
    batches = [TDataSet(*_data(i)) for i in range(6)]
    coord = ClusterCoordinator(heartbeat_timeout=10.0).start()
    try:
        net = run_elastic_worker(
            coord.address, "w0", TNet(_mln(tconf, "adam"), device="cpu"),
            batches, sync_every=1, checkpoint_path=ckpt)
    finally:
        coord.shutdown()
    for i in range(3, 6):
        jnet.fit(JDataSet(*_data(i)))
    assert net.iteration_count == 6
    want = jax.tree.leaves(jax.tree.map(np.asarray, jnet.params))
    got = jax.tree.leaves(params_to_numpy(net))
    assert max(float(np.abs(a - b).max()) for a, b in zip(want, got)) \
        <= ADAM_ATOL
    with zipfile.ZipFile(ckpt) as zf:
        assert json.loads(zf.read("meta.json"))["iteration"] == 6
        assert "port_updater.pt" in zf.namelist()
    # a zip of another architecture is refused by name
    other = TNet(_mln(tconf, "adam", override=False), device="cpu")
    other.conf.layers[0].n_out = 11
    other.conf.layers[1].n_in = 11
    coord = ClusterCoordinator(heartbeat_timeout=10.0).start()
    try:
        with pytest.raises(ValueError, match="different architecture"):
            run_elastic_worker(coord.address, "w1", other, batches,
                               checkpoint_path=ckpt)
    finally:
        coord.shutdown()
