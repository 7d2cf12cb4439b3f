"""The port's training UI (deeplearning4j_tpu_torch/ui/) on the CPU
against the JAX package's.

* Components: the same chart JSON for the same data, and each package's
  JSON restored by the other's `Component.from_json`.
* Views and the static page: the same HTML, byte for byte, for the same
  payloads (weights, flow, activations, tsne, the fleet timeline over the
  repo's two-shard telemetry fixture, the empty-session placeholders).
* Storage: the session and bounded history semantics.
* The server: every endpoint of a port UiServer answers as a JAX
  UiServer does to the same requests (JSON equal, pages equal), the
  nearest neighbours are the brute-force cosine's, unknown words and
  paths 404, bad JSON 400.
* The listeners over a port net whose params were carried from a JAX
  net with `weights_io`: the histogram and flow payloads equal the JAX
  listeners' exactly; the activation means within 1e-5 relative (one
  forward each, f32); on a ComputationGraph the activation listener
  reports each vertex's activation; posting over HTTP lands in the
  server's storage, and a dead server disables posting after
  MAX_POST_FAILURES without raising.
"""

import json
import urllib.error
import urllib.request
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from deeplearning4j_tpu import ui as jui
from deeplearning4j_tpu.ui import views as jviews
from deeplearning4j_tpu_torch import ui as tui
from deeplearning4j_tpu_torch.ui import views as tviews
from deeplearning4j_tpu_torch.weights_io import params_from_jax

pytestmark = pytest.mark.port

ROOT = Path(__file__).resolve().parents[1]
TELEMETRY_FIXTURE = str(ROOT / "telemetry_bench.jsonl")
ACT_RTOL = 1e-5

WEIGHTS = {"iteration": 3, "score": 0.5, "parameters": {
    "dense_W": {"bins": [0.0, 0.5, 1.0], "counts": [4, 6]},
    "dense_b": {"bins": [-1.0, 0.0, 1.0], "counts": [1, 1]}}}
FLOW = {"iteration": 1, "score": 1.25, "layers": [
    {"name": "dense0", "index": 0, "num_params": 96,
     "param_names": ["W", "b"]}]}
ACTS = [{"iteration": 1, "activation_means": {"layer_0": 0.3}},
        {"iteration": 2, "activation_means": {"layer_0": 0.4,
                                              "layer_1": 0.1}}]
TSNE = {"coords": [[0.0, 1.0], [1.0, 0.0], [0.5, 0.5]],
        "labels": ["a", "b", "c"]}


def _components(mod):
    line = mod.ChartLine(title="score", style=mod.StyleChart(width=300,
                                                              height=200))
    line.add_series("train", [0, 1, 2], [1.0, 0.5, 0.25])
    scatter = mod.ChartScatter(title="pts")
    scatter.add_series("s", [0.0, 1.5], [2.0, -1.0])
    hist = mod.ChartHistogram.of(np.random.default_rng(0).normal(size=500),
                                 bins=10, title="w")
    area = mod.ChartStackedArea(title="a", x=[0, 1], labels=["u", "v"],
                                y=[[1.0, 2.0], [0.5, 0.5]])
    bars = mod.ChartHorizontalBar(title="b", labels=["x"], values=[3.0])
    div = mod.ComponentDiv(components=[
        mod.ComponentText(text="hello </script>"),
        mod.DecoratorAccordion(title="acc", components=[
            mod.ComponentTable(header=["a"], content=[["1"]])])])
    return [line, scatter, hist, area, bars, div]


def test_components_json_equals_jax_and_crosses_over():
    ours, theirs = _components(tui), _components(jui)
    for a, b in zip(ours, theirs):
        assert a.to_json() == b.to_json()
        assert tui.Component.from_json(b.to_json()).to_json() == b.to_json()
        assert jui.Component.from_json(a.to_json()).to_json() == a.to_json()
    with pytest.raises(ValueError):
        tui.ChartScatter().add_series("s", [1, 2], [1.0])


def test_static_page_equals_jax(tmp_path):
    ours, theirs = _components(tui), _components(jui)
    assert tui.StaticPageUtil.render_html(ours, title="r",
                                          refresh_seconds=3) == \
        jui.StaticPageUtil.render_html(theirs, title="r", refresh_seconds=3)
    tui.StaticPageUtil.save_html(ours, str(tmp_path / "a.html"))
    jui.StaticPageUtil.save_html(theirs, str(tmp_path / "b.html"))
    assert (tmp_path / "a.html").read_text() == \
        (tmp_path / "b.html").read_text()


@pytest.mark.parametrize("view", ["weights", "flow", "activations", "tsne",
                                  "empty"])
def test_views_equal_jax(view):
    def page(v):
        if view == "weights":
            return v.weights_page(WEIGHTS, [WEIGHTS, WEIGHTS], "s1")
        if view == "flow":
            return v.flow_page(FLOW, [FLOW], "s1")
        if view == "activations":
            return v.activations_page(ACTS, "s1")
        if view == "tsne":
            return v.tsne_page(TSNE, "s1")
        return "".join((v.weights_page(None, [], "x"),
                        v.flow_page(None, [], "x"),
                        v.activations_page([], "x"), v.tsne_page(None, "x"),
                        v.timeline_page(None, [], "unset")))
    assert page(tviews) == page(jviews)


def test_timeline_view_equals_jax_over_the_fixture():
    from deeplearning4j_tpu.telemetry import trace as jtrace
    from deeplearning4j_tpu_torch.telemetry import trace as ttrace

    tl_t = ttrace.load_timeline(TELEMETRY_FIXTURE)
    tl_j = jtrace.load_timeline(TELEMETRY_FIXTURE)
    assert tl_t.processes == tl_j.processes == ["p0", "p1"]
    page_t = tviews.timeline_page(tl_t, ttrace.detect_anomalies(tl_t), "f")
    page_j = jviews.timeline_page(tl_j, jtrace.detect_anomalies(tl_j), "f")
    assert page_t == page_j and "fleet timeline" in page_t


def test_storage():
    s = tui.SessionStorage()
    s.put("a", "weights", {"x": 1})
    assert s.get("a", "weights") == {"x": 1} and s.get("a", "flow") is None
    assert s.sessions() == ["a"] and s.object_types("a") == ["weights"]
    assert s.last_update("a", "weights") > 0
    h = tui.HistoryStorage(max_history=3)
    for i in range(5):
        h.put("s", "weights", i)
    assert h.history("s", "weights") == [2, 3, 4]
    assert h.get("s", "weights") == 4 and h.history("s", "flow") == []


# ------------------------------------------------------------ the server

def _request(url, payload=None, raw=None):
    """(status, content type, body text) of a GET, or a POST of JSON."""
    data = raw if raw is not None else (
        None if payload is None else json.dumps(payload).encode())
    req = urllib.request.Request(url, data=data, headers={
        "Content-Type": "application/json"} if data is not None else {})
    try:
        with urllib.request.urlopen(req, timeout=10) as r:
            return r.status, r.headers["Content-Type"], r.read().decode()
    except urllib.error.HTTPError as e:
        return e.code, e.headers["Content-Type"], e.read().decode()


@pytest.fixture
def servers():
    pair = (tui.UiServer(port=0, telemetry_path=TELEMETRY_FIXTURE).start(),
            jui.UiServer(port=0, telemetry_path=TELEMETRY_FIXTURE).start())
    yield pair
    for srv in pair:
        srv.stop()


def test_every_endpoint_answers_as_jax(servers):
    rng = np.random.default_rng(0)
    vecs = (np.eye(6) + 0.01 * rng.normal(size=(6, 6))).tolist()
    labels = ["a", "b", "c", "d", "e", "f"]
    calls = [
        ("/weights/update?sid=s1", WEIGHTS), ("/weights/update?sid=s1",
                                              WEIGHTS),
        ("/flow/update?sid=s1", FLOW),
        ("/activations/update?sid=s1", ACTS[0]),
        ("/activations/update?sid=s1", ACTS[1]),
        ("/tsne/coords?sid=s1", TSNE),
        ("/nearestneighbors/query", {"word": "a", "k": 2}),  # no vectors
        ("/nearestneighbors/vectors", {"labels": labels, "vectors": vecs}),
        ("/nearestneighbors/query", {"word": "a", "k": 3}),
        ("/nearestneighbors/query", {"word": "zzz"}),
        ("/nope", {}),
        ("/", None), ("/sessions", None),
        ("/weights/data?sid=s1", None), ("/weights/history?sid=s1", None),
        ("/flow/data?sid=s1", None), ("/activations/history?sid=s1", None),
        ("/tsne/data?sid=s1", None), ("/weights?sid=s1", None),
        ("/flow?sid=s1", None), ("/activations?sid=s1", None),
        ("/tsne?sid=s1", None), ("/weights?sid=nosuch", None),
        ("/timeline", None), ("/timeline/data", None), ("/nope", None),
    ]
    for path, payload in calls:
        ours, theirs = (_request(srv.url + path, payload)
                        for srv in servers)
        assert ours == theirs, path
    status, _, body = _request(servers[0].url + "/nearestneighbors/query",
                               {"word": "a", "k": 3})
    v = np.asarray(vecs, np.float32)
    v /= np.linalg.norm(v, axis=1, keepdims=True) + 1e-12
    sims = v @ v[0]
    sims[0] = -np.inf
    assert json.loads(body)["words"] == [labels[j] for j in
                                         np.argsort(-sims)[:3]]
    bad = [_request(srv.url + "/weights/update", raw=b"{nope")
           for srv in servers]
    assert bad[0] == bad[1] and bad[0][0] == 400


def test_timeline_without_a_source(monkeypatch):
    monkeypatch.delenv("DL4J_TPU_TELEMETRY", raising=False)
    pair = [tui.UiServer(port=0).start(), jui.UiServer(port=0).start()]
    try:
        got = [_request(s.url + "/timeline/data") for s in pair]
        assert got[0] == got[1] and json.loads(got[0][2])["source"] == \
            "unset"
        page = _request(pair[0].url + "/timeline")[2]
        assert "no telemetry yet" in page
    finally:
        for s in pair:
            s.stop()


# --------------------------------------------------------- the listeners

def _mlp_pair():
    from deeplearning4j_tpu.nn.conf import NeuralNetConfiguration as JConf
    from deeplearning4j_tpu.nn.conf.layers import DenseLayer as JDense
    from deeplearning4j_tpu.nn.conf.layers import OutputLayer as JOut
    from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as JNet
    from deeplearning4j_tpu_torch.nn.conf import NeuralNetConfiguration
    from deeplearning4j_tpu_torch.nn.conf.layers import (DenseLayer,
                                                         OutputLayer)
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork

    def build(conf_cls, dense, out):
        return (conf_cls.builder().seed(1).learning_rate(0.1).list()
                .layer(dense(n_in=4, n_out=8, activation="relu"))
                .layer(dense(n_in=8, n_out=8, activation="tanh"))
                .layer(out(n_in=8, n_out=2, activation="softmax",
                           loss_function="negativeloglikelihood"))
                .build())

    jnet = JNet(build(JConf, JDense, JOut)).init()
    tnet = MultiLayerNetwork(build(NeuralNetConfiguration, DenseLayer,
                                   OutputLayer), device="cpu").init()
    tnet.params = params_from_jax(jax.tree.map(np.asarray, jnet.params),
                                  "cpu")
    jnet.score_value = tnet.score_value = 0.75
    return jnet, tnet


def test_listener_payloads_equal_jax():
    jnet, tnet = _mlp_pair()
    probe = np.random.default_rng(3).normal(size=(16, 4)).astype(np.float32)
    for kind, make in (
            ("weights", lambda m, **kw: m.HistogramIterationListener(**kw)),
            ("flow", lambda m, **kw: m.FlowIterationListener(**kw)),
            ("activations", lambda m, **kw:
             m.ActivationMeanIterationListener(probe, **kw))):
        stores = tui.HistoryStorage(), jui.HistoryStorage()
        ours = make(tui, storage=stores[0], frequency=2)
        theirs = make(jui, storage=stores[1], frequency=2)
        for it in range(4):
            ours.iteration_done(tnet, it)
            theirs.iteration_done(jnet, it)
        a, b = (s.history("default", kind) for s in stores)
        assert len(a) == len(b) == 2
        if kind == "activations":
            for x, y in zip(a, b):
                assert x["iteration"] == y["iteration"]
                assert x["activation_means"].keys() == \
                    y["activation_means"].keys()
                for k, v in y["activation_means"].items():
                    assert x["activation_means"][k] == pytest.approx(
                        v, rel=ACT_RTOL)
        else:
            assert a == b


def test_activation_listener_on_a_graph():
    from deeplearning4j_tpu_torch.models.transformer import transformer_lm

    net = transformer_lm(vocab_size=32, d_model=16, n_heads=2, n_layers=1,
                         d_ff=32, max_length=8, device="cpu").init(0)
    store = tui.HistoryStorage()
    lis = tui.ActivationMeanIterationListener(
        np.zeros((2, 8), np.int32), storage=store)
    lis.iteration_done(net, 0)
    means = store.get("default", "activations")["activation_means"]
    floating = [n for n in net.topo if n not in net.conf.network_inputs]
    assert len(means) == len(floating)
    assert all(np.isfinite(v) and v >= 0 for v in means.values())


def test_listeners_post_over_http_and_survive_a_dead_server():
    jnet, tnet = _mlp_pair()
    srv = tui.UiServer(port=0).start()
    try:
        lis = tui.FlowIterationListener(url=srv.url, session_id="t")
        lis.iteration_done(tnet, 0)
        got = json.loads(_request(f"{srv.url}/flow/data?sid=t")[2])
        assert [layer["num_params"] for layer in got["layers"]] == \
            [40, 72, 18]
        url = srv.url
    finally:
        srv.stop()
    dead = tui.HistogramIterationListener(url=url)
    for it in range(dead.MAX_POST_FAILURES + 2):
        dead.iteration_done(tnet, it)
    assert dead._post_failures == dead.MAX_POST_FAILURES
    with pytest.raises(ValueError, match="url="):
        tui.FlowIterationListener()


def test_histogram_listener_reads_the_params_once(monkeypatch):
    """One host copy a snapshot: every leaf through one flat tensor."""
    _, tnet = _mlp_pair()
    copies = []
    real = torch.Tensor.cpu

    def counting(self, *a, **kw):
        copies.append(tuple(self.shape))
        return real(self, *a, **kw)

    monkeypatch.setattr(torch.Tensor, "cpu", counting)
    snap = tui.HistogramIterationListener(
        storage=tui.SessionStorage()).snapshot(tnet, 0)
    assert copies == [(4 * 8 + 8 + 8 * 8 + 8 + 8 * 2 + 2,)]
    assert len(snap["parameters"]) == 6
