"""The port's command-line interface (deeplearning4j_tpu_torch/cli/) on
the CPU (`--device cpu`), driven in-process through `main(argv)`, against
the JAX CLI (deeplearning4j_tpu/cli/).

* train / test / predict round trip; a zip the JAX CLI trained predicts
  in the port as in the JAX CLI, and a zip the port trained predicts in
  the JAX CLI as in the port (f32 rounding apart).
* `--device` defaults to cuda and nothing falls back to the CPU.
* Telemetry: `memory` events at the `DL4J_TPU_MEM_EVERY` cadence and a
  `cost` event from `train`, an `eval` event from `test`.
* SVMLight input, `--prefetch-depth`, missing flags, `gs://` paths
  through a mocked transfer layer.
* `--mesh` at one process, a mesh larger than the process group (a
  named error pointing at `--multiprocess`), the `--multiprocess` plans
  of `train` and `serve`, `--cluster` training with two workers.
* `serve` (predict and generation) behind HTTP, `predict --server`;
  `plan` against the JAX CLI's table; `reshard` over a port checkpoint.
* Two subprocess cases: `python -m deeplearning4j_tpu_torch.cli` as a
  user runs it (`--help`, and a `coordinator` stopped by SIGINT).
"""

import json
import os
import signal
import subprocess
import sys
import threading
from pathlib import Path

import numpy as np
import pytest

from deeplearning4j_tpu.cli import main as jmain
from deeplearning4j_tpu_torch.cli import main
from deeplearning4j_tpu_torch.cli import driver

pytestmark = pytest.mark.port

ROOT = Path(__file__).resolve().parents[1]
CPU = ["--device", "cpu"]
# predictions of the two packages' CLIs for the same zip: f32 rounding
PRED_ATOL = 1e-6


@pytest.fixture
def blob_csv(tmp_path):
    """A linearly separable 3-class CSV: 4 features and a label column."""
    rng = np.random.default_rng(0)
    n = 120
    x = rng.normal(size=(n, 4)).astype(np.float32)
    y = np.argmax(x @ np.array([[1.0, -1.0, 0.2], [-1.0, 0.5, 1.0],
                                [0.5, 0.0, -0.5], [0.0, 1.0, 0.0]]), 1)
    path = tmp_path / "data.csv"
    with open(path, "w") as f:
        for row, label in zip(x, y):
            f.write(",".join(f"{v:.6f}" for v in row) + f",{label}\n")
    feats = tmp_path / "features.csv"
    with open(feats, "w") as f:
        for row in x:
            f.write(",".join(f"{v:.6f}" for v in row) + "\n")
    return str(path), str(feats)


@pytest.fixture
def conf_json(tmp_path):
    """The configuration JSON, as the JAX package writes it (the port
    writes the same)."""
    from deeplearning4j_tpu.nn.conf import NeuralNetConfiguration
    from deeplearning4j_tpu.nn.conf.layers import DenseLayer, OutputLayer

    conf = (NeuralNetConfiguration.builder().seed(3).learning_rate(0.1)
            .updater("adam").list()
            .layer(DenseLayer(n_in=4, n_out=16, activation="relu"))
            .layer(OutputLayer(n_in=16, n_out=3, activation="softmax",
                               loss_function="negativeloglikelihood"))
            .build())
    p = tmp_path / "conf.json"
    p.write_text(conf.to_json())
    return str(p)


def _accuracy(out):
    return float([line for line in out.splitlines()
                  if "Accuracy" in line][0].split()[-1])


def _preds(path):
    return np.loadtxt(path, delimiter=",", ndmin=2)


def _train(mainfn, conf, data, model, *extra):
    return mainfn(["train", "--conf", conf, "--input", data, "--model",
                   model, "--num-classes", "3", "--epochs", "10", *extra])


# ------------------------------------------------------------ round trip

def test_train_test_predict(tmp_path, blob_csv, conf_json, capsys):
    data, feats = blob_csv
    model = str(tmp_path / "model.zip")
    assert _train(main, conf_json, data, model, *CPU) == 0
    assert "model saved to" in capsys.readouterr().out
    assert main(["test", "--model", model, "--input", data,
                 "--num-classes", "3", *CPU]) == 0
    assert _accuracy(capsys.readouterr().out) > 0.85
    preds = str(tmp_path / "preds.csv")
    assert main(["predict", "--model", model, "--input", feats,
                 "--output", preds, *CPU]) == 0
    p = _preds(preds)
    assert p.shape == (120, 3)
    np.testing.assert_allclose(p.sum(axis=1), 1.0, atol=1e-4)


@pytest.mark.parametrize("trainer", ["jax", "port"])
def test_predictions_match_the_jax_cli_on_either_packages_zip(
        tmp_path, blob_csv, conf_json, trainer):
    data, feats = blob_csv
    model = str(tmp_path / "model.zip")
    if trainer == "jax":
        assert _train(jmain, conf_json, data, model) == 0
    else:
        assert _train(main, conf_json, data, model, *CPU) == 0
    ours, theirs = str(tmp_path / "ours.csv"), str(tmp_path / "theirs.csv")
    assert main(["predict", "--model", model, "--input", feats,
                 "--output", ours, *CPU]) == 0
    assert jmain(["predict", "--model", model, "--input", feats,
                  "--output", theirs]) == 0
    np.testing.assert_allclose(_preds(ours), _preds(theirs), rtol=0,
                               atol=PRED_ATOL)


def test_device_defaults_to_cuda_and_nothing_falls_back(tmp_path, blob_csv,
                                                        conf_json):
    parser = driver._build_parser()
    for cmd in (["train", "--conf", "c", "--input", "i"],
                ["test", "--input", "i", "--model", "m"],
                ["predict", "--input", "i", "--output", "o"],
                ["serve", "--model", "m"], ["plan", "--fleet", "2"],
                ["reshard", "--checkpoint", "c", "--target-mesh", "data=1"]):
        assert parser.parse_args(cmd).device == "cuda"
    with pytest.raises(SystemExit):
        parser.parse_args(["train", "--conf", "c", "--input", "i",
                           "--device", "tpu"])
    # this machine has no card: the default device fails, it does not run
    # on the CPU instead
    data, _ = blob_csv
    with pytest.raises((RuntimeError, AssertionError), match="CUDA"):
        _train(main, conf_json, data, str(tmp_path / "m.zip"))
    assert not (tmp_path / "m.zip").exists()


def test_train_and_test_record_telemetry(tmp_path, blob_csv, conf_json,
                                         monkeypatch):
    from deeplearning4j_tpu_torch.telemetry import Recorder, set_default

    monkeypatch.setenv("DL4J_TPU_MEM_EVERY", "2")
    data, _ = blob_csv
    rec = Recorder()
    prev = set_default(rec)
    try:
        model = str(tmp_path / "m.zip")
        assert main(["train", "--conf", conf_json, "--input", data,
                     "--model", model, "--num-classes", "3", "--epochs", "2",
                     "--batch", "40", *CPU]) == 0
        assert main(["test", "--model", model, "--input", data,
                     "--num-classes", "3", *CPU]) == 0
    finally:
        set_default(prev)
    kinds = [e["event"] for e in rec.events]
    mem = [e for e in rec.events if e["event"] == "memory"]
    assert [e["iteration"] for e in mem] == [2, 4, 6]  # 6 steps of 40 rows
    cost = [e for e in rec.events if e["event"] == "cost"]
    # dx of the first layer is not computed (the input needs no gradient)
    fwd = 2 * 40 * 4 * 16 + 2 * 40 * 16 * 3
    assert [(e["entry"], e["flops"]) for e in cost] == [
        ("fit", 3 * fwd - 2 * 40 * 4 * 16)]
    ev = [e for e in rec.events if e["event"] == "eval"]
    assert len(ev) == 1 and ev[0]["stats"]["accuracy"] > 0.5
    assert kinds.count("cost") == 1


def test_train_prefetch_depth_knob(tmp_path, blob_csv, conf_json):
    from deeplearning4j_tpu_torch.data import pipeline

    data, _ = blob_csv
    prev = pipeline.set_prefetch_depth(None)
    try:
        assert _train(main, conf_json, data, str(tmp_path / "m.zip"),
                      "--prefetch-depth", "0", *CPU) == 0
        assert pipeline.prefetch_depth() == 0
    finally:
        pipeline.set_prefetch_depth(prev)


def test_missing_flags_error(blob_csv, conf_json):
    data, feats = blob_csv
    with pytest.raises(SystemExit, match="--model"):
        main(["train", "--conf", conf_json, "--input", data,
              "--num-classes", "3", *CPU])
    with pytest.raises(SystemExit, match="exactly one of --model"):
        main(["predict", "--input", feats, "--output", "o.csv", *CPU])
    with pytest.raises(SystemExit, match="--num-features"):
        main(["train", "--conf", conf_json, "--model", "m.zip", "--input",
              data, "--format", "svmlight", *CPU])


def test_svmlight_input_matches_jax(tmp_path, conf_json):
    rng = np.random.default_rng(1)
    x = rng.normal(size=(60, 4)).astype(np.float32)
    y = (x[:, 0] > 0).astype(int) + (x[:, 1] > 1).astype(int)
    svm = tmp_path / "d.svm"
    with open(svm, "w") as f:
        for row, label in zip(x, y):
            feats = " ".join(f"{j + 1}:{v:.5f}" for j, v in enumerate(row))
            f.write(f"{label} {feats}\n")
    model = str(tmp_path / "m.zip")
    args = ["--format", "svmlight", "--num-features", "4"]
    assert main(["train", "--conf", conf_json, "--input", str(svm),
                 "--model", model, "--num-classes", "3", "--epochs", "3",
                 *args, *CPU]) == 0
    ours, theirs = str(tmp_path / "o.csv"), str(tmp_path / "t.csv")
    assert main(["predict", "--model", model, "--input", str(svm),
                 "--output", ours, *args, *CPU]) == 0
    assert jmain(["predict", "--model", model, "--input", str(svm),
                  "--output", theirs, *args]) == 0
    np.testing.assert_allclose(_preds(ours), _preds(theirs), rtol=0,
                               atol=PRED_ATOL)


def test_gs_input_and_model_roundtrip(tmp_path, blob_csv, conf_json,
                                      monkeypatch):
    """gs:// inputs and outputs go through datasets/cloud: the transfer
    layer is mocked (no network), the CLI's plumbing is real."""
    import shutil

    from deeplearning4j_tpu_torch.datasets import cloud

    data, _ = blob_csv
    bucket = tmp_path / "bucket"
    bucket.mkdir()
    shutil.copy(data, bucket / "train.csv")
    shutil.copy(conf_json, bucket / "conf.json")
    transfers = []

    def fake_download(self, uri, dest=None):
        if not uri.startswith("gs://"):
            return uri
        transfers.append(("down", uri))
        return str(bucket / uri.rsplit("/", 1)[1])

    def fake_upload(self, local, uri):
        transfers.append(("up", uri))
        shutil.copy(local, bucket / uri.rsplit("/", 1)[1])

    monkeypatch.setattr(cloud.GcsDownloader, "download", fake_download)
    monkeypatch.setattr(cloud.GcsUploader, "upload", fake_upload)
    assert main(["train", "--conf", "gs://b/conf.json", "--input",
                 "gs://b/train.csv", "--model", "gs://b/model.zip",
                 "--num-classes", "3", "--epochs", "5", *CPU]) == 0
    assert {("down", "gs://b/train.csv"), ("down", "gs://b/conf.json"),
            ("up", "gs://b/model.zip")} <= set(transfers)
    assert (bucket / "model.zip").exists()
    assert main(["test", "--model", "gs://b/model.zip", "--input",
                 "gs://b/train.csv", "--num-classes", "3", *CPU]) == 0


# ---------------------------------------------------------- distributed

def test_train_with_a_mesh_of_one_process(tmp_path, blob_csv, conf_json,
                                          capsys):
    from deeplearning4j_tpu_torch.distributed import bootstrap

    data, _ = blob_csv
    try:
        assert _train(main, conf_json, data, str(tmp_path / "m.zip"),
                      "--mesh", "data=1", *CPU) == 0
    finally:
        bootstrap.shutdown()
    assert "mesh: {'data': 1} over 1 cpu processes" in \
        capsys.readouterr().out


def test_a_mesh_larger_than_the_process_group_names_multiprocess(
        tmp_path, blob_csv, conf_json):
    data, _ = blob_csv
    with pytest.raises(driver.MeshTooLarge, match="--multiprocess 4"):
        _train(main, conf_json, data, str(tmp_path / "m.zip"), "--mesh",
               "data=2,model=2", *CPU)
    with pytest.raises(SystemExit, match="unknown mesh role"):
        _train(main, conf_json, data, str(tmp_path / "m.zip"), "--mesh",
               "rows=2", *CPU)
    with pytest.raises(SystemExit, match="separate runtimes"):
        _train(main, conf_json, data, str(tmp_path / "m.zip"), "--mesh",
               "data=1", "--cluster", "127.0.0.1:1", *CPU)


def test_multiprocess_plans(blob_csv, conf_json, capsys):
    data, _ = blob_csv
    assert main(["train", "--conf", conf_json, "--input", data, "--model",
                 "m.zip", "--mesh", "data=2", "--multiprocess", "2",
                 "--local-devices", "4", *CPU]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines[0].startswith("# 2-process local rendezvous fleet")
    procs = [line for line in lines[1:] if line.endswith("&")]
    assert len(procs) == 2 and lines[-1] == "wait"
    for i, line in enumerate(procs):
        assert "deeplearning4j_tpu_torch.cli train" in line
        assert "--multiprocess" not in line and "--local-devices" not in line
        assert f"DL4J_TPU_PROCESS_ID={i}" in line
    assert main(["serve", "--model", "m.zip", "--port", "9100",
                 "--multiprocess", "3", *CPU]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert "ports 9100..9102" in lines[0]
    for i, line in enumerate(lines[1:4]):
        assert line.endswith(f"--port {9100 + i} &")
        assert f"DL4J_TPU_PROCESS_ID={i}" in line
    assert lines[-1] == "wait"


def test_train_with_cluster(tmp_path, blob_csv, conf_json, capsys):
    """Two CLI workers and an in-process coordinator: elastic
    parameter-averaging training through the command line."""
    from deeplearning4j_tpu_torch.parallel.cluster import ClusterCoordinator

    data, _ = blob_csv
    coord = ClusterCoordinator(heartbeat_timeout=10.0).start()
    models = [str(tmp_path / f"m{i}.zip") for i in range(2)]
    rcs = {}

    def worker(i):
        rcs[i] = main(["train", "--conf", conf_json, "--input", data,
                       "--model", models[i], "--num-classes", "3",
                       "--epochs", "6", "--batch", "30", "--cluster",
                       coord.address, "--num-workers", "2", "--worker-id",
                       f"w{i}", "--sync-every", "2", *CPU])

    threads = [threading.Thread(target=worker, args=(i,)) for i in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
    coord.shutdown()
    assert rcs == {0: 0, 1: 0}
    capsys.readouterr()
    assert main(["test", "--model", models[0], "--input", data,
                 "--num-classes", "3", *CPU]) == 0
    assert _accuracy(capsys.readouterr().out) > 0.85


# --------------------------------------------------------------- serving

def _post(url, payload):
    import urllib.request

    req = urllib.request.Request(url, data=json.dumps(payload).encode(),
                                 headers={"Content-Type":
                                          "application/json"})
    with urllib.request.urlopen(req, timeout=60) as r:
        return r.read().decode()


def test_serve_predict_behind_http_and_predict_server(tmp_path, blob_csv,
                                                      conf_json):
    from deeplearning4j_tpu_torch.serving import ServingServer

    data, feats = blob_csv
    model = str(tmp_path / "m.zip")
    assert _train(main, conf_json, data, model, *CPU) == 0
    args = driver._build_parser().parse_args(
        ["serve", "--model", model, "--buckets", "1,2,4", "--max-wait-ms",
         "2", "--warmup-features", "0,0,0,0", *CPU])
    engine, supervisor, watcher = driver.build_serving(args)
    assert supervisor is None and watcher is None
    assert engine.trace_count == 3  # every bucket warmed
    server = ServingServer(engine, port=0).start()
    try:
        served = str(tmp_path / "served.csv")
        assert main(["predict", "--server", server.url, "--input", feats,
                     "--output", served, *CPU]) == 0
        stats = json.loads(_get(f"{server.url}/stats"))
    finally:
        server.stop()
    local = str(tmp_path / "local.csv")
    assert main(["predict", "--model", model, "--input", feats, "--output",
                 local, *CPU]) == 0
    np.testing.assert_allclose(_preds(served), _preds(local), rtol=0,
                               atol=PRED_ATOL)
    assert stats["served"] == 120 and stats["trace_count"] == 3
    assert stats["kernel_launches"]["K1"] == 0  # no card: no launch


def _get(url):
    import urllib.request

    with urllib.request.urlopen(url, timeout=60) as r:
        return r.read().decode()


def test_serve_generation_from_a_zip(tmp_path):
    from deeplearning4j_tpu_torch.models.transformer import transformer_lm
    from deeplearning4j_tpu_torch.serving import ServingServer
    from deeplearning4j_tpu_torch.telemetry.metrics import parse_exposition
    from deeplearning4j_tpu_torch.util.model_serializer import (
        ModelSerializer,
    )

    net = transformer_lm(vocab_size=64, d_model=32, n_heads=2, n_layers=2,
                         d_ff=64, max_length=64, device="cpu").init(0)
    model = str(tmp_path / "lm.zip")
    ModelSerializer.write_model(net, model)
    from deeplearning4j_tpu_torch.telemetry import Recorder, set_default

    args = driver._build_parser().parse_args(
        ["serve", "--model", model, "--buckets", "1x8,1x16",
         "--generate-slots", "2", "--max-new-tokens", "6", *CPU])
    prev = set_default(Recorder())  # what DL4J_TPU_TELEMETRY installs
    try:
        engine, _, _ = driver.build_serving(args)
    finally:
        set_default(prev)
    server = ServingServer(engine, port=0).start()
    try:
        body = _post(f"{server.url}/generate",
                     {"tokens": [3, 1, 4, 1, 5], "max_new_tokens": 6})
        metrics = parse_exposition(_get(f"{server.url}/metrics"))
    finally:
        server.stop()
    done = json.loads(body.strip().splitlines()[-1])
    assert done["done"] and len(done["tokens"]) == 6
    # the zip's net greedy-decodes the same tokens in process
    from deeplearning4j_tpu_torch.serving import (BucketLattice,
                                                  GenerationEngine)

    local = GenerationEngine(ModelSerializer.restore(model, device="cpu"),
                             BucketLattice.from_spec("1x8,1x16"), slots=2,
                             max_new_tokens=6)
    local.warmup()
    local.start()
    try:
        assert local.generate([3, 1, 4, 1, 5], 6) == done["tokens"]
    finally:
        local.drain()
    assert metrics['serving_memory_ledger_bytes{subsystem="params"}'] > 0
    assert metrics['serving_memory_ledger_bytes{subsystem="kv_pages"}'] > 0
    assert 0.0 < metrics["serving_mfu_live"] <= 1.0


# ------------------------------------------------------ plan and reshard

def _metric_lines(out):
    return [json.loads(line) for line in out.splitlines()
            if line.startswith("{") and '"metric"' in line]


@pytest.mark.parametrize("model,fleet", [("lm", "1x4"), ("mlp", "2x4")])
def test_plan_matches_the_jax_cli(model, fleet, capsys):
    argv = ["plan", "--model", model, "--fleet", fleet, "--top", "3"]
    assert main(argv) == 0
    ours = capsys.readouterr().out
    assert jmain(argv) == 0
    theirs = capsys.readouterr().out

    def strip(lines):  # the search's wall clock differs run to run
        return [{k: v for k, v in line.items()
                 if k not in ("value", "plan_search_ms")}
                if line["metric"] in ("plan_search_ms", "summary") else line
                for line in lines]

    assert strip(_metric_lines(ours)) == strip(_metric_lines(theirs))


def test_reshard_plans_a_port_checkpoint(tmp_path, capsys):
    from deeplearning4j_tpu_torch.models.transformer import transformer_lm
    from deeplearning4j_tpu_torch.util.checkpoint import Checkpointer

    net = transformer_lm(vocab_size=64, d_model=32, n_heads=2, n_layers=2,
                         d_ff=64, max_length=16, device="cpu").init(0)
    net.iteration_count = 7
    Checkpointer(str(tmp_path / "ck")).save(net)
    assert main(["reshard", "--checkpoint", str(tmp_path / "ck"),
                 "--target-mesh", "data=2,model=2", "--processes", "4",
                 "--artifact", str(tmp_path / "r.jsonl"), *CPU]) == 0
    out = capsys.readouterr().out
    assert "(step 7)" in out
    lines = {m["metric"]: m["value"] for m in _metric_lines(out)}
    assert lines["reshard_plan_leaves"] > 0
    assert lines["reshard_bytes_total"] > 0
    assert 0 < lines["reshard_bytes_lower_bound"] <= \
        lines["reshard_bytes_moved"]
    assert (tmp_path / "r.jsonl").exists()
    with pytest.raises(SystemExit, match="no checkpoint for step 3"):
        main(["reshard", "--checkpoint", str(tmp_path / "ck"),
              "--target-mesh", "data=1", "--step", "3", *CPU])


# ------------------------------------------------------------ subprocess

def _env():
    return dict(os.environ, PYTHONPATH=str(ROOT))


def test_module_entry_point_help():
    p = subprocess.run([sys.executable, "-m", "deeplearning4j_tpu_torch.cli",
                        "--help"], cwd=str(ROOT), env=_env(),
                       capture_output=True, text=True, timeout=120)
    assert p.returncode == 0
    for cmd in ("train", "test", "predict", "serve", "coordinator", "plan",
                "reshard"):
        assert cmd in p.stdout


def test_coordinator_runs_until_interrupted():
    from deeplearning4j_tpu_torch.distributed.bootstrap import free_port

    port = free_port()
    p = subprocess.Popen([sys.executable, "-m", "deeplearning4j_tpu_torch.cli",
                          "coordinator", "--host", "127.0.0.1", "--port",
                          str(port)], cwd=str(ROOT), env=_env(),
                         stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                         text=True)
    try:
        line = p.stdout.readline()
        assert f"coordinator listening on 127.0.0.1:{port}" in line
        from deeplearning4j_tpu_torch.parallel.cluster import ClusterClient

        client = ClusterClient(f"127.0.0.1:{port}", "probe")
        assert "probe" in client.workers()
        client.close()
    finally:
        p.send_signal(signal.SIGINT)
        rc = p.wait(timeout=60)
    assert rc == 0


def test_coordinator_interrupted_right_after_its_announcement():
    """Queue C, C14: an interrupt that lands as soon as the coordinator
    prints its listening line (what a loaded host showed the test above:
    rc -2) must still shut it down cleanly. The interrupt is raised from
    inside print, right after the line is written."""
    from deeplearning4j_tpu_torch.distributed.bootstrap import free_port

    code = ("import builtins, os, runpy, signal, sys\n"
            "_print = builtins.print\n"
            "def announce(*a, **k):\n"
            "    _print(*a, **k)\n"
            "    if a and str(a[0]).startswith('coordinator listening'):\n"
            "        os.kill(os.getpid(), signal.SIGINT)\n"
            "builtins.print = announce\n"
            "sys.argv = ['cli', 'coordinator', '--host', '127.0.0.1', "
            f"'--port', '{free_port()}']\n"
            "runpy.run_module('deeplearning4j_tpu_torch.cli', "
            "run_name='__main__')\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=str(ROOT),
                          env=_env(), capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "coordinator listening on 127.0.0.1:" in proc.stdout
