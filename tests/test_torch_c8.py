"""Five public names of the JAX package that the port lacked or checked
less (ROADMAP Queue C, C8), each held to the JAX package on the CPU:

* `Builder.optimization_algo` validates its value at build time;
* `PagePool.pages_for(n_tokens)`;
* `serving.buckets.DEFAULT_BATCH_SIZES`;
* `ShardedEmbeddingEngine(..., recorder=)`, whose gather and scatter_add
  spans go to that recorder with the JAX span fields;
* `run_generation_replay(..., checkpoint=)`.
"""

import inspect

import numpy as np
import pytest

from deeplearning4j_tpu.nn import conf as jconf
from deeplearning4j_tpu.serving import buckets as jbuckets
from deeplearning4j_tpu.serving import kvcache as jkv
from deeplearning4j_tpu.serving import replay as jreplay
from deeplearning4j_tpu_torch.nn import conf as tconf
from deeplearning4j_tpu_torch.serving import buckets as tbuckets
from deeplearning4j_tpu_torch.serving import kvcache as tkv
from deeplearning4j_tpu_torch.serving import replay as treplay

pytestmark = pytest.mark.port


@pytest.mark.parametrize("algo", ["bogus", "LBFGS", "Adam"])
def test_optimization_algo_rejects_what_jax_rejects(algo):
    for pkg in (jconf, tconf):
        with pytest.raises(ValueError, match="Unknown optimization "
                           "algorithm") as err:
            pkg.NeuralNetConfiguration.builder().optimization_algo(algo)
        assert "stochastic_gradient_descent" in str(err.value)


@pytest.mark.parametrize("algo", ["lbfgs", "conjugate_gradient",
                                  "stochastic_gradient_descent"])
def test_optimization_algo_takes_what_jax_takes(algo):
    j = jconf.NeuralNetConfiguration.builder().optimization_algo(algo).build()
    t = tconf.NeuralNetConfiguration.builder().optimization_algo(algo).build()
    assert str(t.optimization_algo) == str(j.optimization_algo) == algo


@pytest.mark.parametrize("n_tokens", [0, 1, 16, 17, 20, 33])
def test_page_pool_pages_for(n_tokens):
    want = jkv.PagePool(8, 16).pages_for(n_tokens)
    assert tkv.PagePool(8, 16).pages_for(n_tokens) == want
    assert tkv.PagePool(8, 16).pages_for(20) == 2


def test_default_batch_sizes():
    assert tbuckets.DEFAULT_BATCH_SIZES == jbuckets.DEFAULT_BATCH_SIZES \
        == (1, 2, 4, 8)


def test_engine_takes_a_recorder_and_spans_go_to_it():
    from deeplearning4j_tpu_torch.embedding import ShardedEmbeddingEngine
    from deeplearning4j_tpu_torch.telemetry import Recorder

    rec = Recorder()
    eng = ShardedEmbeddingEngine(64, 8, negative=2, seed=1, device="cpu",
                                 recorder=rec)
    eng.embed(np.arange(5))
    rng = np.random.default_rng(0)
    eng.sgns_step(rng.integers(0, 64, 16), rng.integers(0, 64, 16),
                  rng.integers(0, 64, (16, 2)), 0.025)
    spans = {e["name"]: e for e in rec.events if e["event"] == "span"}
    assert set(spans) >= {"gather", "scatter_add"}
    assert {"rows", "ep", "bytes", "seconds"} <= set(spans["gather"])
    assert {"step", "rows", "bytes", "ep", "ep_gather_bytes",
            "seconds"} <= set(spans["scatter_add"])
    assert spans["scatter_add"]["rows"] == 16 * (2 + 2)


def test_run_generation_replay_takes_a_checkpoint(tmp_path):
    assert "checkpoint" in inspect.signature(
        jreplay.run_generation_replay).parameters
    assert "checkpoint" in inspect.signature(
        treplay.run_generation_replay).parameters
    from deeplearning4j_tpu_torch.util.checkpoint import Checkpointer

    net = treplay._tiny_lm(48, device="cpu")
    Checkpointer(str(tmp_path / "ck")).save(net, 7)
    board = treplay.run_generation_replay(
        n_requests=3, telemetry_path=str(tmp_path / "t.jsonl"),
        checkpoint=str(tmp_path / "ck"), device="cpu")
    assert board["n_ok"] == 3
