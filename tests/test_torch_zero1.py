"""ZeRO-1 in the port (nn/training.py `Zero1`, `zero1_opt_shardings`;
set_mesh(..., zero1=True); the reduce-scatter bucket mode of
parallel/overlap.py) against the JAX package and the port's replicated
data parallelism, on gloo fleets of 2 and 4 ranks
(tests/torch_parallel_worker.py; the ranks import no JAX).

The JAX contracts: tests/test_parallel.py
`test_zero1_weight_update_sharding_matches_replicated` (the classifier
trained with Adam under ZeRO-1 equals replicated DP at rtol 1e-5, atol
1e-6, its optimizer state really split), here with LAMB too, whose
trust ratio takes the norm of the whole leaf from the split rows;
tests/test_unified_mesh.py `test_zero1_with_renamed_data_axis` (the LM
with the data role on an axis named "dp", its score within 2e-4 of the
dense net's); tests/test_overlap.py `test_overlap_composes_with_zero1`
(the bucketed step with ZeRO-1 equals the monolithic ZeRO-1 step at atol
1e-5), with the reduce-scatter bucket mode as well. A ZeRO-1 net's
checkpoint holds the whole optimizer state: the replicated net's, to
the same tolerance.
"""

import jax
import numpy as np
import pytest

from deeplearning4j_tpu.datasets.api import DataSet as JDataSet
from deeplearning4j_tpu.datasets.iterators import (
    ListDataSetIterator as JListIt,
)
from deeplearning4j_tpu.parallel.mesh import make_mesh as jax_make_mesh
from fleet_util import jax_net, run_fleet
from torch_parallel_worker import flatten

pytestmark = pytest.mark.port

RTOL, ATOL = 1e-5, 1e-6
OVERLAP_ATOL = 1e-5
LM_ATOL = 2e-4
LM_CFG = dict(vocab_size=64, d_model=16, n_heads=2, n_layers=4, d_ff=32,
              max_length=8)
B, STEPS = 8, 3


def _mlp_batches():
    rng = np.random.default_rng(0)
    out = []
    for _ in range(STEPS):
        x = rng.normal(size=(B, 4)).astype(np.float32)
        y = np.eye(2, dtype=np.float32)[(x.sum(axis=1) > 0).astype(int)]
        out.append((x, y, None))
    return out


def _lm_batches():
    rng = np.random.default_rng(1)
    out = []
    for _ in range(STEPS):
        x = rng.integers(0, 64, (B, 8)).astype(np.int32)
        out.append((x, np.roll(x, -1, axis=1), None))
    return out


def _mlp(name, n, updater, **kw):
    return dict(name=name, kind="mesh", model="mlp", updater=updater,
                lr=0.05, mesh={"data": n}, batches=_mlp_batches(), **kw)


def _lm(name, mesh, **kw):
    return dict(name=name, kind="mesh", model="lm", cfg=LM_CFG, mesh=mesh,
                batches=_lm_batches(), **kw)


CASES = {
    2: [_mlp("mlp_dp_adam", 2, "adam"),
        _mlp("mlp_zero1_adam", 2, "adam", zero1=True),
        _mlp("mlp_dp_lamb", 2, "lamb"),
        _mlp("mlp_zero1_lamb", 2, "lamb", zero1=True),
        _lm("lm_zero1_dp", {"dp": 2}, axes={"data": "dp"}, zero1=True),
        _lm("lm_zero1", {"data": 2}, zero1=True, updater="sgd", lr=0.1),
        _lm("lm_zero1_overlap", {"data": 2}, zero1=True, overlap=128,
            updater="sgd", lr=0.1),
        _lm("lm_zero1_scatter", {"data": 2}, zero1=True, overlap=4096,
            overlap_mode="psum_scatter", updater="sgd", lr=0.1)],
    4: [_mlp("mlp_dp_adam", 4, "adam"),
        _mlp("mlp_zero1_adam", 4, "adam", zero1=True)],
}


@pytest.fixture(scope="module")
def fleets(tmp_path_factory):
    out = {}
    for n, cases in CASES.items():
        d = tmp_path_factory.mktemp(f"zero1_{n}")
        for c in cases:
            c["ckpt"] = str(d / f"ckpt_{c['name']}")
        out[n] = run_fleet(d, n, cases)
    return out


def _keys(out, name, prefix):
    p = f"{name}/{prefix}/"
    return {k[len(p):]: v for k, v in out.items() if k.startswith(p)}


def _assert_close(a, b, rtol=RTOL, atol=ATOL):
    assert a.keys() == b.keys()
    for k in a:
        np.testing.assert_allclose(a[k], b[k], rtol=rtol, atol=atol,
                                   err_msg=k)


@pytest.mark.parametrize("n,updater", [(2, "adam"), (2, "lamb"),
                                       (4, "adam")])
def test_zero1_matches_replicated_data_parallel(fleets, n, updater):
    """The same params and score as replicated DP at rtol 1e-5, atol
    1e-6, on every rank; the optimizer state really split (each rank
    holds 1/n of the rows of every moment whose leading dim n divides);
    the checkpoint's optimizer state the replicated net's."""
    zero1, dp = f"mlp_zero1_{updater}", f"mlp_dp_{updater}"
    for out in fleets[n]:
        _assert_close(_keys(out, zero1, "params"), _keys(out, dp, "params"))
        np.testing.assert_allclose(out[f"{zero1}/score"], out[f"{dp}/score"],
                                   rtol=RTOL)
        _assert_close(_keys(out, zero1, "opt"), _keys(out, dp, "opt"))
        assert bool(out[f"{zero1}/ckpt_is_canonical"])
        local = _keys(out, zero1, "zero1")
        whole = _keys(out, dp, "opt")
        split = [k for k in local if tuple(local[k]) != whole[k].shape]
        assert split, "no optimizer-state leaf is split"
        for k, shape in local.items():
            full = whole[k].shape
            if full and full[0] >= n and full[0] % n == 0:
                assert tuple(shape) == (full[0] // n,) + full[1:], k
            else:
                assert tuple(shape) == full, k


@pytest.mark.parametrize("n", [2, 4])
def test_zero1_matches_jax_zero1(fleets, n):
    """Adam under ZeRO-1 in both packages (the JAX package's
    set_mesh(mesh, zero1=True) on n virtual devices): the same params
    after three steps."""
    case = next(c for c in CASES[n] if c["name"] == "mlp_zero1_adam")
    jnet = jax_net(case)
    jnet.set_mesh(jax_make_mesh({"data": n}), zero1=True)
    jnet.fit(JListIt([JDataSet(x, y) for x, y, _ in case["batches"]]))
    want = flatten(jax.tree.map(np.asarray, jnet.params))
    got = _keys(fleets[n][0], "mlp_zero1_adam", "params")
    _assert_close(got, want)


def test_zero1_on_a_renamed_data_axis_trains_like_dense(fleets):
    """The data role on a mesh axis named "dp": ZeRO-1 follows the
    mapped axis; three steps of the LM's Adam leave the score within
    2e-4 of the JAX net trained densely."""
    case = next(c for c in CASES[2] if c["name"] == "lm_zero1_dp")
    jnet = jax_net(case)
    for x, y, _ in case["batches"]:
        jnet.fit(JDataSet(x, y))
    for out in fleets[2]:
        assert _keys(out, "lm_zero1_dp", "zero1")
        assert abs(float(out["lm_zero1_dp/score"])
                   - float(jnet.score_value)) < LM_ATOL


@pytest.mark.parametrize("name", ["lm_zero1_overlap", "lm_zero1_scatter"])
def test_overlap_composes_with_zero1(fleets, name):
    """The bucketed step (128-byte buckets; and 4 KiB buckets reduced
    by reduce-scatter then all-gather) with ZeRO-1: the params of the
    monolithic ZeRO-1 step at atol 1e-5."""
    for out in fleets[2]:
        _assert_close(_keys(out, name, "params"),
                      _keys(out, "lm_zero1", "params"), rtol=0,
                      atol=OVERLAP_ATOL)


def test_zero1_validation(tmp_path):
    """ZeRO-1 composes with the data role only, and needs its axis on
    the mesh (the JAX package's messages)."""
    from deeplearning4j_tpu_torch.distributed import bootstrap
    from deeplearning4j_tpu_torch.models.transformer import transformer_lm
    from deeplearning4j_tpu_torch.parallel.mesh import make_mesh

    bootstrap.initialize(device="cpu")
    try:
        net = transformer_lm(**LM_CFG, device="cpu").init()
        mesh = make_mesh({"data": 1, "model": 1}, device="cpu")
        with pytest.raises(ValueError, match="zero1"):
            net.set_mesh(mesh, zero1=True,
                         axes={"data": "data", "model": "model"})
        with pytest.raises(ValueError, match="zero1 needs the data axis"):
            net.set_mesh(make_mesh({"model": 1}, device="cpu"), zero1=True)
        assert net._mesh is None and net._zero1 is None
    finally:
        bootstrap.shutdown()
