"""The port's ANN index (deeplearning4j_tpu_torch/embedding/ann.py)
against the JAX package's (deeplearning4j_tpu/embedding/ann.py) on the
CPU.

Both compute the same contractions; the last bits of an f32 dot product
differ between XLA's einsum and torch's matmul, and a near-tie can flip
an argmax (k-means), an argsort (the build's spill order) or a top-k
(search). So search parity is held on an index carried across
(`weights_io.ann_index_from_jax`) and the build on clustered data with a
wide margin between a row's best and second partition, where no such tie
exists. Tolerances: ids and partitions exact; scores and centroids 1e-6
(cosines are at most 1).
"""

import numpy as np
import pytest
import torch

from deeplearning4j_tpu.embedding import ann as jann
from deeplearning4j_tpu_torch.embedding import ann as tann
from deeplearning4j_tpu_torch.weights_io import ann_index_from_jax

pytestmark = pytest.mark.port


def _clustered(rng, v=512, d=16, nc=16, noise=0.1):
    centers = rng.normal(size=(nc, d)).astype(np.float32)
    return (centers[rng.integers(0, nc, v)]
            + noise * rng.normal(size=(v, d))).astype(np.float32)


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(7)
    vecs = _clustered(rng)
    queries = vecs[rng.choice(512, size=32, replace=False)]
    jidx = jann.DeviceANNIndex.build(vecs, n_partitions=16, seed=0)
    return vecs, queries, jidx


def test_kmeans_iter_matches_jax(data):
    vecs, _, _ = data
    v = vecs / np.linalg.norm(vecs, axis=1, keepdims=True)
    cent = v[np.random.default_rng(1).choice(512, 16, replace=False)]
    jc, ja = jann._kmeans_iter(cent, v)
    tc, ta = tann._kmeans_iter(torch.from_numpy(cent), torch.from_numpy(v))
    np.testing.assert_array_equal(ta.numpy(), np.asarray(ja))
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), rtol=0, atol=1e-6)


def test_brute_force_topk_matches_jax(data):
    vecs, queries, _ = data
    jids, js = jann.brute_force_topk(vecs, queries, 10)
    tids, ts = tann.brute_force_topk(vecs, queries, 10, device="cpu")
    assert tids.dtype == torch.int32
    np.testing.assert_array_equal(tids.numpy(), np.asarray(jids))
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=0, atol=1e-6)


def test_build_matches_jax_on_clustered_data(data):
    """Well-separated clusters: the same initial centroids (numpy seed
    0), the same Lloyd iterations and the same host spill give the same
    partitions."""
    vecs, _, jidx = data
    tidx = tann.DeviceANNIndex.build(vecs, n_partitions=16, seed=0,
                                     device="cpu")
    assert (tidx.n_partitions, tidx.capacity, tidx.dim) == (
        jidx.n_partitions, jidx.capacity, jidx.dim)
    np.testing.assert_array_equal(tidx.part_ids.numpy(),
                                  np.asarray(jidx.part_ids))
    for got, want in ((tidx.centroids, jidx.centroids),
                      (tidx.part_vecs, jidx.part_vecs)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                                   atol=1e-6)


@pytest.mark.parametrize("nprobe", [1, 4, 16])
def test_search_on_carried_index_matches_jax(data, nprobe):
    """Random (not corpus) queries through both packages' search on the
    same partitions: ids exact, scores within 1e-6."""
    vecs, _, jidx = data
    q = np.random.default_rng(3).normal(size=(8, 16)).astype(np.float32)
    jids, js = jidx.search(q, 5, nprobe=nprobe)
    tidx = ann_index_from_jax(jidx, "cpu")
    tids, ts = tidx.search(q, 5, nprobe=nprobe)
    np.testing.assert_array_equal(tids.numpy(), np.asarray(jids))
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=0, atol=1e-6)


def test_calibrate_nprobe_matches_jax(data):
    vecs, queries, jidx = data
    want = jidx.calibrate_nprobe(vecs, queries, k=10, floor=0.95)
    got = ann_index_from_jax(jidx, "cpu").calibrate_nprobe(
        vecs, queries, k=10, floor=0.95)
    assert got == want and got[1] >= 0.95


def test_full_probe_is_exact_and_search_is_trace_stable(data):
    """The JAX index's contracts on the port's own build: probing every
    partition recovers the brute-force sets, a repeated shape is one
    trace, results are [Q, k] and nearest-first."""
    vecs, queries, _ = data
    idx = tann.DeviceANNIndex.build(vecs, n_partitions=16, seed=0,
                                    device="cpu")
    ids, _ = idx.search(queries, 10, nprobe=idx.n_partitions)
    exact, _ = tann.brute_force_topk(vecs, queries, 10, device="cpu")
    assert tann.recall_at_k(ids.numpy(), exact.numpy()) == 1.0
    rng = np.random.default_rng(8)
    idx.search(rng.normal(size=(4, 16)), 5, nprobe=4)
    tc = idx.trace_count
    for _ in range(3):
        ids, scores = idx.search(rng.normal(size=(4, 16)), 5, nprobe=4)
    assert idx.trace_count == tc
    assert ids.shape == (4, 5) and scores.shape == (4, 5)
    assert (np.diff(scores.numpy(), axis=1) <= 1e-6).all()
    idx.search(rng.normal(size=(2, 16)), 5, nprobe=4)
    assert idx.trace_count == tc + 1


def test_recall_at_k():
    a = np.array([[1, 2, 3], [4, 5, 6]])
    b = np.array([[3, 2, 9], [7, 8, 9]])
    assert tann.recall_at_k(a, b) == jann.recall_at_k(a, b) == 2 / 6
